"""The OpenCV-free synthetic renderer: nearest resize, filled discs, the
bilinear perspective warp, and the pose/stream split."""

import numpy as np
import pytest

from orbslam2_with_quadrics_tpu.utils import synthetic


def test_resize_nearest_repeats_blocks():
    layer = np.arange(16, dtype=np.float32).reshape(4, 4)
    out = synthetic._resize_nearest(layer, 10)
    idx = (np.arange(10) * 4) // 10
    np.testing.assert_array_equal(out, layer[idx][:, idx])
    assert out.shape == (10, 10)


def test_fill_disc_paints_exact_disc_and_clips():
    img = np.zeros((20, 20), np.float32)
    synthetic._fill_disc(img, 1, 18, 3, 5.0)
    yy, xx = np.mgrid[0:20, 0:20]
    want = ((yy - 18) ** 2 + (xx - 1) ** 2 <= 9).astype(np.float32) * 5.0
    np.testing.assert_array_equal(img, want)


def _warp_reference(src, H, h, w, wrap, border):
    """Per-pixel bilinear sampling of src at H^-1 (x, y, 1)."""
    Hi = np.linalg.inv(H)
    out = np.zeros((h, w), np.float64)
    sh, sw = src.shape
    for y in range(h):
        for x in range(w):
            p = Hi @ np.array([x, y, 1.0])
            sx, sy = p[0] / p[2], p[1] / p[2]
            x0, y0 = int(np.floor(sx)), int(np.floor(sy))
            fx, fy = sx - x0, sy - y0
            acc = 0.0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = y0 + dy, x0 + dx
                    if wrap:
                        v = src[yy % sh, xx % sw]
                    elif 0 <= yy < sh and 0 <= xx < sw:
                        v = src[yy, xx]
                    else:
                        v = border
                    acc += wy * wx * v
            out[y, x] = acc
    return out


@pytest.mark.parametrize("wrap", [True, False])
def test_warp_perspective_matches_per_pixel_bilinear(wrap):
    rng = np.random.RandomState(0)
    src = (rng.rand(23, 31) * 255).astype(np.float32)
    H = np.array([[1.3, 0.1, -4.0], [-0.05, 1.1, 3.0], [1e-3, 2e-3, 1.0]])
    got = synthetic._warp_perspective(src, H, 17, 29, wrap=wrap, border=-1.0)
    want = _warp_reference(src, H, 17, 29, wrap, -1.0)
    np.testing.assert_allclose(got, want, atol=1e-3)
    if not wrap:
        assert (got < 0).any()  # part of the output falls off the source


def test_stream_is_planar_pose_plus_render_plane():
    kw = dict(n_frames=5, h=60, w=80, fx=70.0, fy=70.0, seed=1,
              motion="orbit_big", plane_half=4.0, tex_size=256)
    K3 = np.array([[70.0, 0, 40.0], [0, 70.0, 30.0], [0, 0, 1.0]])
    tex = synthetic._texture(256, 1)
    for t, (img, T) in enumerate(synthetic.planar_stream(**kw)):
        np.testing.assert_allclose(
            T, synthetic.planar_pose(t, 5, "orbit_big", 4.0)
        )
        np.testing.assert_array_equal(
            img, synthetic.render_plane(tex, T, K3, 60, 80, plane_half=4.0)
        )
