import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_with_quadrics_tpu.ops import orb


def checkerboard(h=128, w=160, sq=16):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (((yy // sq) + (xx // sq)) % 2) * 200.0 + 20.0
    return jnp.asarray(img, jnp.float32)


def test_fast_score_fires_on_corners_not_edges():
    img = checkerboard()
    score = orb.fast_score(img)
    # interior checkerboard corner (strong) vs mid-edge (weak) vs flat
    corner = float(score[48, 48])
    # crossing corners of a checkerboard are saddle points for FAST-9;
    # use a lone bright square instead for an unambiguous corner
    img2 = jnp.zeros((64, 64), jnp.float32).at[20:40, 20:40].set(255.0)
    s2 = orb.fast_score(img2)
    assert float(s2[20, 20]) > 50.0          # corner of the square
    assert float(s2[30, 20]) <= 7.0          # mid-edge: no 9-arc
    assert float(s2[10, 10]) <= 1.0          # flat region
    assert np.isfinite(corner)


def blob_texture(h, w, seed=0, n=120):
    """Random bright blobs — FAST-9-friendly corners (checkerboard
    X-corners are saddle points FAST cannot fire on)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w), np.float32)
    for _ in range(n):
        y, x = rng.randint(4, h - 4), rng.randint(4, w - 4)
        r = rng.randint(2, 5)
        img[max(0, y - r) : y + r, max(0, x - r) : x + r] = rng.uniform(80, 255)
    return jnp.asarray(img)


def test_detect_level_counts_and_bounds():
    img = blob_texture(160, 192)
    yx, sc, valid = orb.detect_level(img, 64)
    assert yx.shape == (64, 2)
    nvalid = int(jnp.sum(valid))
    assert nvalid > 16
    y, x = np.asarray(yx[:, 0]), np.asarray(yx[:, 1])
    v = np.asarray(valid)
    assert (y[v] >= orb.EDGE_THRESHOLD).all() and (
        y[v] < 160 - orb.EDGE_THRESHOLD
    ).all()
    assert (x[v] >= orb.EDGE_THRESHOLD).all()


def test_ic_angle_points_toward_mass():
    # bright blob to the right of the keypoint -> centroid along +x -> angle ~ 0
    img = jnp.zeros((64, 64), jnp.float32).at[28:37, 36:45].set(255.0)
    yx = jnp.asarray([[32, 32]], jnp.int32)
    ang = orb.ic_angle(img, yx, jnp.asarray([True]))
    assert abs(float(ang[0])) < 0.3
    # blob below -> +y -> angle ~ +pi/2
    img2 = jnp.zeros((64, 64), jnp.float32).at[36:45, 28:37].set(255.0)
    ang2 = orb.ic_angle(img2, yx, jnp.asarray([True]))
    assert abs(float(ang2[0]) - np.pi / 2) < 0.3


def test_brief_rotation_tolerance():
    """Descriptor of a rotated patch (with compensated angle) stays close."""
    rng = np.random.RandomState(0)
    base = rng.rand(96, 96).astype(np.float32) * 255.0
    img = jnp.asarray(base)
    blur = orb.gaussian_blur7(img)
    yx = jnp.asarray([[48, 48]], jnp.int32)
    v = jnp.asarray([True])

    d0 = orb.brief_descriptors(blur, yx, jnp.asarray([0.0]), v)

    # rotate image by 30 deg about the keypoint, tell BRIEF the angle
    import scipy.ndimage as ndi

    rot = ndi.rotate(np.asarray(blur), -30.0, reshape=False, order=1, mode="nearest")
    d1 = orb.brief_descriptors(
        jnp.asarray(rot), yx, jnp.asarray([np.deg2rad(30.0)]), v
    )
    dist = int(
        jnp.sum(jax.lax.population_count(jnp.bitwise_xor(d0, d1)))
    )
    # same content should be far below the random-descriptor mean of 128
    assert dist < 70

    # sanity: a different location is near-random
    d2 = orb.brief_descriptors(blur, jnp.asarray([[20, 70]], jnp.int32), jnp.asarray([0.0]), v)
    dist2 = int(jnp.sum(jax.lax.population_count(jnp.bitwise_xor(d0, d2))))
    assert dist2 > 80


def test_extract_end_to_end_shapes():
    img = checkerboard(240, 320, 20)
    feats = jax.jit(lambda im: orb.extract(im, n_features=256, n_levels=4))(img)
    assert feats.uv.shape == (256, 2)
    assert feats.desc.shape == (256, 8) and feats.desc.dtype == jnp.uint32
    assert int(jnp.sum(feats.valid)) > 32
    # level-0 coords within image bounds
    v = np.asarray(feats.valid)
    uv = np.asarray(feats.uv)
    assert (uv[v, 0] < 320).all() and (uv[v, 1] < 240).all()


def test_per_level_counts_sum():
    counts = orb.per_level_counts(1000, 8, 1.2)
    assert sum(counts) == 1000
    assert counts[0] > counts[-1] > 0


def test_extract_descriptors_match_reference_path():
    """The production extract() (patch slice + in-patch tap gather) must be
    bit-identical to the per-level reference path (ic_angle +
    brief_descriptors on the full blurred level)."""
    rng = np.random.RandomState(0)
    H, W = 240, 320
    yy, xx = np.mgrid[0:H, 0:W]
    img = jnp.asarray(
        ((np.sin(yy * 0.3) * np.cos(xx * 0.23) + rng.rand(H, W)) * 127).astype(
            np.float32
        )
    )
    f = orb.extract(img, n_features=256, n_levels=4)
    v = np.asarray(f.valid)
    shapes = orb.pyramid_shapes(H, W, 4, 1.2)
    pyr = orb.build_pyramid(img, shapes)
    checked = 0
    for l in range(2):  # levels 0-1 cover most keypoints
        sel = v & (np.asarray(f.level) == l)
        if sel.sum() == 0:
            continue
        s = 1.2 ** l
        uv = np.asarray(f.uv)[sel] / s
        yx = jnp.asarray(
            np.stack([uv[:, 1], uv[:, 0]], -1).round().astype(np.int32)
        )
        ok = jnp.ones((yx.shape[0],), bool)
        ang_ref = orb.ic_angle(pyr[l], yx, ok)
        d_ref = orb.brief_descriptors(orb.gaussian_blur7(pyr[l]), yx, ang_ref, ok)
        np.testing.assert_allclose(
            np.asarray(f.angle)[sel], np.asarray(ang_ref), atol=1e-4
        )
        np.testing.assert_array_equal(np.asarray(f.desc)[sel], np.asarray(d_ref))
        checked += int(sel.sum())
    assert checked > 100
