"""Synthetic photorealistic-enough sequences for integration tests.

The reference repo ships no test data (SURVEY.md §4); these generators
render textured planes under known camera motion so the full pipeline
(extract -> init -> track -> BA) can be validated against exact ground
truth, including loop trajectories for loop-closing tests.
"""

from __future__ import annotations

import numpy as np


def _resize_nearest(layer: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour upscale of a square layer to [size, size]
    (source index floor(i * n / size), as cv2.INTER_NEAREST)."""
    idx = (np.arange(size) * layer.shape[0]) // size
    return layer[idx][:, idx]


def _fill_disc(img: np.ndarray, x: int, y: int, r: int, value: float):
    """Paint the filled disc |p - (x, y)| <= r into ``img`` in place."""
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    ys, xs = dy + y, dx + x
    inside = (
        (dy * dy + dx * dx <= r * r)
        & (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    )
    img[ys[inside], xs[inside]] = value


def _warp_perspective(src, H, h, w, wrap=True, border=0.0):
    """Bilinear perspective warp: out[y, x] = src(H^-1 (x, y, 1)), with H
    mapping source pixels to output pixels. Outside the source, ``wrap``
    tiles it periodically; otherwise taps read ``border``."""
    Hi = np.linalg.inv(H)
    xs = np.arange(w, dtype=np.float64)
    ys = np.arange(h, dtype=np.float64)[:, None]
    den = Hi[2, 0] * xs + Hi[2, 1] * ys + Hi[2, 2]
    x = (Hi[0, 0] * xs + Hi[0, 1] * ys + Hi[0, 2]) / den
    y = (Hi[1, 0] * xs + Hi[1, 1] * ys + Hi[1, 2]) / den
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0).astype(np.float32)
    fy = (y - y0).astype(np.float32)
    x0 = x0.astype(np.int64)
    y0 = y0.astype(np.int64)
    sh, sw = src.shape
    flat = src.reshape(-1)

    def tap(yy, xx):
        if wrap:
            return flat[(yy % sh) * sw + (xx % sw)]
        ok = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
        v = flat[np.clip(yy, 0, sh - 1) * sw + np.clip(xx, 0, sw - 1)]
        return np.where(ok, v, np.float32(border))

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def _texture(size: int, seed: int) -> np.ndarray:
    """Multi-scale random texture with strong corners for FAST.

    Detail scales with ``size``: big planes rendered at full camera
    resolution need the same corner density per world unit as small
    ones, so noise layers extend to size//32 and blob count grows with
    area (identical output to the original recipe at size=2048)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((size, size), np.float32)
    # blocky multi-scale noise, finest layer ~32 px blocks
    sc = 8
    while sc <= max(64, size // 32):
        layer = rng.rand(sc, sc).astype(np.float32)
        img += _resize_nearest(layer, size)
        sc *= 2
    img = (img - img.min()) / (img.max() - img.min())
    # sprinkle high-contrast blobs at constant density per area
    for _ in range(max(size, size * size // 2048)):
        x, y = rng.randint(8, size - 8, 2)
        r = rng.randint(2, 6)
        _fill_disc(img, x, y, r, float(rng.rand()))
    return (img * 255.0).astype(np.float32)


def planar_sequence(
    n_frames: int = 60,
    h: int = 480,
    w: int = 640,
    fx: float = 500.0,
    fy: float = 500.0,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    tex_size: int = 2048,
    relief: bool = False,
):
    """Camera viewing a textured plane z=0 from distance ~2.5.

    ``relief=True`` adds a raised textured platform (z=0.8, central
    [-1.2,1.2]^2): perfectly planar scenes leave the homography
    decomposition two-fold ambiguous, so monocular init (correctly)
    refuses them at small baselines — real scenes have depth structure.

    Returns (imgs [T,H,W] float32, poses_true list of 4x4 T_cw, K [4]).
    """
    gen = planar_stream(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fy, seed=seed, motion=motion,
        plane_half=plane_half, tex_size=tex_size, relief=relief,
    )
    imgs, poses = [], []
    for img, T in gen:
        imgs.append(img)
        poses.append(T)
    return np.stack(imgs), poses, np.array([fx, fy, w / 2.0, h / 2.0])


def planar_stream(
    n_frames: int = 60,
    h: int = 480,
    w: int = 640,
    fx: float = 500.0,
    fy: float = 500.0,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    tex_size: int = 2048,
    relief: bool = False,
    noise: float = 0.0,
):
    """Streaming version of :func:`planar_sequence`: yields one
    (img [H,W] float32, T_cw 4x4) at a time so multi-thousand-frame
    sequences never materialize in memory (4,096 frames at 640x480 would
    be ~5 GB)."""
    noise_rng = np.random.RandomState(seed + 4242) if noise > 0 else None
    K = np.array([[fx, 0, w / 2.0], [0, fy, h / 2.0], [0, 0, 1.0]])
    tex = _texture(tex_size, seed)
    relief_tex = _texture(512, seed + 77) if relief else None
    for t in range(n_frames):
        T = planar_pose(t, n_frames, motion, plane_half)
        # sensor noise: the noise-free render tracks with so little drift
        # that revisits re-attach by projection alone and loop closure
        # never has anything to do; real cameras drift
        img = render_plane(
            tex, T, K, h, w, plane_half=plane_half, relief_tex=relief_tex,
            noise=noise, noise_rng=noise_rng,
        )
        yield img, T


def planar_pose(t: int, n_frames: int, motion: str, plane_half: float):
    """Ground-truth T_cw (4x4) of frame ``t`` of an ``n_frames`` sequence
    of the named camera motion over the textured plane."""
    u = t / max(n_frames - 1, 1)
    if motion == "strafe":
        # sideways translation + slight yaw and depth change
        tx = 1.2 * u
        ty = 0.15 * np.sin(2 * np.pi * u)
        tz = 2.5 + 0.3 * np.sin(np.pi * u)
        yaw = 0.15 * u
        pitch = 0.05 * np.sin(2 * np.pi * u)
    elif motion == "orbit_loop":
        # closed loop: circle above the plane, returns to start
        ang = 2 * np.pi * u
        tx = 0.8 * np.sin(ang)
        ty = 0.8 * (1 - np.cos(ang))
        tz = 2.5
        yaw = 0.10 * np.sin(ang)
        pitch = 0.0
    elif motion == "orbit_big":
        # LARGE circle (radius plane_half/2, C-infinity) that leaves
        # the start's view entirely and closes at the end, with a 12%
        # dwell at home so the loop detector sees several consistent
        # keyframes of the revisited place. The topological loop for
        # organic loop-closure tests: mid-orbit views share nothing
        # with home, so with a bounded local-map window the return is
        # reconnectable only by place recognition.
        R = 0.5 * plane_half
        ang = 2 * np.pi * min(u / 0.88, 1.0)
        dwell = max(u - 0.88, 0.0) / 0.12
        tx = R * np.sin(ang) + 0.06 * dwell
        ty = R * (1 - np.cos(ang))
        tz = 2.5
        yaw = 0.0
        pitch = 0.0
    elif motion == "out_and_back":
        # long excursion that leaves the start area entirely, then
        # returns: early map points leave view mid-sequence, so the
        # return is only reconnectable by loop closure
        # reach >> view half-width disconnects the map without hitting
        # the texture's wrap period (2*plane_half); use plane_half >= 8.
        # C1-smooth profile (constant-velocity prediction must track):
        # sin^2 ramps out and back by u=0.85, then dwells at home so
        # the loop detector has keyframes of overlap with the start.
        reach = plane_half
        v = min(u / 0.85, 1.0)
        tx = reach * np.sin(np.pi * v) ** 2
        tx += 0.05 * max(u - 0.85, 0.0) / 0.15
        ty = 0.1 * np.sin(4 * np.pi * u)
        tz = 2.5
        yaw = 0.0
        pitch = 0.0
    elif motion == "figure8":
        # two circular lobes through DISTINCT territory (upper then
        # lower), each returning to home: two genuine topological
        # loops. Cycloidal easing (a = 2*pi*v - sin(2*pi*v)) gives
        # zero velocity at every junction, so the constant-velocity
        # motion model survives the lobe/dwell transitions.
        R8 = plane_half / 3.0

        def _circ(v):
            return 2 * np.pi * v - np.sin(2 * np.pi * v)

        if u < 0.42:
            a = _circ(u / 0.42)
            tx = R8 * np.sin(a)
            ty = R8 * (1 - np.cos(a))
        elif u < 0.5:
            tx = 0.04 * (u - 0.42) / 0.08
            ty = 0.0
        elif u < 0.92:
            a = _circ((u - 0.5) / 0.42)
            tx = 0.04 + R8 * np.sin(a)
            ty = -R8 * (1 - np.cos(a))
        else:
            tx = 0.04 + 0.04 * (u - 0.92) / 0.08
            ty = 0.0
        tz = 2.5
        yaw = 0.0
        pitch = 0.0
    elif motion == "double_loop":
        # figure-eight: two excursions in OPPOSITE directions with a
        # return to home between them — two independent loop closures
        # (the persistent-loop-edge scenario: the second essential
        # graph must keep the first loop's correction). sin^2 ramps
        # are C1 at the junction (u=0.5), so constant-velocity
        # prediction tracks through it.
        reach = plane_half
        if u < 0.5:
            v = u / 0.5
            tx = reach * np.sin(np.pi * v) ** 2
            ty = 0.08 * np.sin(4 * np.pi * v)
        else:
            v = (u - 0.5) / 0.5
            tx = -reach * np.sin(np.pi * v) ** 2
            ty = 0.08 * np.sin(4 * np.pi * v)
        tz = 2.5
        yaw = 0.0
        pitch = 0.0
    elif motion == "survey":
        # long smooth lawn-mower sweep over a big plane: the scale
        # stress pattern (thousands of frames, hundreds of keyframes,
        # trajectory length >> view width). C-infinity everywhere so
        # constant-velocity prediction tracks.
        span = 0.75 * plane_half
        tx = span * np.sin(2 * np.pi * 3 * u)
        ty = (2 * u - 1) * 0.8 * span
        tz = 2.5 + 0.2 * np.sin(2 * np.pi * 5 * u)
        yaw = 0.1 * np.sin(2 * np.pi * u)
        pitch = 0.03 * np.sin(2 * np.pi * 2 * u)
    else:
        raise ValueError(motion)

    Rx = _rot_x(np.pi + pitch)  # look down at the plane (z=0 below)
    Rz = _rot_z(yaw)
    R_wc = Rz @ Rx          # camera->world rotation
    C = np.array([tx, ty, tz])
    R_cw = R_wc.T
    T = np.eye(4)
    T[:3, :3] = R_cw
    T[:3, 3] = -R_cw @ C
    return T


def render_plane(tex, T_cw, K3, h, w, plane_half=3.0,
                 relief_tex=None, relief_half=1.2, relief_z=0.8,
                 noise=0.0, noise_rng=None):
    """Render the textured z=0 plane from pose T_cw (4x4).

    ``relief_tex``/``noise`` must match the main stream's settings when
    rendering the right eye of a stereo pair — a right image without the
    relief platform gives left-relief pixels a WRONG disparity match
    against the background plane and silently corrupts stereo depths."""
    s = tex.shape[0] / (2 * plane_half)
    S = np.array(
        [[s, 0, tex.shape[0] / 2.0], [0, s, tex.shape[0] / 2.0], [0, 0, 1.0]]
    )
    R_cw = T_cw[:3, :3]
    t_cw = T_cw[:3, 3]
    Hwi = K3 @ np.stack([R_cw[:, 0], R_cw[:, 1], t_cw], axis=1)
    img = _warp_perspective(tex, Hwi @ np.linalg.inv(S), h, w, wrap=True)
    if relief_tex is not None:
        n = relief_tex.shape[0]
        Sr = np.array(
            [[n / (2 * relief_half), 0, n / 2.0],
             [0, n / (2 * relief_half), n / 2.0], [0, 0, 1.0]]
        )
        Hr = K3 @ np.stack(
            [R_cw[:, 0], R_cw[:, 1], R_cw[:, 2] * relief_z + t_cw], axis=1
        )
        top = _warp_perspective(
            relief_tex, Hr @ np.linalg.inv(Sr), h, w, wrap=False, border=-1.0
        )
        img = np.where(top >= 0, top, img).astype(np.float32)
    if noise > 0 and noise_rng is not None:
        img = np.clip(
            img + noise_rng.randn(h, w).astype(np.float32) * noise, 0.0, 255.0
        )
    return img


def stereo_right_pose(T_cw, baseline):
    """Right-camera pose for a rectified pair: the right camera sits at +b
    along the left camera's x-axis, so t_r = t_l - (b,0,0)."""
    T = T_cw.copy()
    T[0, 3] -= baseline
    return T


def planar_sequence_stereo(
    n_frames=40, h=240, w=320, fx=260.0, fy=260.0, baseline=0.1, seed=0,
    motion="strafe", relief=False,
):
    """Stereo version: returns (imgs_l, imgs_r, poses, K)."""
    imgs_l, poses, K = planar_sequence(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fy, seed=seed, motion=motion,
        relief=relief,
    )
    tex = _texture(2048, seed)
    relief_tex = _texture(512, seed + 77) if relief else None
    K3 = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
    imgs_r = np.stack(
        [render_plane(tex, stereo_right_pose(T, baseline), K3, h, w,
                      relief_tex=relief_tex) for T in poses]
    )
    return imgs_l, imgs_r, poses, K


def planar_depth(pose_T_cw, K, h, w, relief=False, relief_half=1.2,
                 relief_z=0.8):
    """Exact depth map of the scene for RGB-D tests: the z=0 plane plus,
    with ``relief=True``, the raised platform (z=relief_z over the
    central [-relief_half, relief_half]^2) that the renderers draw — the
    depth image must agree pixel-for-pixel with the RGB render or RGB-D
    back-projection seeds wrong points."""
    R = pose_T_cw[:3, :3]
    t = pose_T_cw[:3, 3]
    fx, fy, cx, cy = K
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)], axis=-1
    )
    # world ray dir = R^T d; origin C = -R^T t; z=zp => lam solves
    # (C + lam * R^T d).z = zp along *camera* z: depth = z_cam of the hit
    d_w = rays @ R  # [h,w,3] (R^T applied to each ray)
    C = -R.T @ t
    dz = np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9, d_w[..., 2])
    lam = (0.0 - C[2]) / dz
    depth = np.where(lam > 0, lam, 0.0)
    if relief:
        lam_r = (relief_z - C[2]) / dz
        hit = C[None, None, :] + lam_r[..., None] * d_w
        on_platform = (
            (lam_r > 0)
            & (np.abs(hit[..., 0]) <= relief_half)
            & (np.abs(hit[..., 1]) <= relief_half)
        )
        depth = np.where(on_platform, lam_r, depth)
    return depth.astype(np.float32)


def write_tum_sequence(
    out_dir: str,
    n_frames: int = 120,
    h: int = 240,
    w: int = 320,
    fx: float = 260.0,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    sensor: str = "mono",
    n_features: int = 600,
    depth_factor: float = 5000.0,
    fps: float = 30.0,
):
    """Write a synthetic sequence to disk in the TUM RGB-D dataset layout
    the reference drivers consume (Examples/Monocular/mono_tum.cc:36-132,
    Examples/RGB-D/rgbd_tum.cc): ``rgb/*.png`` + ``rgb.txt``,
    ``groundtruth.txt`` (T_wc, 'ts tx ty tz qx qy qz qw'), a reference-
    format settings YAML, and for ``sensor='rgbd'`` also ``depth/*.png``
    (16-bit, ``depth_factor`` counts per meter, TUM's 5000) +
    ``depth.txt`` + ``associations.txt``.

    Exists so the example drivers — the reference's only integration
    surface — can run end-to-end in CI without network datasets.
    Returns (settings_path, out_dir)."""
    import os

    import cv2  # optional dependency: PNG writing only

    from .trajectory import _R_to_quat

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    if sensor == "rgbd":
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    K4 = np.array([fx, fx, w / 2.0, h / 2.0])
    stream = planar_stream(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fx, seed=seed, motion=motion,
        plane_half=plane_half, relief=True, noise=4.0,
    )
    rgb_lines, depth_lines, assoc_lines, gt_lines = [], [], [], []
    for i, (img, T_cw) in enumerate(stream):
        ts = i / fps
        name = f"{ts:.6f}.png"
        cv2.imwrite(
            os.path.join(out_dir, "rgb", name),
            np.clip(img, 0, 255).astype(np.uint8),
        )
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        if sensor == "rgbd":
            d = planar_depth(T_cw, K4, h, w, relief=True)
            d16 = np.clip(d * depth_factor, 0, 65535).astype(np.uint16)
            cv2.imwrite(os.path.join(out_dir, "depth", name), d16)
            depth_lines.append(f"{ts:.6f} depth/{name}")
            assoc_lines.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        # TUM groundtruth is T_wc (camera pose in world)
        R_wc = T_cw[:3, :3].T
        C = -R_wc @ T_cw[:3, 3]
        qx, qy, qz, qw = _R_to_quat(R_wc)
        gt_lines.append(
            f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    hdr = "# synthetic TUM-format sequence\n# timestamp filename\n"
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write(hdr + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write(
            "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n"
            + "\n".join(gt_lines) + "\n"
        )
    if sensor == "rgbd":
        with open(os.path.join(out_dir, "depth.txt"), "w") as f:
            f.write(hdr + "\n".join(depth_lines) + "\n")
        with open(os.path.join(out_dir, "associations.txt"), "w") as f:
            f.write("\n".join(assoc_lines) + "\n")
    settings_path = os.path.join(out_dir, "settings.yaml")
    with open(settings_path, "w") as f:
        f.write(
            "%YAML:1.0\n"  # reference-format directive (stripped by loader)
            f"Camera.fx: {fx}\nCamera.fy: {fx}\n"
            f"Camera.cx: {w / 2.0}\nCamera.cy: {h / 2.0}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\n"
            "Camera.p1: 0.0\nCamera.p2: 0.0\nCamera.k3: 0.0\n"
            f"Camera.fps: {fps}\nCamera.RGB: 1\n"
            # bf = fx * baseline: REQUIRED for rgbd/stereo — the close-point
            # gate is depth < ThDepth*bf/fx (reference Tracking.cc:134-147,
            # TUM1.yaml ships Camera.bf: 40.0); bf=0 silently spawns zero
            # depth points at init and the system never tracks
            f"Camera.bf: {0.15 * fx:.1f}\n"
            f"ORBextractor.nFeatures: {n_features}\n"
            "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
            "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
            "ThDepth: 40.0\n"
            f"DepthMapFactor: {depth_factor}\n"
        )
    return settings_path, out_dir


def write_kitti_sequence(
    out_dir: str,
    n_frames: int = 120,
    h: int = 240,
    w: int = 320,
    fx: float = 260.0,
    baseline: float = 0.12,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    n_features: int = 600,
    fps: float = 10.0,
):
    """Write a synthetic stereo sequence in the KITTI odometry layout the
    reference stereo driver consumes (Examples/Stereo/stereo_kitti.cc
    LoadImages): ``image_0/`` + ``image_1/`` grayscale pairs,
    ``times.txt``, a ``poses.txt`` ground truth (3x4 T_wc rows, the KITTI
    devkit format), and a reference-format settings YAML with
    ``Camera.bf = fx * baseline``. Returns (settings_path, out_dir)."""
    import os

    import cv2  # optional dependency: PNG writing only

    os.makedirs(os.path.join(out_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_1"), exist_ok=True)
    K3 = np.array([[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1.0]])
    tex = _texture(2048, seed)
    relief_tex = _texture(512, seed + 77)
    noise = 4.0
    rng_r = np.random.RandomState(seed + 979)
    stream = planar_stream(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fx, seed=seed, motion=motion,
        plane_half=plane_half, relief=True, noise=noise,
    )
    times, gt_rows = [], []
    for i, (img_l, T_cw) in enumerate(stream):
        img_r = render_plane(
            tex, stereo_right_pose(T_cw, baseline), K3, h, w,
            plane_half=plane_half, relief_tex=relief_tex,
            noise=noise, noise_rng=rng_r,
        )
        for sub, img in (("image_0", img_l), ("image_1", img_r)):
            cv2.imwrite(
                os.path.join(out_dir, sub, f"{i:06d}.png"),
                np.clip(img, 0, 255).astype(np.uint8),
            )
        times.append(f"{i / fps:.6e}")
        R_wc = T_cw[:3, :3].T
        C = -R_wc @ T_cw[:3, 3]
        M = np.concatenate([R_wc, C[:, None]], axis=1)
        gt_rows.append(" ".join(f"{x:.9e}" for x in M.reshape(-1)))
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(out_dir, "poses.txt"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    settings_path = os.path.join(out_dir, "settings.yaml")
    with open(settings_path, "w") as f:
        f.write(
            "%YAML:1.0\n"
            f"Camera.fx: {fx}\nCamera.fy: {fx}\n"
            f"Camera.cx: {w / 2.0}\nCamera.cy: {h / 2.0}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\n"
            "Camera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.fps: {fps}\nCamera.RGB: 1\n"
            f"Camera.bf: {baseline * fx:.4f}\n"
            f"ORBextractor.nFeatures: {n_features}\n"
            "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
            "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
            "ThDepth: 40.0\n"
        )
    return settings_path, out_dir


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
