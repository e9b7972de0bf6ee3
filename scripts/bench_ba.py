"""BA iterations/sec benchmark (BASELINE.md 'additional metrics').

Times LM iterations of the Schur/CG bundle adjuster at a KITTI-local-BA
scale problem on the current platform. One JSON line.

Usage: python scripts/bench_ba.py [n_cams] [n_pts] [obs_per_cam]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main(n_cams=32, n_pts=8192, obs_per_cam=1024):
    from orbslam2_with_quadrics_tpu.ops import ba, camera, lie

    key = jax.random.PRNGKey(0)
    Kc = jnp.asarray([718.856, 718.856, 607.19, 185.2])  # KITTI00 intrinsics
    bf = jnp.asarray(386.1448)

    pts = jax.random.uniform(
        key, (n_pts, 3),
        minval=jnp.asarray([-20.0, -5.0, 5.0]), maxval=jnp.asarray([20.0, 5.0, 60.0]),
    )
    xi = jax.random.normal(key, (n_cams, 6)) * jnp.asarray(
        [0.01] * 3 + [0.5, 0.1, 0.5]
    )
    poses = lie.se3_exp(xi)
    O = n_cams * obs_per_cam
    cam_idx = jnp.repeat(jnp.arange(n_cams, dtype=jnp.int32), obs_per_cam)
    pnt_idx = jax.random.randint(key, (O,), 0, n_pts)
    uvr, _ = camera.project_stereo(
        Kc, bf, lie.se3_apply(poses[cam_idx], pts[pnt_idx])
    )
    uvr = uvr + 0.3 * jax.random.normal(key, uvr.shape)

    prob = ba.BAProblem(
        poses=jax.vmap(lie.se3_retract)(
            poses, jax.random.normal(key, (n_cams, 6)) * 0.01
        ),
        points=pts + 0.05,
        K=Kc,
        bf=bf,
        cam_idx=cam_idx,
        pnt_idx=pnt_idx,
        uvr=uvr,
        is_stereo=jnp.ones((O,)),
        inv_sigma2=jnp.ones((O,)),
        valid=jnp.ones((O,)),
        fixed_cam=jnp.zeros((n_cams,)).at[0].set(1.0),
        fixed_pnt=jnp.zeros((n_pts,)),
    )

    n_iters = 10
    reps = 5

    # scan over reps with the carry flowing into the problem so no rep
    # can be deduplicated or hoisted
    @jax.jit
    def run(poses0):
        def body(c, _):
            p, cost = ba.ba_solve(
                prob._replace(poses=c), n_iters=n_iters, cg_iters=40,
                use_huber=True,
            )
            return p.poses, cost
        return jax.lax.scan(body, poses0, None, length=reps)

    out = run(prob.poses)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = run(prob.poses)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    ips = n_iters / dt
    print(
        json.dumps(
            {
                "metric": "ba_lm_iters_per_sec",
                "value": round(ips, 2),
                "unit": f"LM iters/s ({n_cams}c/{n_pts}p/{O}obs, cg=40)",
                "platform": jax.devices()[0].platform,
                "final_cost": float(out[1][-1]),
            }
        )
    )


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
