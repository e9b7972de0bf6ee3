"""Distributed-BA scaling check over an N-device mesh.

On several GPUs this measures the scaling of the edge-sharded Schur/CG
solver over NVLink; on CPU it runs the same SPMD program over
--xla_force_host_platform_device_count virtual devices, validating the
collective structure and reporting (non-physical) wall-clock ratios.

Usage: [JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8]
       python scripts/bench_dist_ba.py [n_obs_per_device]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def build(n_cams, n_pts, n_obs, key):
    from orbslam2_with_quadrics_tpu.ops import ba, camera, lie

    Kc = jnp.asarray([718.856, 718.856, 607.19, 185.2])
    bf = jnp.asarray(386.1448)
    pts = jax.random.uniform(
        key, (n_pts, 3),
        minval=jnp.asarray([-20.0, -5.0, 5.0]), maxval=jnp.asarray([20.0, 5.0, 60.0]),
    )
    poses = lie.se3_exp(
        jax.random.normal(key, (n_cams, 6))
        * jnp.asarray([0.01] * 3 + [0.5, 0.1, 0.5])
    )
    cam_idx = jax.random.randint(key, (n_obs,), 0, n_cams)
    pnt_idx = jax.random.randint(jax.random.PRNGKey(7), (n_obs,), 0, n_pts)
    uvr, _ = camera.project_stereo(
        Kc, bf, lie.se3_apply(poses[cam_idx], pts[pnt_idx])
    )
    return ba.BAProblem(
        poses=poses, points=pts + 0.05, K=Kc, bf=bf,
        cam_idx=cam_idx, pnt_idx=pnt_idx,
        uvr=uvr + 0.3 * jax.random.normal(key, uvr.shape),
        is_stereo=jnp.ones((n_obs,)), inv_sigma2=jnp.ones((n_obs,)),
        valid=jnp.ones((n_obs,)),
        fixed_cam=jnp.zeros((n_cams,)).at[0].set(1.0),
        fixed_pnt=jnp.zeros((n_pts,)),
    )


N_LM_ITERS = 5


def main(obs_per_device=65536):
    from orbslam2_with_quadrics_tpu.parallel import dist_ba

    n_dev = jax.device_count()
    counts = sorted({1, 2, n_dev} & set(range(1, n_dev + 1)))
    results = {}
    iters_per_sec = {}
    for nd in counts:
        mesh = dist_ba.make_ba_mesh(nd)
        prob = build(64, 16384, obs_per_device * nd, jax.random.PRNGKey(0))
        probd = dist_ba.shard_problem(prob, mesh)
        run = lambda: dist_ba.dist_ba_solve(
            probd, mesh, n_iters=N_LM_ITERS, cg_iters=30
        )
        out = run()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = run()
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        results[nd] = dt
        iters_per_sec[nd] = N_LM_ITERS / dt
    # weak scaling: N devices process N x the edges; efficiency = t_1/t_N
    effs = {
        nd: round(results[1] / results[nd], 3) for nd in counts if nd > 1
    }
    print(
        json.dumps(
            {
                "metric": "dist_ba_weak_scaling_efficiency",
                "value": (max(effs.values()) if effs else 1.0),
                "unit": f"t_1/t_N at {obs_per_device} obs/device",
                "platform": jax.devices()[0].platform,
                "device_counts": counts,
                "t_per_solve_s": {
                    str(k): round(v, 4) for k, v in results.items()
                },
                "ba_iters_per_sec": {
                    str(k): round(v, 2) for k, v in iters_per_sec.items()
                },
                "weak_scaling_efficiency": effs,
                "lm_iters_per_solve": N_LM_ITERS,
                "cg_iters": 30,
            }
        )
    )


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:2]])
