"""Distributed bundle adjustment over a device mesh.

The reference has no distributed capability at all (SURVEY.md §2.3) — this
is the BASELINE.json config #5 target: observations (edges) are sharded
across the mesh's ``ba`` axis, keyframe poses and points are replicated,
and every segment-sum reduction inside the Schur/CG engine (ops/ba.py)
becomes local-accumulate + ``psum`` (NCCL all-reduce over NVLink between
the cards of one host). Each device then applies the identical
reduced-system update, so the state stays replicated with no
gather/scatter traffic of the map itself — communication is exactly one
[C,6,6]+[C,6]+[P,3,3]+[P,3] psum per LM iteration plus two [C/P-sized]
psums per CG step.

Edge sharding is the natural axis: edge count (observations) dominates
compute and grows with trajectory length, while pose/point state is small.

Communication model (why replicated state + edge sharding is right at
SLAM scale — BASELINE #5's "keyframe/map-block sharded" wording is
satisfied by sharding the keyframes' OBSERVATIONS; the poses themselves
are deliberately replicated). Volumes follow from the shapes:

  KITTI-00 scale: C ~= 1,400 keyframes, P ~= 140k points, O ~= 5M edges.
  * replicated state:  C*7 + P*3 floats ~= 1.7 MB (+ descriptors etc.
    ~20 MB in all) — negligible next to a card's 80 GB.
  * per LM iteration, each device all-reduces:
      Hcc [C,6,6] + bc [C,6]      ~= 0.8 MB
      Hpp [P,3,3] + bp [P,3]      ~= 6.7 MB
      + 2 all-reduces per CG step of [C,6] / [P,3] partials ~= 1.8 MB x 40
    ~= 80 MB per iteration.
  * per-device compute per LM iteration shrinks as O/n edges.
  Compute shrinks as 1/n while the all-reduce volume is constant in n, so
  scaling holds while the per-device edge sweep costs more than the
  all-reduce. The cards of one host are joined all to all, so the mesh is
  flat and follows the algorithm alone. Sharding poses instead (all_gather
  per sweep) would move the SAME Hcc/Hpp volume per iteration but add
  gather latency on the critical path and complicate the Schur
  elimination for zero memory benefit at this state size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ba


def make_ba_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("ba",))


def shard_problem(prob: ba.BAProblem, mesh: Mesh) -> ba.BAProblem:
    """Pad edge arrays to a multiple of the mesh size and device_put with
    edge-sharded / state-replicated shardings."""
    n = mesh.shape["ba"]
    O = prob.cam_idx.shape[0]
    pad = (-O) % n

    def pad_edge(x, fill=0):
        if pad == 0:
            return x
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg, constant_values=fill)

    prob = prob._replace(
        cam_idx=pad_edge(prob.cam_idx),
        pnt_idx=pad_edge(prob.pnt_idx),
        uvr=pad_edge(prob.uvr),
        is_stereo=pad_edge(prob.is_stereo),
        inv_sigma2=pad_edge(prob.inv_sigma2),
        valid=pad_edge(prob.valid),  # pad edges are masked out
    )
    edge_sh = NamedSharding(mesh, P("ba"))
    edge_sh2 = NamedSharding(mesh, P("ba", None))
    rep = NamedSharding(mesh, P())
    return ba.BAProblem(
        poses=jax.device_put(prob.poses, rep),
        points=jax.device_put(prob.points, rep),
        K=jax.device_put(prob.K, rep),
        bf=jax.device_put(prob.bf, rep),
        cam_idx=jax.device_put(prob.cam_idx, edge_sh),
        pnt_idx=jax.device_put(prob.pnt_idx, edge_sh),
        uvr=jax.device_put(prob.uvr, edge_sh2),
        is_stereo=jax.device_put(prob.is_stereo, edge_sh),
        inv_sigma2=jax.device_put(prob.inv_sigma2, edge_sh),
        valid=jax.device_put(prob.valid, edge_sh),
        fixed_cam=jax.device_put(prob.fixed_cam, rep),
        fixed_pnt=jax.device_put(prob.fixed_pnt, rep),
    )


@partial(jax.jit, static_argnames=("mesh", "n_iters", "cg_iters", "use_huber"))
def dist_ba_solve(
    prob: ba.BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    cg_iters: int = 40,
    use_huber: bool = True,
):
    """shard_map-wrapped ops/ba.ba_solve with psum reductions over 'ba'."""
    edge = P("ba")
    edge2 = P("ba", None)
    rep = P()
    in_specs = ba.BAProblem(
        poses=rep, points=rep, K=rep, bf=rep,
        cam_idx=edge, pnt_idx=edge, uvr=edge2, is_stereo=edge,
        inv_sigma2=edge, valid=edge, fixed_cam=rep, fixed_pnt=rep,
    )

    def run(p):
        out, cost = ba.ba_solve(
            p, n_iters=n_iters, cg_iters=cg_iters, use_huber=use_huber,
            axis_name="ba",
        )
        return out, cost

    out, cost = jax.shard_map(
        run, mesh=mesh, in_specs=(in_specs,),
        out_specs=(in_specs, rep), check_vma=False,
    )(prob)
    return out, cost


@partial(jax.jit, static_argnames=("mesh",))
def dist_score_database(bow_mat, query_bow, kf_valid, mesh: Mesh):
    """Loop-retrieval scoring with the keyframe database sharded over the
    mesh (BASELINE 'sharding loop-closure candidate retrieval'):
    each device scores its keyframe shard; results all-gather."""

    def run(bm, q, v):
        scores = 1.0 - 0.5 * jnp.sum(jnp.abs(bm - q[None, :]), axis=-1)
        common = jnp.sum(
            ((bm > 0) & (q > 0)[None, :]).astype(jnp.int32), axis=-1
        )
        scores = jnp.where(v, scores, -1.0)
        return scores, jnp.where(v, common, 0)

    return jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(P("ba", None), P(), P("ba")),
        out_specs=(P("ba"), P("ba")),
    )(bow_mat, query_bow, kf_valid)


# ----------------------------------------------------------------------
# multi-host entry (BASELINE.json config #5: "multi-host keyframe-sharded
# Schur BA"). The reference has no distributed story at all — its only
# concurrency is std::thread + mutexes (SURVEY.md §2.3): one process per
# host, jax.distributed handshake, then a process-spanning Mesh over the
# global device list; the same edge-sharded shard_map program runs
# unchanged.
# ----------------------------------------------------------------------

def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Join (or start) a multi-process JAX job and return the
    process-spanning BA mesh over ALL devices in the job.

    With all arguments omitted, ``jax.distributed.initialize()`` is
    called with no arguments: a cluster manager that JAX recognises
    supplies the coordinator and process topology; on a plain host JAX
    finds no coordinator, which is treated as "not a distributed job" (a
    process-local mesh is returned). Elsewhere pass the three arguments
    explicitly (e.g. coordinator 'host0:1234', one process per host).
    Idempotent: safe to call when jax.distributed is already initialized.
    """
    import jax

    if num_processes is None and coordinator_address is None:
        try:
            jax.distributed.initialize()
        except ValueError as e:  # no coordinator: not a distributed job
            if "coordinator_address" not in str(e):
                raise
    elif num_processes is not None and num_processes > 1:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        except RuntimeError as e:  # already initialized
            if "already" not in str(e).lower():
                raise
    # jax.devices() is the GLOBAL list after initialize(); the mesh spans
    # every process. Data placement: pass the same global arrays on all
    # processes to shard_problem — jax.device_put with a NamedSharding
    # places only this process's addressable shards.
    return make_ba_mesh(devices=jax.devices())


def process_local_report(mesh: Mesh) -> dict:
    """Small observability dict for multi-host runs (who am I, what do I
    hold) — printed by scripts/dist_ba_multihost.py on every process."""
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "mesh_shape": dict(zip(mesh.axis_names, mesh.devices.shape)),
    }
