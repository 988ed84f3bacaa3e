#!/usr/bin/env python
"""Two-process multi-host simulation on CPU devices.

The reference is strictly single-process (SURVEY.md §5: OpenMP only), so
there is no multi-node precedent to port; this script stands in for the
BASELINE.json "2 hosts" measurement protocol using jax.distributed with
N virtual CPU devices per process.  Each process:

  1. initialises the cluster via parallel.launch.init,
  2. builds the GLOBAL ('cam','block') mesh spanning both processes,
  3. runs the replica-sharded MWCP solver with collective K-best
     (cross-process all_gather over the 'block' axis),
  4. steps the PRODUCTION TrackingEngine SPMD on the global mesh,
  5. process 0 writes a scaling_report JSON.

Launch (the test tests/test_multiprocess.py does this automatically):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python scripts/multihost_sim.py --coordinator localhost:PORT \
        --num-processes 2 --process-id {0,1} --out report.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--engine-frames", type=int, default=3)
    args = ap.parse_args()

    import os
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=4")
    import jax
    # a virtual CPU mesh on every machine, with or without an accelerator
    jax.config.update("jax_platforms", "cpu")

    from mcmtt_opticalflow_tpu.parallel import launch

    launch.init(args.coordinator, num_processes=args.num_processes,
                process_id=args.process_id)
    assert jax.process_count() == args.num_processes, jax.process_count()
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == n_local * args.num_processes, (n_local, n_global)

    mesh = launch.global_mesh()
    assert mesh.size == n_global

    import jax.numpy as jnp
    import numpy as np

    from mcmtt_opticalflow_tpu.config import (EngineConfig, SolverConfig,
                                              Tracker2DConfig)
    from mcmtt_opticalflow_tpu.parallel import solve_mwcp_sharded

    # --- sharded solver with cross-process collective K-best -------------
    scfg = SolverConfig(num_replicas=2, max_vertices=64,
                        solutions_per_replica=4)
    rng = np.random.RandomState(7)
    v = scfg.max_vertices
    weights = jnp.asarray(rng.rand(v).astype(np.float32))
    adj_np = rng.rand(v, v) < 0.5
    adj_np = np.triu(adj_np, 1)
    adj = jnp.asarray(adj_np | adj_np.T)
    valid = jnp.ones((v,), bool)
    init = jnp.zeros((v,), bool)

    def solve(m, iters=80):
        best_mask, best_score, _, _ = solve_mwcp_sharded(
            weights, adj, valid, init, jax.random.PRNGKey(3), m, scfg,
            iters=iters)
        jax.block_until_ready(best_score)
        return np.asarray(best_mask), float(best_score)

    mask, score = solve(mesh)                      # compile + correctness
    members = np.where(mask)[0]
    full_adj = np.asarray(adj)
    for a in members:
        for b in members:
            assert a == b or full_adj[a, b], "collective pick not a clique"
    assert score > 0.0

    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        solve(mesh)
    mesh_s = (time.perf_counter() - t0) / reps

    # single-device reference timing (local, same instance)
    from mcmtt_opticalflow_tpu.models.mwcp import solve_mwcp
    one = jax.jit(lambda k: solve_mwcp(weights, adj, valid, init, k, scfg,
                                       80).best_score.max())
    jax.block_until_ready(one(jax.random.PRNGKey(3)))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(one(jax.random.PRNGKey(3)))
    one_s = (time.perf_counter() - t0) / reps

    # --- PRODUCTION engine SPMD on the cross-process mesh ----------------
    from mcmtt_opticalflow_tpu.data import make_scenario
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine

    num_cams = mesh.shape["cam"]
    w, h = 128, 96
    sc = make_scenario(num_cameras=num_cams, num_frames=args.engine_frames,
                       num_people=3, image_size=(w, h), arena=3000.0, seed=0)
    cfg = EngineConfig(
        num_cameras=num_cams, image_width=w, image_height=h,
        tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=2, max_vertices=64,
                            solutions_per_replica=4, max_iterations=60))
    eng = TrackingEngine(cfg, sc.cameras, mesh=mesh)
    n_results = 0
    for t in range(args.engine_frames):
        frames = (np.clip(np.stack(sc.frames(t)), 0, 1) * 255).astype(
            np.uint8)
        r = eng.process_frame(frames, sc.detections[t], frame_idx=t)
        n_results += len(r.ids)
    assert n_results > 0, "engine produced no tracks on the 2-process mesh"

    if args.process_id == 0 and args.out:
        report = launch.scaling_report(mesh, 1.0 / one_s, 1.0 / mesh_s)
        report.update(processes=args.num_processes,
                      local_devices=n_local,
                      solver_best_score=score,
                      engine_track_results=n_results)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"process {args.process_id}: ok mesh={dict(mesh.shape)} "
          f"score={score:.3f} engine_results={n_results}", flush=True)


if __name__ == "__main__":
    main()
