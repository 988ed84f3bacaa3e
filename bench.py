#!/usr/bin/env python
"""End-to-end throughput benchmark at PETS-like density, on one GPU.

Runs the full pipeline (camera-batched LK 2D tracking -> 3D MHT association
-> K-best hypothesis solve) on a synthetic 4-camera scenario at 768x576 with
PETS S2.L1-like load: >=20 concurrent people, detector noise (10% FP, 5% FN,
1 px jitter), K=30 carried hypotheses (ref parameters.txt:51 sweeps K up to
30/50), 30 measured frames.

The reference publishes no throughput numbers (BASELINE.md); its dataset
runs at 7 fps (psn_where/PSNWhere_Associator3D.cpp:88), so vs_baseline here
is real-time factor: fps / 7.0.  Prints ONE JSON line naming the device it
ran on; the per-stage timing breakdown goes to stderr.  Exits non-zero,
without a result, when JAX finds no GPU.

    python bench.py [num_frames]        # default 30; a different count is
                                        # a different scene
"""

import json
import os
import sys
import time

import numpy as np

WARMUP = 7   # enough frames for the pool to reach its terminal batch
#              buckets, so bucket compiles stay out of the measured window
WINDOWS = (0, 3, 6)    # CLEAR-MOT deferred windows of the MOTA triple


def bench_config(assoc_overrides=None):
    """The benchmark's engine configuration (shaped on PETS2009 S2.L1)."""
    from mcmtt_opticalflow_tpu.config import (Associator3DConfig,
                                              EngineConfig, SolverConfig,
                                              Tracker2DConfig)
    return EngineConfig(
        num_cameras=4, image_width=768, image_height=576,
        # 2 pyramid levels cover the PETS-scale per-frame motion (<16 px)
        # and keep the cold-compile budget bounded.  36 features/box (6x6
        # grid): better dense-scene MOTA than 64 on the full pipeline,
        # with ~44% less LK work
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                  max_detections=48, max_trackers=64,
                                  max_features=36),
        assoc3d=Associator3DConfig(k_best_size=30,
                                   **(assoc_overrides or {})),
        # 150 BLS iterations: every carried hypothesis warm-starts a
        # replica, so convergence needs far fewer moves than the
        # reference's cold 2000-iteration budget; the recorded-graph
        # quality harness (tests/test_solver_quality.py) certifies
        # brute-force-ratio >= 0.99 at this setting.  max_vertices=1024
        # brings the survivor cap to the reference's 2000 tracks
        # (min(2000, 2V), ref Associator3D.cpp:23) and keeps pool_dropped
        # at ~0 at this density (V=512 dropped ~60/frame)
        solver=SolverConfig(num_replicas=8, max_vertices=1024,
                            max_iterations=150),
    )


def bench_scene(num_frames):
    """(scenario, uint8 frames) for num_frames measured frames after
    WARMUP; the scene depends on num_frames (make_scenario's RNG)."""
    from mcmtt_opticalflow_tpu.data import make_scenario

    total = num_frames + WARMUP
    sc = make_scenario(num_cameras=4, num_frames=total,
                       num_people=22, image_size=(768, 576), arena=9000.0,
                       noise_px=1.0, fp_rate=0.10, fn_rate=0.05, seed=0)
    # pre-render frames so rendering cost stays out of the measurement;
    # uint8, as dataset JPEGs decode to (the engine's native ingest format)
    frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
              .astype(np.uint8) for t in range(total)]
    return sc, frames


def bench_engine(sc, assoc_overrides=None, mesh=None):
    """The benchmark's engine: bench_config, pipelined, on one device or
    on a ('cam', 'block') mesh."""
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine

    return TrackingEngine(bench_config(assoc_overrides), sc.cameras,
                          pipelined=True, mesh=mesh)


def run_bench(num_frames=30, assoc_overrides=None, verbose=False,
              profile_path=None, scene=None, engine=None):
    """Run the benchmark; returns a dict of results (see main's JSON).

    scene: bench_scene(num_frames)'s result, when the caller built it.
    engine: the engine to drive, when the caller built it (bench_engine,
    e.g. on a mesh or with its hypothesis graphs recorded)."""
    from mcmtt_opticalflow_tpu.eval.clearmot import ClearMotAccumulator
    from mcmtt_opticalflow_tpu.utils.timing import CompileCounter

    compiles = CompileCounter()
    sc, frames = scene if scene is not None else bench_scene(num_frames)
    total = len(frames)
    assert total == num_frames + WARMUP, (total, num_frames)
    # quality co-report: CLEAR-MOT at deferred windows {0, 3, 6} over the
    # whole run, so perf work cannot silently trade MOTA (the zone covers
    # the synthetic arena; margin = the reference's match radius)
    gx, gy = sc.gt_matrices()
    zone = (-9000.0, -9000.0, 9000.0, 9000.0)
    accs = {w: ClearMotAccumulator(gx, gy, zone, 1000.0) for w in WINDOWS}
    harvested = -1

    def harvest(eng):
        nonlocal harvested
        done = getattr(eng.assoc, "completed_frame", eng.assoc.frame_idx)
        while harvested < done:
            harvested += 1
            for w in WINDOWS:
                td = harvested - w
                if td >= 0:
                    r = eng.deferred_result(td)
                    accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                            zip(r.ids, r.points)])

    eng = engine if engine is not None else bench_engine(sc, assoc_overrides)

    # warmup (compilation; the engine's device programs compile on the
    # first few frames as batch-size buckets appear)
    t_warm = time.perf_counter()
    for t in range(WARMUP):
        tw = time.perf_counter()
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        harvest(eng)
        if verbose:
            print(f"warmup frame {t}: {time.perf_counter() - tw:.1f}s",
                  file=sys.stderr, flush=True)
    warmup_s = time.perf_counter() - t_warm
    # force-compile the terminal batch buckets the growing track pool
    # reaches only mid-run (a compile inside the measured window otherwise
    # lands on 1-2 frames)
    tw = time.perf_counter()
    eng.assoc.precompile()
    precompile_s = time.perf_counter() - tw
    if verbose:
        print(f"bucket precompile: {precompile_s:.1f}s",
              file=sys.stderr, flush=True)
    eng.assoc.timer.reset()   # steady-state stage times only
    compiles_setup = compiles.snapshot()

    prof = None
    if profile_path:
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
    t0 = time.perf_counter()
    per_frame = []
    tracks_peak = 0
    for t in range(WARMUP, total):
        f0 = time.perf_counter()
        eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
        per_frame.append(time.perf_counter() - f0)
        tracks_peak = max(tracks_peak, len(eng.assoc.registry.tracks))
        harvest(eng)
    elapsed = time.perf_counter() - t0
    if prof is not None:
        prof.disable()
        prof.dump_stats(profile_path)
    compiles_window = compiles.snapshot()["n"] - compiles_setup["n"]
    while eng.flush() is not None:       # drain the pipeline tail
        harvest(eng)
    # finalize-time backfill (every window scores every frame)
    for w in WINDOWS:
        for td in range(max(harvested - w + 1, 0), harvested + 1):
            r = eng.deferred_result(td)
            accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                    zip(r.ids, r.points)])
    evals = {w: accs[w].evaluate() for w in WINDOWS}
    timer = eng.assoc.timer
    stage_ms = {
        name: round(1e3 * sorted(timer.samples[name])
                    [timer.counts[name] // 2], 2)
        for name in sorted(timer.totals, key=lambda n: -timer.totals[n])
        if not name.startswith("_")
    }
    return {
        # median per-frame time is robust to residual bucket compiles
        "fps": 1.0 / float(np.median(per_frame)),
        "per_frame_s": per_frame,
        "elapsed_s": elapsed,
        "warmup_s": warmup_s,
        "precompile_s": precompile_s,
        "compile": compiles_setup,
        "compiles_in_window": compiles_window,
        "tracks_peak": tracks_peak,
        "pool_dropped": eng.assoc.pool_dropped_total,
        "evals": evals,
        "mota": {w: evals[w].mota for w in WINDOWS},
        "stage_ms": stage_ms,
        "timer_summary": timer.summary(),
        "engine": eng,
    }


def main():
    from mcmtt_opticalflow_tpu.utils.device import (NoGpuError, nvidia_smi,
                                                    require_gpu)
    try:
        device = require_gpu()
    except NoGpuError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    card = nvidia_smi()
    num_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    # quality-tuning experiments: BENCH_ASSOC_OVERRIDES="k=v,k=v" patches
    # Associator3DConfig fields (ints/floats) without editing the bench
    overrides = {}
    for kv in os.environ.get("BENCH_ASSOC_OVERRIDES", "").split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            overrides[k.strip()] = float(v) if "." in v else int(v)
    verbose = bool(os.environ.get("BENCH_VERBOSE"))
    res = run_bench(num_frames, overrides, verbose=verbose,
                    profile_path=os.environ.get("BENCH_PROFILE"))
    for w in WINDOWS:
        print(f"w{w}: {res['evals'][w].summary()}", file=sys.stderr)
    print(res["timer_summary"], file=sys.stderr)
    stage_ms = res["stage_ms"]
    dominant = next(iter(stage_ms), "?")
    print(f"dominant stage: {dominant} ({stage_ms.get(dominant)} ms median); "
          f"{len(res['per_frame_s'])} frames in {res['elapsed_s']:.1f}s, "
          f"tracks_peak={res['tracks_peak']}", file=sys.stderr)
    if verbose:
        print(f"per-frame: {[round(x, 2) for x in res['per_frame_s']]}",
              file=sys.stderr)
    fps = res["fps"]
    print(json.dumps({
        "metric": "end_to_end_frames_per_sec_4cam_768x576_22ppl_k30",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / 7.0, 3),
        "frames": len(res["per_frame_s"]),
        "tracks_peak": res["tracks_peak"],
        "pool_dropped": res["pool_dropped"],
        **{f"mota_w{w}": round(res["mota"][w], 4) for w in WINDOWS},
        "stage_ms": stage_ms,
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "gpu_name": card["name"],
        "power_limit": card["power_limit"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
