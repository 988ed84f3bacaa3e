#!/usr/bin/env python
"""Density-quality lab: run the bench's 22-person scene (or an
associator-only variant) on CPU and print MOTA per deferred window plus
population counters.  The fast inner loop for candidate-containment and
density-quality work — no device 2D stage, no rendering when
--assoc-only.

--assoc-only synthesizes the 2D stage's output directly from ground
truth: per camera, each visible person's box becomes a tracklet whose id
rotates every max_tracklet_length frames (the synchronized-rotation load
that defines the bench scene), false positives become one-frame
tracklets, and misses drop the tracklet for a frame.  This reproduces the
associator-side density dynamics of the full pipeline at ~100x the speed.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def audit_frame(eng, sc, t):
    """Per-person coverage audit: is each GT person near a best track?
    near ANY selectable (cost<0) track?  near ANY valid track at all?
    Separates formation failures from selection failures."""
    print(f"f{t:03d} {dict(eng.assoc.diag)}", file=sys.stderr)
    gt = sc.gt_xy[t]
    best_pts = eng.deferred_result(t).points[:, :2]
    sel_pts, any_pts = [], []
    for tr in eng.assoc.registry.tracks.values():
        if not tr.valid:
            continue
        p = tr.point_at(t)
        if p is None:
            continue
        any_pts.append(p[:2])
        if tr.total_cost() < 0:
            sel_pts.append(p[:2])
    sel_pts = np.asarray(sel_pts).reshape(-1, 2)
    any_pts = np.asarray(any_pts).reshape(-1, 2)

    def near(pts, p):
        return len(pts) and np.linalg.norm(pts - gt[p], axis=1).min() < 1000.0

    miss_b = miss_s = miss_a = 0
    for p in range(sc.num_people):
        if np.isnan(gt[p, 0]):
            continue
        if not near(best_pts, p):
            miss_b += 1
            if not near(sel_pts, p):
                miss_s += 1
                if not near(any_pts, p):
                    miss_a += 1
                else:
                    # cost breakdown of the nearest unselectable track
                    cand, dist = None, 1e18
                    for tr in eng.assoc.registry.tracks.values():
                        if not tr.valid:
                            continue
                        pt = tr.point_at(t)
                        if pt is None:
                            continue
                        dd = float(np.linalg.norm(pt[:2] - gt[p]))
                        if dd < dist:
                            cand, dist = tr, dd
                    if cand is not None and dist < 1000.0:
                        ncam = int(np.asarray(
                            cand.raw_mask[:cand.n_measured]).sum(1).mean()
                            * 10) / 10 if cand.n_measured else 0
                        print(
                            f"      p{p}: d={dist:.0f} len={cand.length} "
                            f"meas={cand.n_measured} born={cand.time_start} "
                            f"en={cand.cost_enter:.1f} "
                            f"rec={float(cand.cost_recon_pos.sum()):.1f} "
                            f"lnk={float(cand.cost_link_pos.sum()):.1f} "
                            f"rgb={cand.cost_rgb:.1f} "
                            f"ex={cand.cost_exit:.1f} avg_cams={ncam}",
                            file=sys.stderr)
    print(f"      miss_best={miss_b} (no-selectable={miss_s}, "
          f"no-track-at-all={miss_a})", file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=35)
    ap.add_argument("--people", type=int, default=22)
    ap.add_argument("--assoc-only", action="store_true")
    ap.add_argument("--vmax", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--debug", action="store_true",
                    help="print per-frame associator diagnostics")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    from mcmtt_opticalflow_tpu.config import (Associator3DConfig,
                                              EngineConfig, SolverConfig,
                                              Tracker2DConfig)
    from mcmtt_opticalflow_tpu.data import make_scenario
    from mcmtt_opticalflow_tpu.eval.clearmot import ClearMotAccumulator
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine

    sc = make_scenario(num_cameras=4, num_frames=args.frames,
                       num_people=args.people, image_size=(768, 576),
                       arena=9000.0, noise_px=1.0, fp_rate=0.10,
                       fn_rate=0.05, seed=args.seed)
    cfg = EngineConfig(
        num_cameras=4, image_width=768, image_height=576,
        tracker2d=Tracker2DConfig(lk_pyramid_levels=2, lk_iterations=8,
                                  max_detections=48, max_trackers=64,
                                  max_features=int(os.environ.get('LAB_FEATS', 64))),
        assoc3d=Associator3DConfig(k_best_size=30),
        solver=SolverConfig(num_replicas=8, max_vertices=args.vmax,
                            max_iterations=150))
    gx, gy = sc.gt_matrices()
    zone = (-9000.0, -9000.0, 9000.0, 9000.0)
    windows = (0, 3, 6)
    accs = {w: ClearMotAccumulator(gx, gy, zone, 1000.0) for w in windows}

    eng = TrackingEngine(cfg, sc.cameras, pipelined=False)

    tracks_peak = 0
    t0 = time.perf_counter()
    prof = None
    if args.profile:
        import cProfile
        prof = cProfile.Profile()
    if args.assoc_only:
        from mcmtt_opticalflow_tpu.data.synthetic import synth_tracklet_stream
        tk = synth_tracklet_stream(
            sc, cfg.tracker2d.max_trackers,
            cfg.tracker2d.max_tracklet_length, seed=args.seed + 1)
        gray = np.full((4, 576, 768, 3), 128, np.uint8)
        if prof:
            prof.enable()
        for t in range(sc.num_frames):
            ids, boxes, mask = tk[t]
            eng.assoc.step(t, ids, boxes, mask, gray)
            tracks_peak = max(tracks_peak, len(eng.assoc.registry.tracks))
            if args.debug:
                audit_frame(eng, sc, t)
            for w in windows:
                if t - w >= 0:
                    r = eng.deferred_result(t - w)
                    accs[w].set_result(t - w, [(i, p[0], p[1]) for i, p in
                                               zip(r.ids, r.points)])
    else:
        frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
                  .astype(np.uint8) for t in range(sc.num_frames)]
        if prof:
            prof.enable()
        for t in range(sc.num_frames):
            eng.process_frame(frames[t], sc.detections[t], frame_idx=t)
            tracks_peak = max(tracks_peak, len(eng.assoc.registry.tracks))
            if args.debug:
                audit_frame(eng, sc, t)
            for w in windows:
                if t - w >= 0:
                    r = eng.deferred_result(t - w)
                    accs[w].set_result(t - w, [(i, p[0], p[1]) for i, p in
                                               zip(r.ids, r.points)])
    if prof:
        prof.disable()
        prof.dump_stats(args.profile)
    elapsed = time.perf_counter() - t0
    # finalize backfill
    last = sc.num_frames - 1
    for w in windows:
        for td in range(max(last - w + 1, 0), last + 1):
            r = eng.deferred_result(td)
            accs[w].set_result(td, [(i, p[0], p[1]) for i, p in
                                    zip(r.ids, r.points)])
    evals = {w: accs[w].evaluate() for w in windows}
    for w in windows:
        print(f"w{w}: {evals[w].summary()}", file=sys.stderr)
    print(eng.assoc.timer.summary(), file=sys.stderr)
    print(json.dumps({
        "frames": sc.num_frames, "elapsed_s": round(elapsed, 1),
        "tracks_peak": tracks_peak,
        "pool_dropped": eng.assoc.pool_dropped_total,
        **{f"mota_w{w}": round(evals[w].mota, 4) for w in windows},
        **{f"ids_w{w}": evals[w].id_switches for w in windows},
        **{f"recall_w{w}": round(evals[w].recall, 3) for w in windows},
    }))


if __name__ == "__main__":
    main()
