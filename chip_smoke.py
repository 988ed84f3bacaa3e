#!/usr/bin/env python
"""Smoke test of the tracking engine on one GPU.

Runs the engine's main path (TrackingEngine(..., pipelined=True)
.process_frame at bench.py's PETS-shaped configuration) on the card, in one
process, and compares every device program with its plain reference:

  device     the card as JAX and nvidia-smi report it; the native host
             library
  refs       camera-batched 2D step (card vs the same program on the CPU),
             SG smoothing and triangulation (card vs float64 numpy) at
             bench widths
  e2e        bench.py's run: compile seconds, frames/s, MOTA triple,
             tracks_peak, pool_dropped, peak device bytes; the fused
             rescore+solve's best clique on the recorded tail graphs vs the
             native C++ BLS
  pipeline   pipelined engine == sequential engine, bit for bit, with a
             device trace of steady frames on the pipelined one (program
             device times, idle share, BLS while-loop time per trip)

    python chip_smoke.py            # one card, every phase
    python chip_smoke.py --four     # four cards: the ('cam','block') mesh
                                    # engine vs one card over the bench
                                    # run (tracks in every frame, MOTA
                                    # triple, every frame's fused program
                                    # replayed on both), and the sharded
                                    # solver vs one device; nothing else

Findings go to stdout line by line; the last line is one JSON object
{"ok": true, "device": {...}}.  Any failed check exits non-zero without
that line, as does a run where JAX finds no GPU.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PIPELINE_FRAMES = 12     # frames compared pipelined vs sequential
TRACE_FRAMES = 5         # steady frames in the trace window (after WARMUP)
MOTA_FLOOR = 0.80
BLS_RATIO_FLOOR = 0.99   # fused solve vs native BLS (tests/test_solver_quality)
TAIL_GRAPHS = 3          # pipeline-tail graphs compared with the native BLS
# name scopes whose kernel time the trace phase reports
TRACE_SCOPES = ("lk_track_points", "solve_assignment", "solve_mwcp",
                "compat")


class SmokeFailure(AssertionError):
    pass


def expect(ok, what):
    if not ok:
        raise SmokeFailure(what)


def say(msg):
    print(msg, flush=True)


def last_line(device):
    """The result line: {"ok": true, "device": {...}} and nothing else."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from mcmtt_opticalflow_tpu import native
    from mcmtt_opticalflow_tpu.utils.device import nvidia_smi, require_gpu

    device = require_gpu()
    say(f"device: platform={device['platform']} kind={device['kind']} "
        f"count={device['count']}")
    card = nvidia_smi()
    say(f"nvidia-smi: {card['name']}, {card['power_limit']}")
    say(f"compile cache: {jax.config.jax_compilation_cache_dir or 'none'}")
    lib = native.available()
    say(f"native host library: {'loaded' if lib else 'NOT loaded'}")
    expect(lib, "native host library did not load (make -C native)")
    return device


def _gray(frame_u8):
    """The engine's host gray conversion, then its device dequantisation."""
    g = ((frame_u8[..., 0].astype(np.uint16) + frame_u8[..., 1]
          + frame_u8[..., 2]) // 3).astype(np.uint8)
    return g.astype(np.float32) * np.float32(1.0 / 255.0)


def _pad_detections(dets, num_cams, cap):
    boxes = np.zeros((num_cams, cap, 4), np.float32)
    mask = np.zeros((num_cams, cap), bool)
    for c in range(num_cams):
        d = np.asarray(dets[c], np.float32).reshape(-1, 4)[:cap]
        boxes[c, :len(d)] = d
        mask[c, :len(d)] = True
    return boxes, mask


def tracker2d_outputs(cfg, sc, frames, steps, device):
    """(mask, ids, boxes) of the camera-batched 2D step on `device` over
    the first `steps` frames."""
    import jax

    from mcmtt_opticalflow_tpu.geometry import stack_cameras
    from mcmtt_opticalflow_tpu.models import init_tracker2d_state
    from mcmtt_opticalflow_tpu.models.tracker2d import make_tracker2d_step

    t2 = cfg.tracker2d
    step = make_tracker2d_step(t2, multi_camera=True)
    put = lambda x: jax.device_put(x, device)             # noqa: E731
    cams = put(stack_cameras(sc.cameras))
    st = put(init_tracker2d_state(t2, cfg.image_height, cfg.image_width,
                                  num_cameras=cfg.num_cameras))
    outs = []
    for t in range(steps):
        boxes, mask = _pad_detections(sc.detections[t], cfg.num_cameras,
                                      t2.max_detections)
        st, out = step(st, put(_gray(frames[t])), put(boxes), put(mask),
                       cams, put(np.int32(t)))
        outs.append(tuple(np.asarray(a)
                          for a in (out.mask, out.ids, out.boxes)))
    return outs


def tracker2d_on_cpu(cfg, sc, frames, steps):
    """The 2D step's reference: the same program compiled for the CPU,
    kept out of the persistent compile cache."""
    import jax

    from mcmtt_opticalflow_tpu import persistent_cache_off

    with persistent_cache_off():
        return tracker2d_outputs(cfg, sc, frames, steps,
                                 jax.devices("cpu")[0])


def ref_tracker2d(cfg, sc, frames, steps=5):
    """The camera-batched 2D step on the card vs the same jitted program
    on the CPU, over the first `steps` frames (the backward LK chain is
    full from frame 4 on)."""
    import jax

    card = tracker2d_outputs(cfg, sc, frames, steps, jax.devices()[0])
    ref = tracker2d_on_cpu(cfg, sc, frames, steps)
    box_err, n_live = 0.0, 0
    for t, ((mg, ig, bg), (mc, ic, bc)) in enumerate(zip(card, ref)):
        expect(np.array_equal(mg, mc), f"2D step frame {t}: live masks "
               f"differ (card {mg.sum()} vs cpu {mc.sum()})")
        expect(np.array_equal(ig[mg], ic[mc]),
               f"2D step frame {t}: tracklet ids differ")
        if mg.any():
            box_err = max(box_err, float(np.abs(bg[mg] - bc[mc]).max()))
        n_live = int(mg.sum())
    t2 = cfg.tracker2d
    tol = 0.05
    say(f"ref 2D step [{cfg.num_cameras} cams {cfg.image_width}x"
        f"{cfg.image_height}, {t2.max_trackers} trackers x "
        f"{t2.max_features} features, f32, {steps} frames]: ids equal "
        f"({n_live} live tracklets), box max err {box_err:.2e} px "
        f"(tol {tol} px)")
    expect(n_live > 0, "2D step produced no tracklets")
    expect(box_err <= tol, f"2D boxes differ by {box_err} px")


def ref_sgsmooth(win, b=1024):
    """SG smoothing on the card vs float64 numpy smoothing matrices, over
    b tracks of win frames."""
    import jax
    import jax.numpy as jnp

    from mcmtt_opticalflow_tpu.ops.sgsmooth import (sg_smooth,
                                                    sg_smooth_masked,
                                                    smoothing_matrix_np)
    rng = np.random.RandomState(1)
    span, degree = 9, 1
    data = (rng.uniform(-9000, 9000, (b, 1, 3))
            + np.cumsum(rng.normal(0, 300, (b, win, 3)), 1)
            ).astype(np.float32)
    lengths = rng.randint(1, win + 1, b).astype(np.int32)
    dev = np.asarray(jax.jit(sg_smooth_masked, static_argnums=(2, 3))(
        jnp.asarray(data), jnp.asarray(lengths), span, degree))
    ref = data.astype(np.float64).copy()
    for i, n in enumerate(lengths):
        ref[i, :n] = smoothing_matrix_np(n, span, degree) @ ref[i, :n]
    err = float(np.abs(dev - ref).max())
    one = np.asarray(jax.jit(sg_smooth, static_argnums=(1, 2))(
        jnp.asarray(data[0]), span, degree))
    err1 = float(np.abs(one - smoothing_matrix_np(win, span, degree)
                        @ data[0].astype(np.float64)).max())
    tol = 0.05
    say(f"ref SG smoothing [{b} tracks x {win} frames x 3, span {span}, "
        f"f32 at Precision.HIGHEST]: max err {err:.2e} mm batched, "
        f"{err1:.2e} mm single (tol {tol} mm vs float64)")
    expect(max(err, err1) <= tol, f"SG smoothing error {err} mm")


def ref_triangulation(sc):
    """Triangulation on the card vs the host float64 reconstruction."""
    import jax
    import jax.numpy as jnp

    from mcmtt_opticalflow_tpu.geometry.triangulation import (
        nview_ground_reconstruction, nview_point_reconstruction,
        triangulate_two_lines)
    from mcmtt_opticalflow_tpu.geometry.tsai_np import (
        HostCamera, nview_point_reconstruction_np, triangulate_two_lines_np)

    rng = np.random.RandomState(2)
    hcs = [HostCamera(c) for c in sc.cameras]
    nc, n = len(hcs), 4096
    # targets where the scene's people walk, jittered by half a metre
    xy = sc.gt_xy.reshape(-1, 2)
    xy = xy[np.isfinite(xy).all(-1)]
    ground = np.zeros((n, 3))
    ground[:, :2] = (xy[rng.randint(0, len(xy), n)]
                     + rng.normal(0, 500.0, (n, 2)))
    head = ground + [0.0, 0.0, 1700.0]
    tops = np.zeros((n, nc, 3))
    bots = np.zeros((n, nc, 3))
    feet = np.zeros((n, nc, 3))
    vis = np.zeros((n, nc), bool)
    for c, hc in enumerate(hcs):
        uv_h = hc.world_to_image(head) + rng.normal(0, 1.0, (n, 2))
        uv_f = hc.world_to_image(ground) + rng.normal(0, 1.0, (n, 2))
        tops[:, c] = hc.image_to_world(uv_h, 2000.0)
        bots[:, c] = hc.image_to_world(uv_h, 0.0)
        feet[:, c] = hc.image_to_world(uv_f, 0.0)
        vis[:, c] = hc.visible(head) & hc.visible(ground)
    mask = vis & (rng.rand(n, nc) < 0.8)
    tops, bots, feet = (a.astype(np.float32) for a in (tops, bots, feet))

    pt, md, num = (np.asarray(a) for a in jax.jit(nview_point_reconstruction)(
        jnp.asarray(tops), jnp.asarray(bots), jnp.asarray(mask)))
    rows = np.flatnonzero(num >= 2)
    p_err = d_err = 0.0
    for i in rows:
        m = mask[i]
        rp, rd = nview_point_reconstruction_np(tops[i, m], bots[i, m])
        p_err = max(p_err, float(np.abs(pt[i] - rp).max()))
        d_err = max(d_err, abs(float(md[i]) - rd))
    gp, gd, _ = (np.asarray(a) for a in jax.jit(nview_ground_reconstruction)(
        jnp.asarray(feet), jnp.asarray(mask)))
    g_err = 0.0
    for i in rows:
        f = feet[i, mask[i]].astype(np.float64)
        rp = f.mean(0)
        rd = float(np.linalg.norm(f - rp, axis=-1).mean())
        g_err = max(g_err, float(np.abs(gp[i] - rp).max()),
                    abs(float(gd[i]) - rd))
    # two-line form (the 2D tracker's height estimate): camera 0's head
    # line against the vertical through the same target's ground point
    p21 = feet[:, 0].copy()
    p22 = p21 + np.float32([0.0, 0.0, 2000.0])
    mid, gap = (np.asarray(a) for a in jax.jit(triangulate_two_lines)(
        jnp.asarray(bots[:, 0]), jnp.asarray(tops[:, 0]),
        jnp.asarray(p21), jnp.asarray(p22)))
    rmid, rgap = triangulate_two_lines_np(
        *(a.astype(np.float64) for a in (bots[:, 0], tops[:, 0], p21, p22)))
    ok = vis[:, 0]
    t_err = float(max(np.abs(mid[ok] - rmid[ok]).max(),
                      np.abs(gap[ok] - rgap[ok]).max()))
    tol = 1.0
    say(f"ref triangulation [{len(rows)} n-view targets of {n}, {nc} cams, "
        f"f32 at Precision.HIGHEST vs float64 tsai_np]: line meet max err "
        f"{p_err:.2e} mm (mean dist {d_err:.2e} mm), ground "
        f"{g_err:.2e} mm, two-line {t_err:.2e} mm (tol {tol} mm)")
    expect(len(rows) > n // 4, "too few multi-view targets")
    expect(max(p_err, d_err, g_err, t_err) <= tol,
           f"triangulation error {max(p_err, d_err, g_err, t_err)} mm")


def phase_refs(cfg, sc, frames):
    t0 = time.perf_counter()
    ref_tracker2d(cfg, sc, frames)
    a = cfg.assoc3d       # the associator's window capacity (Associator3D)
    ref_sgsmooth(max(2 * a.sg_span + 2, a.proc_window_size + a.sg_span))
    ref_triangulation(sc)
    say(f"refs: {time.perf_counter() - t0:.1f} s")


def phase_e2e(scene):
    """bench.py's run, with its hypothesis graphs recorded for the solver
    comparison on the pipeline tail's graphs."""
    import jax

    import bench
    from mcmtt_opticalflow_tpu import native

    eng = bench.bench_engine(scene[0])
    eng.assoc.graph_dump = []
    res = bench.run_bench(30, scene=scene, engine=eng)
    c = res["compile"]
    say(f"e2e compile: warmup {res['warmup_s']:.1f} s ({bench.WARMUP} "
        f"frames), precompile {res['precompile_s']:.1f} s; "
        f"{c['n']} XLA compiles, {c['seconds']:.1f} s, "
        f"{c['cache_hits']} persistent-cache hits; "
        f"{res['compiles_in_window']} compiles in the timed window")
    pf = np.asarray(res["per_frame_s"])
    say(f"e2e frames/s (finding, not a claim): median {res['fps']:.3f} "
        f"over {len(pf)} frames (p90 frame {np.percentile(pf, 90) * 1e3:.1f}"
        f" ms)")
    m = res["mota"]
    say(f"e2e MOTA w0/w3/w6: {m[0]:.4f}/{m[3]:.4f}/{m[6]:.4f}; tracks_peak "
        f"{res['tracks_peak']}; pool_dropped {res['pool_dropped']}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"e2e peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    say("e2e stage medians (ms): " + ", ".join(
        f"{k} {v}" for k, v in list(res["stage_ms"].items())[:12]))
    expect(min(m.values()) >= MOTA_FLOOR,
           f"MOTA {m} below {MOTA_FLOOR}")
    expect(res["pool_dropped"] == 0,
           f"pool_dropped {res['pool_dropped']} > 0")

    # the pipeline tail's graphs: the run's largest pools
    graphs = eng.assoc.graph_dump[-TAIL_GRAPHS:]
    expect(graphs, "no hypothesis graph recorded")
    for g in graphs:
        adj = eng.assoc.graph_adjacency(g)
        w = np.where(g["valid"], g["weights"], 0.0)
        adj &= g["valid"][:, None] & g["valid"][None, :]
        _, nat, _, _ = native.bls_mwcp_solve(w, adj, max_iterations=800,
                                             seed=3)
        dev = g["solved_score"]
        say(f"ref fused rescore_and_solve [frame {g['frame']}, "
            f"{int(g['valid'].sum())} vertices of {len(w)}, f32]: best "
            f"clique {dev:.3f} vs native BLS {nat:.3f} (ratio "
            f"{dev / nat if nat > 0 else float('nan'):.4f}, floor "
            f"{BLS_RATIO_FLOOR})")
        expect(dev >= BLS_RATIO_FLOOR * nat - 1e-4,
               f"fused solve {dev} < {BLS_RATIO_FLOOR} x native {nat}")


def phase_pipeline(cfg, sc, frames, trace_dir):
    """Pipelined == sequential over PIPELINE_FRAMES frames, bit for bit;
    the pipelined engine's steady frames WARMUP.. are traced."""
    import jax

    import bench
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu.utils.timing import device_trace_summary

    seq = TrackingEngine(cfg, sc.cameras)
    seq_res = [seq.process_frame(frames[t], sc.detections[t], frame_idx=t)
               for t in range(PIPELINE_FRAMES)]
    jax.block_until_ready(seq.state2d)
    # the pipelined engine runs alone from here, so the trace window
    # holds its frames and nothing else
    pipe = TrackingEngine(cfg, sc.cameras, pipelined=True)
    pipe_res = []
    os.makedirs(trace_dir, exist_ok=True)
    t_start = bench.WARMUP
    t_stop = t_start + TRACE_FRAMES
    for t in range(PIPELINE_FRAMES):
        if t == t_start:
            pipe.assoc.precompile()
            # python-call and per-kernel-launch host tracing would slow
            # the frame several-fold; level 1 keeps TraceAnnotations
            opts = jax.profiler.ProfileOptions()
            opts.python_tracer_level = 0
            opts.host_tracer_level = 1
            jax.profiler.start_trace(trace_dir, profiler_options=opts)
            window = jax.profiler.TraceAnnotation("smoke_trace_window")
            window.__enter__()
        r = pipe.process_frame(frames[t], sc.detections[t], frame_idx=t)
        if t == t_stop - 1:
            jax.block_until_ready(pipe.state2d)
            window.__exit__(None, None, None)
            jax.profiler.stop_trace()
        if r is not None:
            pipe_res.append(r)
    while (r := pipe.flush()) is not None:
        pipe_res.append(r)
    expect(len(pipe_res) == len(seq_res),
           f"{len(pipe_res)} pipelined vs {len(seq_res)} sequential results")
    n_tracks = 0
    for rs, rp in zip(seq_res, pipe_res):
        expect(rs.frame_idx == rp.frame_idx, "frame order differs")
        expect(rs.ids == rp.ids,
               f"frame {rs.frame_idx}: ids {rs.ids} vs {rp.ids}")
        expect(np.array_equal(np.asarray(rs.points), np.asarray(rp.points)),
               f"frame {rs.frame_idx}: points differ")
        n_tracks += len(rs.ids)
    expect(n_tracks > 0, "no tracks: the comparison is vacuous")
    say(f"pipeline: pipelined == sequential bit for bit over "
        f"{len(seq_res)} frames ({n_tracks} track outputs)")

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    expect(paths, f"no trace written under {trace_dir}")
    trips = -(-cfg.solver.max_iterations // max(cfg.solver.unroll, 1))
    s = device_trace_summary(paths[-1], ("tracker2d", "rescore_and_solve"),
                             "smoke_trace_window",
                             loop=("rescore_and_solve", trips),
                             scopes=TRACE_SCOPES)
    say(f"trace [{TRACE_FRAMES} steady frames, profiler on: "
        f"{s['window_ns'] / 1e6 / TRACE_FRAMES:.1f} ms/frame]: device busy "
        f"{s['busy_ns'] / 1e6:.1f} ms of {s['window_ns'] / 1e6:.1f} ms, "
        f"idle share {s['idle_share']:.4f}")
    for p, v in s["programs"].items():
        n = max(v["executions"], 1)
        say(f"trace {p}: {v['executions']} executions, kernel time "
            f"{v['device_ns'] / n / 1e6:.3f} ms/execution, span "
            f"{np.median(v['span_ns'] or [0]) / 1e6:.3f} ms/execution "
            f"(median), {v['kernels'] // n} kernels/execution; kernel time "
            "by scope (ms/execution): " + ", ".join(
                f"{sc} {ns / n / 1e6:.3f}" for sc, ns in v["scopes"].items()
                if ns))
    lp = s["loop"]
    if lp["span_ns"]:
        say(f"trace BLS while_loop: {np.median(lp['span_ns']) / trips / 1e3:.2f}"
            f" us/trip span, {np.median(lp['busy_ns']) / trips / 1e3:.2f} "
            f"us/trip kernel time ({trips} trips, {len(lp['span_ns'])} "
            f"solves)")
    expect(s["programs"]["tracker2d"]["executions"] > 0
           and s["programs"]["rescore_and_solve"]["executions"] > 0,
           "trace attributed no kernels to the two device programs")
    expect(lp["span_ns"], "trace found no BLS while-loop kernels")


def _bits(x):
    """dtype, shape and bytes of an array: equal iff bit for bit equal."""
    import jax

    a = np.asarray(jax.device_get(x))
    return a.dtype.str, a.shape, a.tobytes()


def _f16_step_apart(a, b):
    """Elementwise: equal, both NaN, or at most one float16 step apart."""
    a, b = a.astype(np.float16), b.astype(np.float16)
    with np.errstate(invalid="ignore"):
        step = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(
            np.float32)
        near = np.abs(a.astype(np.float32) - b.astype(np.float32)) <= step
    return (a == b) | (np.isnan(a) & np.isnan(b)) | near


def fused_diff(assoc, ra, rb, nr):
    """How two packed rescore_and_solve results for the same inputs
    differ: the window-score rows (float16 as fetched) and the K-best
    list."""
    ra, rb = np.asarray(ra), np.asarray(rb)
    wa, ma, sa = assoc.unpack_solve(ra, nr)
    wb, mb, sb = assoc.unpack_solve(rb, nr)
    rows = (ra[:nr].view(np.uint16) != rb[:nr].view(np.uint16)).any(1)
    fin = np.isfinite(wa.smoothed) & np.isfinite(wb.smoothed)
    with np.errstate(invalid="ignore"):
        wc = np.abs(wa.window_cost - wb.window_cost)
    same = (ma == mb).all(1) & (sa.view(np.uint32) == sb.view(np.uint32))
    r = int(np.argmin(same)) if not same.all() else None
    best_a, best_b = float(sa.max()), float(sb.max())
    return dict(
        equal=_bits(ra) == _bits(rb),
        rows_differ=int(rows.sum()), rows=nr,
        scores_in_f16_step=bool(_f16_step_apart(ra[:nr], rb[:nr]).all()),
        smoothed_mm=float(np.abs(wa.smoothed.astype(np.float32)
                                 - wb.smoothed.astype(np.float32))[fin]
                          .max(initial=0.0)),
        window_cost_rel=float(np.nan_to_num(
            wc / np.maximum(np.abs(wa.window_cost), 1.0)).max(initial=0.0)),
        kbest_equal=r is None, first_rank=r,
        rank_scores=None if r is None else (float(sa[r]), float(sb[r])),
        rank_elsewhere=None if r is None else bool(
            (ma == mb[r]).all(1).any()),
        best_ratio=min(best_a, best_b) / max(best_a, best_b, 1e-9))


def mesh_vs_one(cfg, scene, num_frames, devs):
    """bench.run_bench's loop on one device and on a ('cam', 'block')
    mesh over `devs`, every frame's fused rescore_and_solve recorded;
    then every frame's one-device inputs replayed through both programs.

    Returns (runs, frames): run_bench's results by "one" / "mesh", and
    per solved frame: whether the two runs fed the fused program the same
    inputs and got the same outputs, whether the one-device replay
    reproduces its run, and fused_diff of the two programs on the same
    inputs."""
    import bench
    from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine
    from mcmtt_opticalflow_tpu.parallel import make_mesh
    from mcmtt_opticalflow_tpu.parallel.mesh import fetch

    mesh = make_mesh(devices=devs)
    runs = {}
    for name, m in (("one", None), ("mesh", mesh)):
        eng = TrackingEngine(cfg, scene[0].cameras, pipelined=True, mesh=m)
        eng.assoc.graph_dump = []
        runs[name] = bench.run_bench(num_frames, scene=scene, engine=eng)
    one, four = runs["one"]["engine"], runs["mesh"]["engine"]
    dump_b = {g["frame"]: g for g in four.assoc.graph_dump}
    iters = cfg.solver.max_iterations
    frames = []
    for ga in one.assoc.graph_dump:
        t, gb = ga["frame"], dump_b.get(ga["frame"])
        ra = fetch(one.assoc.dispatch_fused(ga["fused_in"], iters))
        rb = fetch(four.assoc.dispatch_fused(ga["fused_in"], iters))
        frames.append(dict(
            frame=t, vertices=int(ga["valid"].sum()),
            same_inputs=gb is not None and all(
                _bits(x) == _bits(y)
                for x, y in zip(ga["fused_in"], gb["fused_in"])),
            same_outputs=gb is not None
            and _bits(ga["fused_out"]) == _bits(gb["fused_out"]),
            replayed=_bits(ra) == _bits(ga["fused_out"]),
            replay=fused_diff(one.assoc, ra, rb, len(ga["fused_in"][4]))))
    return runs, frames


def check_mesh_vs_one(runs, frames, num_devices):
    """mesh_vs_one's findings, one line a frame, and its checks: in every
    frame the mesh engine's tracks have the one-card ids, points within
    1 mm; the card replays each frame bit for bit; the runs' inputs part
    only after the two programs differ on the same inputs, and there by
    rounding (window scores within one float16 step, the best hypothesis
    within the solver's quality floor); the 2D state ends equal and
    sharded."""
    one, four = runs["one"]["engine"], runs["mesh"]["engine"]
    for f in frames:
        d = f["replay"]
        kb = ("K-best equal" if d["kbest_equal"] else
              f"K-best differs from rank {d['first_rank']} "
              f"({d['rank_scores'][0]:.4f} vs {d['rank_scores'][1]:.4f}, "
              f"{'reordered' if d['rank_elsewhere'] else 'another clique'})")
        say(f"four frame {f['frame']} [{f['vertices']} vertices]: runs "
            f"{'same' if f['same_inputs'] else 'DIFFERENT'} inputs, "
            f"{'same' if f['same_outputs'] else 'different'} outputs; "
            f"replay on the same inputs: "
            + ("bit-equal" if d["equal"] else
               f"{d['rows_differ']} of {d['rows']} score rows differ "
               f"(smoothed {d['smoothed_mm']:.2f} mm, window cost "
               f"{d['window_cost_rel']:.1e} rel), {kb}, best-score ratio "
               f"{d['best_ratio']:.6f}"))
    f_ctrl = next((f["frame"] for f in frames if not f["replay"]["equal"]),
                  None)
    f_in = next((f["frame"] for f in frames if not f["same_inputs"]), None)
    expect(all(f["replayed"] for f in frames),
           "replaying a frame's inputs on one card does not reproduce its "
           "run: the card is not deterministic")
    expect(f_in is None or (f_ctrl is not None and f_ctrl < f_in),
           f"the runs' inputs part at frame {f_in}, before the two programs "
           f"differ on the same inputs (frame {f_ctrl})")
    expect(all(f["replay"]["scores_in_f16_step"] for f in frames),
           "on the same inputs the mesh program's window scores differ "
           "from one card's by more than one float16 step")
    worst = min(f["replay"]["best_ratio"] for f in frames)
    expect(worst >= BLS_RATIO_FLOOR, f"on the same inputs the mesh "
           f"program's best hypothesis is {worst:.4f} of one card's")
    res_b = {r.frame_idx: r for r in four.results}
    expect(sorted(res_b) == [r.frame_idx for r in one.results],
           "the mesh engine answered other frames")
    n_tracks, p_err = 0, 0.0
    for ra in one.results:
        rb = res_b[ra.frame_idx]
        expect(ra.ids == rb.ids, f"frame {ra.frame_idx}: mesh track ids "
               f"{rb.ids} vs one card's {ra.ids}")
        if len(ra.ids):
            n_tracks += len(ra.ids)
            p_err = max(p_err, float(np.abs(np.asarray(ra.points)
                                            - np.asarray(rb.points)).max()))
    expect(n_tracks > 0, "no tracks: the comparison is vacuous")
    expect(p_err <= 1.0, f"mesh track points differ by {p_err} mm")
    sa, sb = one.state2d, four.state2d
    act = np.asarray(sa.trk_active)
    box_err = float(np.abs(np.asarray(sa.trk_boxes)[act]
                           - np.asarray(sb.trk_boxes)[act]).max(initial=0.0))
    expect(np.array_equal(act, np.asarray(sb.trk_active))
           and np.array_equal(np.asarray(sa.trk_id)[act],
                              np.asarray(sb.trk_id)[act])
           and box_err <= 0.05, "the mesh's 2D tracker state differs")
    expect(sb.frames.sharding.num_devices == num_devices,
           f"the mesh engine's 2D state is not sharded over {num_devices} "
           f"devices")
    return dict(first_replay_diff=f_ctrl, first_input_diff=f_in,
                worst_ratio=worst, box_err=box_err, n_frames=len(res_b),
                n_tracks=n_tracks, point_err=p_err)


def phase_four(device):
    """The engine on a 4-card ('cam','block') mesh vs one card over the
    whole bench run, and the replica-sharded solver vs the single-device
    solve."""
    import jax
    import jax.numpy as jnp

    import bench
    from mcmtt_opticalflow_tpu.models.mwcp import solve_mwcp
    from mcmtt_opticalflow_tpu.parallel import make_mesh, solve_mwcp_sharded

    expect(device["count"] >= 4, f"--four needs 4 cards, found "
           f"{device['count']}")
    devs = jax.devices()[:4]
    cfg = bench.bench_config()
    scene = bench.bench_scene(30)
    t0 = time.perf_counter()
    runs, frames = mesh_vs_one(cfg, scene, 30, devs)
    one, four = runs["one"]["engine"], runs["mesh"]["engine"]
    say(f"four: mesh {dict(four.mesh.shape)} over {[d.id for d in devs]}; "
        f"both runs and the replay {time.perf_counter() - t0:.1f} s")
    s = check_mesh_vs_one(runs, frames, len(devs))
    ma, mb = runs["one"]["mota"], runs["mesh"]["mota"]
    n_diff = sum(not f["replay"]["equal"] for f in frames)
    say(f"four engine [bench config, {len(scene[1])} frames]: tracks in "
        f"all {s['n_frames']} frames ({s['n_tracks']} track outputs): ids "
        f"equal, points max err {s['point_err']:.2e} mm (tol 1 mm); 2D "
        f"tracker state equal at the end (boxes {s['box_err']:.2e} px, tol "
        f"0.05); on the same inputs the two fused programs agree bit for "
        f"bit in {len(frames) - n_diff} of {len(frames)} frames, else "
        f"within one float16 step in the window scores, best-score ratio "
        f">= {s['worst_ratio']:.6f} (floor {BLS_RATIO_FLOOR}); first "
        f"replay difference at frame {s['first_replay_diff']}, the runs' "
        f"inputs part at frame {s['first_input_diff']}")
    say(f"four MOTA w0/w3/w6: one card {ma[0]:.4f}/{ma[3]:.4f}/{ma[6]:.4f}, "
        f"mesh {mb[0]:.4f}/{mb[3]:.4f}/{mb[6]:.4f}; pool_dropped one card "
        f"{runs['one']['pool_dropped']}, mesh {runs['mesh']['pool_dropped']}"
        f"; frames/s (finding) one card {runs['one']['fps']:.3f}, mesh "
        f"{runs['mesh']['fps']:.3f}")
    expect(min(mb.values()) >= MOTA_FLOOR, f"mesh MOTA {mb} below "
           f"{MOTA_FLOOR}")
    expect(runs["mesh"]["pool_dropped"] == 0, "mesh pool_dropped > 0")

    g = max(one.assoc.graph_dump, key=lambda g: g["valid"].sum())
    smesh = make_mesh(num_cam_shards=1, devices=devs)      # block = 4
    scfg = cfg.solver
    key = jax.random.PRNGKey(7)
    args = (jnp.asarray(g["weights"]),
            jnp.asarray(one.assoc.graph_adjacency(g)),
            jnp.asarray(g["valid"]), jnp.zeros(len(g["weights"]), bool))
    iters = scfg.max_iterations
    mask, score, _, all_scores = solve_mwcp_sharded(*args, key, smesh, scfg,
                                                    iters=iters)
    all_scores = np.asarray(all_scores).reshape(4, -1)
    keys = jax.random.split(key, 4)
    n_equal, worst = 0, 1.0
    for b in range(4):
        single = np.asarray(solve_mwcp(*args, keys[b], scfg,
                                       iters).best_score)
        n_equal += int(np.array_equal(single, all_scores[b]))
        # a shard's replicas are the single-device solve's replicas; where
        # rounding sends a search elsewhere, its best holds the floor
        hi, lo = max(single.max(), all_scores[b].max()), \
            min(single.max(), all_scores[b].max())
        worst = min(worst, lo / hi if hi > 0 else 1.0)
    expect(worst >= BLS_RATIO_FLOOR, f"a shard's best is {worst:.4f} of "
           f"the single-device solve with its key")
    w = np.asarray(g["weights"])
    m = np.asarray(mask)
    expect(abs(float(score) - float(w[m].sum())) <= 1e-2 * max(1.0,
                                                                abs(score)),
           "sharded best score does not match its clique")
    expect(float(score) >= all_scores.max() - 1e-3,
           "collective argmax missed the best shard")
    say(f"four solver [{int(g['valid'].sum())} vertices, "
        f"{scfg.num_replicas} replicas x 4 shards]: "
        f"{n_equal} of 4 shards equal the single-device solve with their "
        f"key bit for bit, worst best-score ratio {worst:.4f} (floor "
        f"{BLS_RATIO_FLOOR}); collective best {float(score):.3f} matches "
        f"its clique and the best shard")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the pipeline phase's trace here (default: "
                         "a temporary directory, removed at the end)")
    args = ap.parse_args(argv)

    import mcmtt_opticalflow_tpu as pkg
    from mcmtt_opticalflow_tpu.utils.device import NoGpuError

    here_pkg = os.path.join(HERE, "mcmtt_opticalflow_tpu")
    if os.path.dirname(os.path.abspath(pkg.__file__)) != here_pkg:
        print(f"chip_smoke: the package next to this script is missing "
              f"(imported {pkg.__file__})", file=sys.stderr)
        return 2
    try:
        device = phase_device()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.four:
        phase_four(device)
        device = dict(device, count=4)
    else:
        import bench

        cfg = bench.bench_config()
        scene = bench.bench_scene(30)
        sc, frames = scene
        phase_refs(cfg, sc, frames)
        phase_e2e(scene)
        if args.trace_dir:
            phase_pipeline(cfg, sc, frames, args.trace_dir)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                phase_pipeline(cfg, sc, frames, tmp)
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(last_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
