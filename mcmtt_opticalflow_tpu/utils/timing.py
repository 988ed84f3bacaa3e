"""Per-stage timing + device profiling hooks.

Replaces the reference's clock() wall-timing scattered through the pipeline
(ref psn_where/PSNWhere.cpp:248-279; PSNWhere_Associator3D.cpp:446-488;
GraphSolver.cpp:535,663-668) with a structured stage timer, and exposes
jax.profiler tracing plus the reduction of a device trace to per-program
device times and the device's idle share.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Sequence, Tuple


class StageTimer:
    """Accumulates wall time per named stage across frames."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.samples[name].append(dt)

    def push(self, name: str) -> None:
        """Open a stage without lexical scoping (close with pop())."""
        if not hasattr(self, "_open"):
            self._open: List = []
        self._open.append((name, time.perf_counter()))

    def pop(self) -> None:
        name, t0 = self._open.pop()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.samples[name].append(dt)

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            n = self.counts[name]
            tot = self.totals[name]
            med = sorted(self.samples[name])[n // 2] if n else 0.0
            lines.append(f"{name:30s} total={tot:8.3f}s "
                         f"mean={tot / max(n, 1) * 1e3:8.2f}ms "
                         f"med={med * 1e3:8.2f}ms n={n}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.samples.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class CompileCounter:
    """Counts XLA backend compiles, their seconds, and persistent-cache
    hits in this process from the moment it is created (jax.monitoring
    listeners; a cache hit still counts as a compile, of near-zero
    seconds)."""

    _COMPILE = "/jax/core/compile/backend_compile_duration"
    _HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        import jax

        self.n = 0
        self.seconds = 0.0
        self.cache_hits = 0

        def on_duration(event, secs, **_):
            if event == self._COMPILE:
                self.n += 1
                self.seconds += secs

        def on_event(event, **_):
            if event == self._HIT:
                self.cache_hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    def snapshot(self) -> Dict[str, float]:
        return {"n": self.n, "seconds": self.seconds,
                "cache_hits": self.cache_hits}


# Lines that the profiler derives from others on a device plane: their
# events repeat the kernels' time, so busy time never counts them.
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "XLA TraceMe",
                  "TensorFlow Ops", "TensorFlow Name Scope", "Source code",
                  "Framework Ops", "Framework Name Scope", "Launch Stats")


def _event_stats(ev) -> Dict[str, object]:
    return {k: v for k, v in ev.stats}


def _union_ns(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_trace_summary(trace, programs: Sequence[str], window: str,
                         loop: Tuple[str, int] = None,
                         scopes: Sequence[str] = ()) -> dict:
    """Reduce a jax.profiler trace (an .xplane.pb path or a
    jax.profiler.ProfileData) to device metrics over one window.

    window: name of a host TraceAnnotation that brackets the window; the
    device events are clipped to its span.  programs: jit function names;
    XLA keeps `jit_<name>` as the module name that every kernel of the
    program carries (the `hlo_module` stat).  loop: (program, trips) of
    a while-loop to time per trip: its kernels are those whose name
    repeats a multiple of `trips` times in one execution of the program
    (kernels outside the loop run once, or a number of times set by
    another loop's trip count).  scopes: name scopes to attribute
    kernel time to; a kernel belongs to every scope that its `name`
    stat (the op's scope path, e.g. `jit(tracker2d)/.../jit(lk_track_
    points)/...`) contains.

    Returns {"window_ns", "busy_ns", "idle_share", "programs": {name:
    {"device_ns", "kernels", "executions", "span_ns", "scopes": {scope:
    device_ns}}}, "loop": {"trips", "span_ns", "busy_ns"}}.  busy is the union of the device's kernel,
    copy and memset intervals, idle_share = 1 - busy / window; a
    program's device_ns sums its kernels' durations; an execution is a
    run of the program's kernels that no other program's kernel
    interrupts, and span_ns lists each execution's first-to-last extent
    (loop: of the loop's kernels only; busy_ns sums their durations)."""
    from jax.profiler import ProfileData

    pd = (ProfileData.from_file(trace) if isinstance(trace, str)
          else trace)
    w0 = w1 = None
    for plane in pd.planes:
        if not plane.name.startswith("/host:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if ev.name == window:
                    w0, w1 = ev.start_ns, ev.end_ns
    if w0 is None:
        raise ValueError(f"no host annotation {window!r} in the trace")
    busy, kernels = [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:") or "CPU" in plane.name:
            continue
        for line in plane.lines:
            if line.name in _DERIVED_LINES:
                continue
            for ev in line.events:
                s, e = max(ev.start_ns, w0), min(ev.end_ns, w1)
                if e <= s:
                    continue
                busy.append((s, e))
                stats = _event_stats(ev)
                module = stats.get("hlo_module")
                if module:
                    kernels.append((s, e, str(module), ev.name,
                                    str(stats.get("name", ""))))
    kernels.sort()
    # executions: maximal runs of one module's kernels in device order
    runs: Dict[str, list] = defaultdict(list)
    prev = None
    for k in kernels:
        if k[2] != prev:
            runs[k[2]].append([])
            prev = k[2]
        runs[k[2]][-1].append(k)
    window_ns = float(w1 - w0)
    busy_ns = _union_ns(busy)
    out = {"window_ns": window_ns, "busy_ns": busy_ns,
           "idle_share": 1.0 - busy_ns / window_ns if window_ns else 0.0,
           "programs": {}, "loop": {}}
    for p in programs:
        execs = runs.get(f"jit_{p}", [])
        out["programs"][p] = {
            "device_ns": float(sum(e - s for r in execs
                                   for s, e, *_ in r)),
            "kernels": sum(len(r) for r in execs),
            "executions": len(execs),
            "span_ns": [float(r[-1][1] - r[0][0]) for r in execs],
            "scopes": {sc: float(sum(k[1] - k[0] for r in execs for k in r
                                     if sc in k[4])) for sc in scopes}}
    if loop is not None:
        prog, trips = loop
        spans, busies = [], []
        for r in runs.get(f"jit_{prog}", []):
            count: Dict[str, int] = defaultdict(int)
            for k in r:
                count[k[3]] += 1
            body = [k for k in r if count[k[3]] % trips == 0]
            if body:
                spans.append(float(max(e for _, e, *_ in body)
                                   - min(s for s, *_ in body)))
                busies.append(float(sum(e - s for s, e, *_ in body)))
        out["loop"] = {"trips": trips, "span_ns": spans, "busy_ns": busies}
    return out
