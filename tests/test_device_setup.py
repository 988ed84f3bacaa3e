"""What runs before and around the device programs: the compile cache's
place (and the CPU references kept out of it), the matmul precision of
the mm-scale contractions, chip_smoke.py's comparisons at small sizes,
the scripts' refusal to measure without a GPU, and the trace reduction
that turns a profiler trace into device metrics."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

import mcmtt_opticalflow_tpu as pkg
from mcmtt_opticalflow_tpu.config import SolverConfig
from mcmtt_opticalflow_tpu.geometry.triangulation import (
    nview_point_reconstruction)
from mcmtt_opticalflow_tpu.models.mwcp import solve_mwcp
from mcmtt_opticalflow_tpu.ops.sgsmooth import sg_smooth, sg_smooth_masked
from mcmtt_opticalflow_tpu.utils.device import NoGpuError, require_gpu
from mcmtt_opticalflow_tpu.utils.timing import device_trace_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

class TestCompileCache:
    def test_env_dir_set_means_no_dir_from_code(self):
        assert pkg.compile_cache_dir(
            {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None

    def test_env_unset_gives_in_checkout_dir(self):
        d = pkg.compile_cache_dir({})
        assert d == os.path.join(REPO, ".jax_cache")
        assert pkg.compile_cache_dir({"JAX_PLATFORMS": "cuda"}) == d

    def test_cpu_runs_stay_out(self):
        assert pkg.compile_cache_dir({"JAX_PLATFORMS": "cpu"}) is None
        # this test process is pinned to the CPU: nothing was set
        assert not jax.config.jax_compilation_cache_dir or \
            os.environ.get("JAX_COMPILATION_CACHE_DIR")

    def test_cache_off_context_reads_and_writes_nothing(self, live_cache):
        with pkg.persistent_cache_off():
            jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(7)).block_until_ready()
        assert _entries(live_cache) == []
        # the cache is live again after the context
        jax.jit(lambda x: x * 5.0 - 2.0)(jnp.ones(7)).block_until_ready()
        assert _entries(live_cache)

    def test_cpu_half_of_2d_reference_stays_out(self, live_cache,
                                                small_2d_scene):
        outs = chip_smoke.tracker2d_on_cpu(*small_2d_scene, steps=2)
        assert len(outs) == 2
        assert _entries(live_cache) == []


@pytest.fixture
def live_cache(tmp_path):
    """JAX's persistent cache in an empty directory, keeping every
    compile; the process's own settings come back afterwards."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    keys = ("jax_compilation_cache_dir", "jax_enable_compilation_cache",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    cc.reset_cache()
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    yield tmp_path
    for k, v in old.items():
        jax.config.update(k, v)
    cc.reset_cache()


def _entries(d):
    return sorted(p for p in os.listdir(d)
                  if os.path.isfile(os.path.join(d, p)))


# ---------------------------------------------------------------------------
# chip_smoke's comparisons, run on the CPU at small sizes
# ---------------------------------------------------------------------------

class TestSmokeReferencesOnCpu:
    def test_ref_tracker2d(self, small_2d_scene, capsys):
        chip_smoke.ref_tracker2d(*small_2d_scene)
        assert "ids equal" in capsys.readouterr().out

    def test_ref_sgsmooth(self, capsys):
        chip_smoke.ref_sgsmooth(20, b=64)
        assert "SG smoothing" in capsys.readouterr().out

    def test_f16_step_rule(self):
        a = np.float16([1024.0, 1.0, np.nan, 3.0])
        b = np.float16([1025.0, 1.0, np.nan, 3.002])
        # one f16 step is 1.0 at 1024 and 2**-9 at 3
        assert chip_smoke._f16_step_apart(a, b).all()
        assert not chip_smoke._f16_step_apart(np.float16([1024.0]),
                                              np.float16([1026.0])).any()


# ---------------------------------------------------------------------------
# matmul precision
# ---------------------------------------------------------------------------

def _dot_precisions(jaxpr):
    """precision params of every dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _all_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no dot_general found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi for q in (
            p if isinstance(p, tuple) else (p,))), precs
    return len(precs)


class TestMatmulPrecision:
    def test_sg_smoothing_dots_highest(self):
        assert _all_highest(lambda x: sg_smooth(x), jnp.ones((12, 3))) == 1
        assert _all_highest(lambda x, n: sg_smooth_masked(x, n),
                            jnp.ones((4, 12, 3)),
                            jnp.full((4,), 7, jnp.int32)) == 1

    def test_triangulation_dots_highest(self):
        a = jnp.ones((5, 3, 3))
        assert _all_highest(nview_point_reconstruction, a, a + 1.0,
                            jnp.ones((5, 3), bool)) >= 2

    def test_bls_matvecs_highest(self):
        v = 8
        cfg = SolverConfig(num_replicas=2, max_vertices=v,
                           solutions_per_replica=2)
        n = _all_highest(
            lambda w, a: solve_mwcp(w, a, jnp.ones((v,), bool),
                                    jnp.zeros((v,), bool),
                                    jax.random.PRNGKey(0), cfg, 4),
            jnp.ones((v,)), jnp.zeros((v, v), bool))
        assert n >= 3


# ---------------------------------------------------------------------------
# no measurement without a GPU
# ---------------------------------------------------------------------------

class TestNoGpuRefusal:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(NoGpuError, match="no GPU found"):
            require_gpu()

    def test_chip_smoke_exits_nonzero_without_result(self, capsys):
        assert chip_smoke.main([]) != 0
        out = capsys.readouterr().out
        assert '"ok"' not in out

    def test_bench_exits_nonzero_without_result(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                           env=env, capture_output=True, text=True,
                           timeout=300, cwd=REPO)
        assert r.returncode != 0
        assert "no GPU found" in r.stderr
        assert r.stdout.strip() == ""

    def test_last_line_is_the_contract(self):
        line = chip_smoke.last_line(
            {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
             "count": 1, "extra": "dropped"})
        assert line == ('{"ok": true, "device": {"platform": "gpu", '
                        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
        assert json.loads(line)["device"]["count"] == 1


# ---------------------------------------------------------------------------
# trace reduction
# ---------------------------------------------------------------------------

def _kernel(name_id, start_us, dur_us, module_stat, scope=""):
    stats = (f"stats {{ metadata_id: 1 str_value: \"{module_stat}\" }}"
             if module_stat else "")
    if scope:
        stats += f" stats {{ metadata_id: 2 str_value: \"{scope}\" }}"
    return (f"events {{ metadata_id: {name_id} offset_ps: "
            f"{int(start_us * 1e6)} duration_ps: {int(dur_us * 1e6)} "
            f"{stats} }}")


def _trace():
    """Window [10, 110) us on the host; on the device a 2D step (two
    kernels), then a solve whose loop kernel 'body' runs 3 trips around
    a one-off 'init', a copy without a module, a second solve, and a
    kernel that ends after the window."""
    lk = "jit(tracker2d)/vmap(tracker2d)/jit(lk_track_points)/mul"
    ev = [_kernel(1, 8, 5, "jit_tracker2d"),         # starts outside
          _kernel(2, 13, 5, "jit_tracker2d", lk),
          _kernel(3, 20, 2, "jit_rescore_and_solve"),   # init
          _kernel(4, 22, 2, "jit_rescore_and_solve"),   # body x3
          _kernel(4, 26, 2, "jit_rescore_and_solve"),
          _kernel(5, 28, 1, ""),                        # memcpy
          _kernel(4, 30, 2, "jit_rescore_and_solve"),
          _kernel(2, 40, 10, "jit_tracker2d", lk),
          _kernel(3, 60, 2, "jit_rescore_and_solve"),
          _kernel(4, 62, 2, "jit_rescore_and_solve"),
          _kernel(4, 64, 2, "jit_rescore_and_solve"),
          _kernel(4, 66, 2, "jit_rescore_and_solve"),
          _kernel(2, 105, 10, "jit_tracker2d")]          # half outside
    meta = "".join(
        f"event_metadata {{ key: {i} value {{ id: {i} name: \"{n}\" }} }}"
        for i, n in enumerate(["k2d_a", "k2d_b", "init", "body", "memcpy"],
                              start=1))
    return f"""
planes {{ id: 1 name: "/host:CPU"
  lines {{ id: 1 name: "python" timestamp_ns: 0
    events {{ metadata_id: 1 offset_ps: 10000000 duration_ps: 100000000 }} }}
  event_metadata {{ key: 1 value {{ id: 1 name: "win" }} }} }}
planes {{ id: 2 name: "/device:GPU:0"
  lines {{ id: 1 name: "Stream #13(Compute)" timestamp_ns: 0
    {" ".join(ev)} }}
  lines {{ id: 2 name: "XLA Ops" timestamp_ns: 0
    {_kernel(2, 40, 10, "jit_tracker2d")} }}
  {meta}
  stat_metadata {{ key: 1 value {{ id: 1 name: "hlo_module" }} }}
  stat_metadata {{ key: 2 value {{ id: 2 name: "name" }} }} }}
"""


class TestTraceSummary:
    def test_programs_loop_and_idle_share(self):
        from jax.profiler import ProfileData

        s = device_trace_summary(ProfileData.from_text_proto(_trace()),
                                 ("tracker2d", "rescore_and_solve"), "win",
                                 loop=("rescore_and_solve", 3))
        assert s["window_ns"] == pytest.approx(100_000)
        # busy: [10,18)+[20,24)+[26,29)+[30,32)+[40,50)+[60,68)+[105,110)
        assert s["busy_ns"] == pytest.approx(40_000)
        assert s["idle_share"] == pytest.approx(0.6)
        t2d = s["programs"]["tracker2d"]
        assert t2d["executions"] == 3          # split by the solves
        assert t2d["device_ns"] == pytest.approx(23_000)
        sol = s["programs"]["rescore_and_solve"]
        assert sol["executions"] == 2          # the memcpy splits nothing
        assert sol["device_ns"] == pytest.approx(16_000)
        assert sol["span_ns"] == pytest.approx([12_000, 8_000])
        assert s["loop"]["span_ns"] == pytest.approx([10_000, 6_000])
        assert s["loop"]["busy_ns"] == pytest.approx([6_000, 6_000])

    def test_scope_kernel_time(self):
        from jax.profiler import ProfileData

        s = device_trace_summary(ProfileData.from_text_proto(_trace()),
                                 ("tracker2d", "rescore_and_solve"), "win",
                                 scopes=("lk_track_points", "absent"))
        t2d = s["programs"]["tracker2d"]["scopes"]
        assert t2d["lk_track_points"] == pytest.approx(15_000)
        assert t2d["absent"] == 0.0
        assert s["programs"]["rescore_and_solve"]["scopes"][
            "lk_track_points"] == 0.0

    def test_missing_window_raises(self):
        from jax.profiler import ProfileData

        with pytest.raises(ValueError, match="no host annotation"):
            device_trace_summary(ProfileData.from_text_proto(_trace()),
                                 ("tracker2d",), "absent")
