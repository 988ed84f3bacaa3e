"""Device programs on the card against the same programs on the CPU or a
float64 reference, through chip_smoke.py's comparisons at small sizes.
Marked `gpu`: they skip without a card; on the card run
`MCMTT_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu -q`."""

import os
import sys

import jax
import numpy as np
import pytest

from mcmtt_opticalflow_tpu import persistent_cache_off
from mcmtt_opticalflow_tpu.config import SolverConfig
from mcmtt_opticalflow_tpu.models.mwcp import solve_mwcp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def _on(x, dev):
    return jax.device_put(x, dev)


def test_tracker2d_step_matches_cpu(gpu, small_2d_scene):
    chip_smoke.ref_tracker2d(*small_2d_scene)


def test_sg_smoothing_highest_precision_on_card(gpu):
    # f32 rounding at 1e4 mm is ~1e-3 mm; TF32 would be ~5 mm
    chip_smoke.ref_sgsmooth(20, b=256)


def test_solver_matches_cpu(gpu):
    rng = np.random.RandomState(1)
    v = 64
    cfg = SolverConfig(num_replicas=4, max_vertices=v,
                       solutions_per_replica=8)
    adj = rng.rand(v, v) < 0.5
    adj = np.triu(adj, 1) | np.triu(adj, 1).T
    args = (rng.rand(v).astype(np.float32) * 100.0, adj, np.ones(v, bool),
            np.zeros(v, bool))
    cpu = jax.devices("cpu")[0]

    def solve(d):
        return solve_mwcp(*(_on(a, d) for a in args),
                          _on(jax.random.PRNGKey(0), d), cfg, 100)

    res = {gpu: solve(gpu)}
    with persistent_cache_off():
        res[cpu] = solve(cpu)
    np.testing.assert_allclose(np.asarray(res[gpu].best_score),
                               np.asarray(res[cpu].best_score), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(res[gpu].best_mask),
                                  np.asarray(res[cpu].best_mask))
