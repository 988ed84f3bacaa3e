"""Solver quality on RECORDED hypothesis graphs: the engine dumps every
frame's real compatibility instance (weights + adjacency + warm starts),
and the device replica-BLS K-best is certified against brute force (small
graphs) and the native C++ serial BLS cross-check (ref GraphSolver.cpp:
532-669 is the behaviour both reimplement independently)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmtt_opticalflow_tpu.config import (EngineConfig, SolverConfig,
                                          Tracker2DConfig)
from mcmtt_opticalflow_tpu.data import make_scenario
from mcmtt_opticalflow_tpu.models.mwcp import solve_mwcp, collect_k_best
from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine
from mcmtt_opticalflow_tpu import native


def brute_force_mwc(weights, adj, valid):
    """Exact max-weight clique by subset enumeration over valid vertices."""
    idx = np.where(valid)[0]
    best, best_set = 0.0, frozenset()
    adj = np.asarray(adj)
    w = np.asarray(weights)

    def extend(cur, cand, score):
        nonlocal best, best_set
        if score > best:
            best, best_set = score, frozenset(cur)
        for k, v in enumerate(cand):
            rest = [u for u in cand[k + 1:] if adj[v, u]]
            # bound: even taking every remaining candidate can't win
            if score + w[v] + sum(w[u] for u in rest if w[u] > 0) <= best:
                continue
            extend(cur + [v], rest, score + w[v])

    extend([], list(idx), 0.0)
    return best_set, best


@pytest.fixture(scope="module")
def recorded_graphs():
    """Run the engine on a dense synthetic scene and record every frame's
    hypothesis graph."""
    sc = make_scenario(num_cameras=3, num_frames=14, num_people=6,
                       image_size=(192, 144), arena=5000.0,
                       fp_rate=0.1, fn_rate=0.05, seed=11)
    cfg = EngineConfig(
        num_cameras=3, image_width=192, image_height=144,
        tracker2d=Tracker2DConfig(max_detections=16, max_trackers=32,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=4, max_vertices=128,
                            solutions_per_replica=8, max_iterations=150))
    eng = TrackingEngine(cfg, sc.cameras)
    eng.assoc.graph_dump = []
    for t in range(14):
        frames = (np.clip(np.stack(sc.frames(t)), 0, 1) * 255).astype(
            np.uint8)
        eng.process_frame(frames, sc.detections[t], frame_idx=t)
    graphs = [g for g in eng.assoc.graph_dump if g["valid"].sum() >= 3]
    assert graphs, "engine recorded no non-trivial hypothesis graphs"
    for g in graphs:
        g["adj"] = eng.assoc.graph_adjacency(g)
    return graphs, cfg.solver


class TestSolverQualityOnRecordedGraphs:
    def test_device_matches_brute_force(self, recorded_graphs):
        """Device K-best top score >= 0.99x the exact optimum on every
        recorded graph small enough to enumerate."""
        graphs, scfg = recorded_graphs
        checked = 0
        for g in graphs:
            nv = int(g["valid"].sum())
            if nv > 18:
                continue
            _, exact = brute_force_mwc(g["weights"], g["adj"], g["valid"])
            if exact <= 0:
                continue
            res = solve_mwcp(jnp.asarray(g["weights"]),
                             jnp.asarray(g["adj"]),
                             jnp.asarray(g["valid"]),
                             jnp.zeros_like(jnp.asarray(g["valid"])),
                             jax.random.PRNGKey(0), scfg, 150)
            got = float(np.asarray(res.best_score).max())
            assert got >= 0.99 * exact - 1e-4, (g["frame"], got, exact)
            checked += 1
        assert checked > 0, "no recorded graph was brute-forceable"

    def test_device_k_best_matches_native(self, recorded_graphs):
        """Device replica K-best and the native serial BLS agree on the
        best clique score (ratio >= 0.99 both ways) on real instances."""
        if not native.available():
            pytest.skip("native library not built")
        graphs, scfg = recorded_graphs
        ratios = []
        for g in graphs:
            res = solve_mwcp(jnp.asarray(g["weights"]),
                             jnp.asarray(g["adj"]),
                             jnp.asarray(g["valid"]),
                             jnp.zeros_like(jnp.asarray(g["valid"])),
                             jax.random.PRNGKey(1), scfg, 150)
            dev = float(np.asarray(res.best_score).max())
            w = np.where(g["valid"], g["weights"], 0.0)
            _, nat, _, _ = native.bls_mwcp_solve(
                w, g["adj"] & g["valid"][:, None] & g["valid"][None, :],
                max_iterations=800, seed=3)
            if max(dev, nat) <= 0:
                continue
            ratios.append(min(dev, nat) / max(dev, nat))
            assert dev >= 0.99 * nat - 1e-4, (g["frame"], dev, nat)
        assert ratios, "no scoreable graphs"

    def test_warm_started_k_best_cliques_valid(self, recorded_graphs):
        """With the engine's real warm starts, every returned solution is
        a clique over valid vertices."""
        graphs, scfg = recorded_graphs
        g = max(graphs, key=lambda g: g["valid"].sum())
        import dataclasses
        k = len(g["init_masks"])
        cfg = dataclasses.replace(scfg,
                                  num_replicas=scfg.num_replicas + k)
        init = np.zeros((cfg.num_replicas, len(g["weights"])), bool)
        init[:k] = g["init_masks"]
        res = solve_mwcp(jnp.asarray(g["weights"]), jnp.asarray(g["adj"]),
                         jnp.asarray(g["valid"]), jnp.asarray(init),
                         jax.random.PRNGKey(2), cfg, 150)
        masks, scores = collect_k_best(res, 10)
        adj = np.asarray(g["adj"])
        found = 0
        for m, s in zip(masks, scores):
            members = np.where(m)[0]
            if not len(members):
                continue
            found += 1
            assert g["valid"][members].all()
            for a in members:
                for b in members:
                    assert a == b or adj[a, b]
        assert found > 0
