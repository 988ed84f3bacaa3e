"""Multi-device sharding tests on the virtual 8-CPU mesh: camera-parallel
2D stage, block-sharded solver with collective K-best, dryrun entry."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmtt_opticalflow_tpu.parallel import (make_mesh, cam_sharding,
                                            block_sharding,
                                            solve_mwcp_sharded)
from mcmtt_opticalflow_tpu.parallel.mesh import shard_leaves
from mcmtt_opticalflow_tpu.config import SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


class TestMesh:
    def test_mesh_shape(self):
        mesh = make_mesh()
        assert mesh.shape["cam"] * mesh.shape["block"] == 8
        assert mesh.shape["cam"] == 4

    def test_cam_sharded_array(self):
        mesh = make_mesh()
        x = jax.device_put(jnp.ones((4, 16)), cam_sharding(mesh))
        y = jax.jit(lambda a: a * 2)(x)
        assert y.sharding.is_equivalent_to(cam_sharding(mesh), 2)


class TestShardedSolver:
    def test_matches_quality(self, rng):
        mesh = make_mesh()
        cfg = SolverConfig(num_replicas=2, max_vertices=32,
                           solutions_per_replica=4)
        v = 32
        weights = jnp.asarray(rng.rand(v).astype(np.float32))
        adj = rng.rand(v, v) < 0.6
        adj = jnp.asarray(np.triu(adj, 1) | np.triu(adj, 1).T)
        valid = jnp.ones((v,), bool)
        init = jnp.zeros((v,), bool)
        mask, score, all_masks, all_scores = solve_mwcp_sharded(
            weights, adj, valid, init, jax.random.PRNGKey(1), mesh, cfg,
            iters=100)
        mask = np.asarray(mask)
        # result is a clique and score matches the mask
        members = np.where(mask)[0]
        adj_np = np.asarray(adj)
        for a in members:
            for b in members:
                if a != b:
                    assert adj_np[a, b]
        assert float(score) == pytest.approx(
            float(np.asarray(weights)[mask].sum()), abs=1e-3)
        # collective argmax picked the max of the gathered shard bests
        assert float(score) >= float(np.asarray(all_scores).max()) - 1e-3


def _small_cfg():
    from mcmtt_opticalflow_tpu.config import EngineConfig, Tracker2DConfig
    return EngineConfig(
        num_cameras=4, image_width=128, image_height=96,
        tracker2d=Tracker2DConfig(max_detections=8, max_trackers=16,
                                  max_features=16, lk_window=8,
                                  lk_pyramid_levels=2, lk_iterations=4),
        solver=SolverConfig(num_replicas=2, max_vertices=64,
                            solutions_per_replica=4, max_iterations=100,
                            solve_batch=8))


class TestEngineOnMesh:
    """The PRODUCTION engine running SPMD on the ('cam','block') mesh —
    camera-sharded 2D stage + all-device-sharded fused rescore/compat/
    solve — must agree with the single-device run."""

    def _build(self, sc, mesh):
        from mcmtt_opticalflow_tpu.models.pipeline import TrackingEngine
        return TrackingEngine(_small_cfg(), sc.cameras, mesh=mesh)

    def test_engine_parity_on_mesh(self):
        from mcmtt_opticalflow_tpu.data import make_scenario
        sc = make_scenario(num_cameras=4, num_frames=12, num_people=4,
                           image_size=(128, 96), arena=3000.0, seed=5)
        mesh = make_mesh()
        ea = self._build(sc, None)
        eb = self._build(sc, mesh)
        saw_tracks = False
        for t in range(12):
            frames = np.stack(sc.frames(t))
            ra = ea.process_frame(frames, sc.detections[t], frame_idx=t)
            rb = eb.process_frame(frames, sc.detections[t], frame_idx=t)
            assert ra.ids == rb.ids, f"frame {t}: {ra.ids} vs {rb.ids}"
            if len(ra.ids):
                saw_tracks = True
                np.testing.assert_allclose(ra.points, rb.points, atol=1.0)
        assert saw_tracks, "scenario produced no tracks - test is vacuous"
        # the sharded run really used the mesh
        assert eb.mesh is mesh and eb.assoc.mesh is mesh
        assert eb.state2d.frames.sharding.is_equivalent_to(
            cam_sharding(mesh), eb.state2d.frames.ndim)

    def test_fused_program_sums_on_one_device(self):
        """On a 4-device mesh the fused rescore+solve program moves data
        between devices but reduces nothing across them (no all-reduce),
        and its loops (the BLS search, the greedy clique) hold no
        collective: its f32 sums add in the one-device order."""
        import re

        from mcmtt_opticalflow_tpu.data import make_scenario
        from mcmtt_opticalflow_tpu.models.associator3d import Associator3D
        sc = make_scenario(num_cameras=4, num_frames=2, num_people=2,
                           image_size=(128, 96), arena=3000.0, seed=5)
        cfg = _small_cfg()
        a = Associator3D(cfg, sc.cameras,
                         mesh=make_mesh(devices=jax.devices()[:4]))
        hlo = a._rescore_and_solve.lower(
            *a.fused_args(a.zero_fused_inputs(64, 64)),
            iters=cfg.solver.max_iterations).compile().as_text()
        coll = r"\b(all-reduce|all-gather|all-to-all|collective-permute" \
               r"|reduce-scatter)(-start)?\("
        assert re.search(coll, hlo), "the program is not partitioned"
        assert not re.search(r"\ball-reduce(-start)?\(", hlo)
        bodies = set(re.findall(r"while\(.*?body=(%[\w.\-]+)", hlo))
        assert bodies
        for comp in re.split(r"\n(?=\S.*\{\n)", hlo):
            if comp.split(" ", 1)[0] in bodies:
                assert not re.search(coll, comp), comp.split(" ", 1)[0]

    def test_mesh_vs_one_over_a_bench_run(self):
        """chip_smoke --four's path at a small size on 4 of the virtual
        devices: both pipelined engines through bench.run_bench, every
        frame's fused program replayed on both, the checks passing."""
        from mcmtt_opticalflow_tpu.data import make_scenario
        sys.path.insert(0, REPO)
        import bench
        import chip_smoke

        num_frames = 5
        sc = make_scenario(num_cameras=4,
                           num_frames=num_frames + bench.WARMUP,
                           num_people=4, image_size=(128, 96), arena=3000.0,
                           seed=5)
        frames = [(np.clip(np.stack(sc.frames(t)), 0, 1) * 255 + 0.5)
                  .astype(np.uint8) for t in range(len(sc.detections))]
        runs, per = chip_smoke.mesh_vs_one(
            _small_cfg(), (sc, frames), num_frames, jax.devices()[:4])
        s = chip_smoke.check_mesh_vs_one(runs, per, 4)
        assert [f["frame"] for f in per] == list(range(len(frames)))
        assert all(f["replayed"] for f in per)
        assert s["worst_ratio"] >= chip_smoke.BLS_RATIO_FLOOR
        assert runs["mesh"]["engine"].mesh.shape["cam"] == 4
        assert runs["mesh"]["mota"] == runs["one"]["mota"]


class TestDryrun:
    def test_dryrun_multichip(self, capsys):
        sys.path.insert(0, REPO)
        import __graft_entry__ as g
        g.dryrun_multichip(8)
        out = capsys.readouterr().out
        assert "dryrun_multichip ok" in out
        assert "'cam': 4" in out
