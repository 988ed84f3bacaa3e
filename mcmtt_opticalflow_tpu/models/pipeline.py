"""Top-level tracking engine — the redesign of the reference orchestrator
CPSNWhere (psn_where/PSNWhere.h:11-57, PSNWhere.cpp:243-283).

Per frame:
  1. camera-batched 2D tracklet step (one vmapped device program replacing
     the OpenMP per-camera fan-out, ref PSNWhere.cpp:257-266 — results are
     indexed by camera, fixing the reference's completion-order race)
  2. 3D MHT association step
  3. optional deferred CLEAR-MOT evaluation feed (ref Associator3D.cpp:507-512)
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcmtt_opticalflow_tpu.config import EngineConfig
from mcmtt_opticalflow_tpu.geometry.tsai import TsaiCamera, stack_cameras
from mcmtt_opticalflow_tpu.models.associator3d import (Associator3D,
                                                       Track3DResult)
from mcmtt_opticalflow_tpu.models.tracker2d import (init_tracker2d_state,
                                                    make_tracker2d_step)


def _unpack2d(arr):
    """Host inverse of TrackingEngine._pack2d."""
    a = np.asarray(arr)
    return (a[..., 0].astype(np.int64), a[..., 2:6], a[..., 1] > 0.5)


class TrackingEngine:
    def __init__(self, cfg: EngineConfig, cameras: Sequence[TsaiCamera],
                 pipelined: bool = False, sidemaps=None, mesh=None):
        """pipelined=True pipelines the engine three frames deep: the
        device 2D stage runs TWO frames ahead of the host-side 3D
        association (SURVEY.md §2's frame-pipeline axis; the reference is
        strictly sequential per frame), and the 3D hypothesis solve of
        frame t runs while the host enumerates frame t+1 (the associator's
        deferred_solve).  Results then trail the input by THREE frames:
        process_frame(t) returns the frame t-3 result (None for the first
        three); call flush() until it returns None to drain the tail.
        Results are bit-identical to the sequential mode, only delayed.

        sidemaps: optional per-camera (sensitivity, boundary, stride)
        triples (see Associator3D).

        mesh: optional ('cam', 'block') jax.sharding.Mesh.  The camera
        axis of the 2D stage shards over 'cam' (the device-parallel
        replacement for the reference's per-camera OpenMP fan-out, ref
        PSNWhere.cpp:257);
        the 3D stage's track/hypothesis batches shard over all devices
        (see Associator3D)."""
        assert len(cameras) == cfg.num_cameras
        self.cfg = cfg
        self.cameras = list(cameras)
        self.cams = stack_cameras(cameras)
        self.step2d = make_tracker2d_step(cfg.tracker2d, multi_camera=True)
        self.state2d = init_tracker2d_state(
            cfg.tracker2d, cfg.image_height, cfg.image_width,
            num_cameras=cfg.num_cameras)
        self.mesh = mesh
        self._s_cam = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            assert cfg.num_cameras % mesh.shape["cam"] == 0, \
                (cfg.num_cameras, dict(mesh.shape))
            self._s_cam = NamedSharding(mesh, P("cam"))
            self.cams = jax.tree.map(
                lambda x: jax.device_put(x, self._s_cam), self.cams)
            self.state2d = jax.tree.map(
                lambda x: jax.device_put(
                    x, self._s_cam if x.ndim > 0 else
                    NamedSharding(mesh, P())), self.state2d)
        self.assoc = Associator3D(cfg, cameras, sidemaps=sidemaps,
                                  mesh=mesh, deferred_solve=pipelined)
        # Only GRAY frames cross the host-device boundary, as uint8 (a
        # twelfth of the f32 RGB bytes).  8-bit gray matches the
        # reference, whose cvtColor produces CV_8U gray from 8-bit JPEGs
        # (ref Tracker2D.cpp:256-262).
        self._dequant = jax.jit(
            lambda u8: u8.astype(jnp.float32) * jnp.float32(1.0 / 255.0))
        from mcmtt_opticalflow_tpu import native
        self._native_gray = native.available()
        # tile-delta frame upload: the device keeps the previous frame as
        # a resident tile buffer and the host uploads ONLY the (16 x 32)
        # tiles where any pixel changed — LOSSLESS, bit-identical to a
        # full upload.  Static-background surveillance footage (PETS)
        # changes ~20% of tiles per frame.  Disabled under a mesh
        # (sharded gray) or for odd image sizes.
        # single-leaf 2D result download: the (ids, boxes, mask) tuple
        # packs into ONE f32 array on device (ids are exact in f32 below
        # 2^24; a PETS-scale run allocates ~50 ids/frame, orders of
        # magnitude below that)
        self._pack2d = jax.jit(lambda ids, boxes, mask: jnp.concatenate(
            [ids.astype(jnp.float32)[..., None],
             mask.astype(jnp.float32)[..., None], boxes], -1))
        self._TILE_H, self._TILE_W = 16, 32
        h, w = cfg.image_height, cfg.image_width
        self._tiles_ok = (mesh is None and h % self._TILE_H == 0
                          and w % self._TILE_W == 0)
        self._tile_buf = None        # [NT, 16, 32] u8 device buffer
        self._prev_gray = None       # [C, H, W] u8 host mirror
        if self._tiles_ok:
            th, tw = h // self._TILE_H, w // self._TILE_W
            self._tile_grid = (cfg.num_cameras, th, tw)
            nt = cfg.num_cameras * th * tw

            @jax.jit
            def apply_tiles(buf, tiles, idx):
                """Scatter changed tiles into the resident buffer and
                return (new buffer, [C, H, W] f32 gray)."""
                buf = buf.at[idx].set(tiles, mode="drop")
                img = (buf.reshape(cfg.num_cameras, th, tw,
                                   self._TILE_H, self._TILE_W)
                       .transpose(0, 1, 3, 2, 4)
                       .reshape(cfg.num_cameras, h, w))
                return buf, img.astype(jnp.float32) * jnp.float32(1 / 255.0)

            self._apply_tiles = apply_tiles
            self._nt = nt
        self.frame_idx = -1
        self.results: List[Track3DResult] = []
        self.timing: List[float] = []
        self.pipelined = pipelined
        # queue of up to 2 in-flight 2D frames:
        # (frame_idx, AsyncFetch of 2D outputs, host rgb u8)
        self._pending: List[tuple] = []

    def _put_cam(self, x):
        """Upload a camera-leading host array (sharded over 'cam' when a
        mesh is active)."""
        a = jnp.asarray(x)
        if self._s_cam is not None:
            a = jax.device_put(a, self._s_cam)
        return a

    @staticmethod
    def _bucket(n: int, lo: int) -> int:
        b = lo
        while b < n:
            b *= 2
        return b

    def _to_tiles(self, gray_u8: np.ndarray) -> np.ndarray:
        c, th, tw = self._tile_grid
        return (gray_u8.reshape(c, th, self._TILE_H, tw, self._TILE_W)
                .transpose(0, 1, 3, 2, 4)
                .reshape(self._nt, self._TILE_H, self._TILE_W))

    def _upload_gray(self, gray_u8: np.ndarray):
        """Ship this frame's gray to the device: changed tiles only when
        the resident tile buffer is warm, full frame otherwise."""
        if not self._tiles_ok:
            return self._dequant(self._put_cam(gray_u8))
        nt = self._nt
        if self._prev_gray is None:
            ids = np.arange(nt, dtype=np.int32)
            tiles = self._to_tiles(gray_u8)
            self._tile_buf = jnp.zeros(
                (nt, self._TILE_H, self._TILE_W), jnp.uint8)
        else:
            neq = self._prev_gray != gray_u8
            c, th, tw = self._tile_grid
            changed = (neq.reshape(c, th, self._TILE_H, tw, self._TILE_W)
                       .any(axis=(2, 4)).reshape(nt))
            ids = np.flatnonzero(changed).astype(np.int32)
            if len(ids) > nt // 2:         # busy frame: full refresh
                ids = np.arange(nt, dtype=np.int32)
                tiles = self._to_tiles(gray_u8)
            else:
                tiles = self._to_tiles(gray_u8)[ids]
        self._prev_gray = gray_u8
        k = min(self._bucket(max(len(ids), 1), lo=256), nt)
        if len(ids) < k:                   # pad; out-of-range ids drop
            pad = k - len(ids)
            ids = np.concatenate([ids, np.full(pad, nt, np.int32)])
            tiles = np.concatenate(
                [tiles, np.zeros((pad,) + tiles.shape[1:], np.uint8)])
        self._tile_buf, gray = self._apply_tiles(
            self._tile_buf, jnp.asarray(tiles), jnp.asarray(ids))
        return gray

    def _pad_detections(self, detections):
        c = self.cfg.num_cameras
        d = self.cfg.tracker2d.max_detections
        boxes = np.zeros((c, d, 4), np.float32)
        mask = np.zeros((c, d), bool)
        for ci in range(c):
            det = np.asarray(detections[ci], np.float32).reshape(-1, 4)
            n = min(len(det), d)
            boxes[ci, :n] = det[:n]
            mask[ci, :n] = True
        return boxes, mask

    def process_frame(self, frames_rgb: np.ndarray,
                      detections: Sequence[np.ndarray],
                      frame_idx: Optional[int] = None) -> Track3DResult:
        """Args:
          frames_rgb: [C, H, W, 3] images — uint8 in [0, 255] (preferred;
            this is what dataset JPEGs decode to) or float in [0, 1]
            (quantised to uint8 on the host before upload).
          detections: per camera [K_c, 4] (x, y, w, h) arrays.
        """
        t0 = time.perf_counter()
        self.frame_idx = self.frame_idx + 1 if frame_idx is None else frame_idx
        boxes, mask = self._pad_detections(detections)
        # one upload per frame: 8-bit gray goes up for the LK stage; RGB
        # stays on host for appearance ingest
        f = np.asarray(frames_rgb)
        with self.assoc.timer.stage("gray"):
            if f.dtype != np.uint8:
                f = (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            if self._native_gray:
                from mcmtt_opticalflow_tpu import native
                gray_u8 = native.rgb_to_gray_u8(f)
            else:
                gray_u8 = ((f[..., 0].astype(np.uint16) + f[..., 1]
                            + f[..., 2]) // 3).astype(np.uint8)
        with self.assoc.timer.stage("upload"):
            gray = self._upload_gray(gray_u8)

        if self.pipelined:
            # phase split around the 2D dispatch: the associator's phase 1
            # (tracklet ingest + seed enumeration + collect of the
            # in-flight solve) runs FIRST, so this frame's 2D program is
            # enqueued AFTER the previous frame's hypothesis solve — the
            # solve then completes with a full frame of host shadow
            # instead of queueing behind the 2D device work.  The 2D
            # stage runs TWO frames ahead: process_frame(t) associates
            # frame t-2, so every 2D fetch joins with >= 2 frames of
            # lead.  Results are bit-identical to sequential mode, 3
            # frames late.
            result = None
            if len(self._pending) == 2:
                prev_idx, prev_fetch, prev_rgb = self._pending.pop(0)
                with self.assoc.timer.stage("get2d"):
                    ids_np, boxes_np, mask_np = _unpack2d(prev_fetch.get())
                result = self.assoc.step_begin(prev_idx, ids_np, boxes_np,
                                               mask_np, prev_rgb)
                self.assoc.step_finish(prev_idx)
            with self.assoc.timer.stage("tracker2d"):
                self.state2d, out2d = self.step2d(
                    self.state2d, gray, self._put_cam(boxes),
                    self._put_cam(mask), self.cams,
                    jnp.int32(self.frame_idx))
            from mcmtt_opticalflow_tpu.parallel.mesh import AsyncFetch
            out_fetch = AsyncFetch(
                self._pack2d(out2d.ids, out2d.boxes, out2d.mask))
            self._pending.append((self.frame_idx, out_fetch, f))
            if result is None:       # pipeline still filling
                return None
        else:
            with self.assoc.timer.stage("tracker2d"):
                self.state2d, out2d = self.step2d(
                    self.state2d, gray, self._put_cam(boxes),
                    self._put_cam(mask), self.cams,
                    jnp.int32(self.frame_idx))
            result = self._associate(self.frame_idx, out2d, f)
        result.processing_time = time.perf_counter() - t0
        self.timing.append(result.processing_time)
        self.results.append(result)
        return result

    def _associate(self, frame_idx, out2d, rgb_dev) -> Track3DResult:
        with self.assoc.timer.stage("get2d"):
            from mcmtt_opticalflow_tpu.parallel.mesh import fetch
            ids_np, boxes_np, mask_np = _unpack2d(fetch(
                self._pack2d(out2d.ids, out2d.boxes, out2d.mask)))
        return self.assoc.step(frame_idx, ids_np, boxes_np, mask_np, rgb_dev)

    def flush(self) -> Optional[Track3DResult]:
        """Drain one stage of the pipelined tail: first the not-yet-
        associated 2D frame, then the associator's in-flight hypothesis
        solve.  Call until it returns None."""
        result = None
        if self._pending:
            prev_idx, prev_fetch, prev_rgb = self._pending.pop(0)
            with self.assoc.timer.stage("get2d"):
                ids_np, boxes_np, mask_np = _unpack2d(prev_fetch.get())
            result = self.assoc.step(prev_idx, ids_np, boxes_np, mask_np,
                                     prev_rgb)
        if result is None:
            result = self.assoc.collect()
        if result is not None:
            self.results.append(result)
        return result

    def deferred_result(self, frame_idx: int) -> Track3DResult:
        return self.assoc.result_at(frame_idx)
