"""Batched pyramidal Lucas-Kanade optical flow.

The reference's hottest loop is cv::calcOpticalFlowPyrLK called per
detection (backward through a 4-frame buffer) and per live tracker (forward)
with a per-box window size (ref psn_where/PSNWhere_Tracker2D.cpp:763-811,
851-877).  An accelerator wants one big batched problem instead: all features of all
boxes track in a single call — window gathers are batched bilinear samples,
the 2x2 normal equations solve in registers, and the Newton iterations are a
fixed-trip fori_loop.

The window size is fixed (config.lk_window) rather than per-box; the
pyramid supplies scale invariance.  Inputs are gray float images in [0, 1].
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from mcmtt_opticalflow_tpu.ops.pyramid import build_pyramid, image_gradients


def _bilinear(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample. img: [H, W]; xy: [..., 2] (x, y) -> [...]."""
    h, w = img.shape
    x = jnp.clip(xy[..., 0], 0.0, w - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy)
            + i10 * (1 - fx) * fy + i11 * fx * fy)


def _window_offsets(window: int, dtype=jnp.float32):
    half = (window - 1) / 2.0
    r = jnp.arange(window, dtype=dtype) - half
    ox, oy = jnp.meshgrid(r, r)
    return jnp.stack([ox, oy], -1).reshape(-1, 2)       # [window^2, 2]


@functools.partial(jax.jit, static_argnames=("window", "iterations"))
def lk_track_points(prev_img: jnp.ndarray,
                    next_img: jnp.ndarray,
                    prev_ix: jnp.ndarray,
                    prev_iy: jnp.ndarray,
                    points: jnp.ndarray,
                    guess: jnp.ndarray,
                    window: int = 16,
                    iterations: int = 10,
                    eps: float = 0.03):
    """Single-level iterative LK for a batch of points.

    Args:
      prev_img, next_img: [H, W] gray.
      prev_ix, prev_iy:   [H, W] gradients of prev_img.
      points: [N, 2] source (x, y) in prev_img.
      guess:  [N, 2] initial target positions in next_img.

    Returns (tracked [N, 2], valid [N], residual [N]).
    """
    offs = _window_offsets(window, points.dtype)        # [K, 2]
    pw = points[:, None, :] + offs[None, :, :]          # [N, K, 2]
    t_patch = _bilinear(prev_img, pw)                   # template [N, K]
    gx = _bilinear(prev_ix, pw)
    gy = _bilinear(prev_iy, pw)
    gxx = jnp.sum(gx * gx, -1)
    gxy = jnp.sum(gx * gy, -1)
    gyy = jnp.sum(gy * gy, -1)
    det = gxx * gyy - gxy * gxy
    ok_g = det > 1e-7
    inv_det = jnp.where(ok_g, 1.0 / jnp.where(ok_g, det, 1.0), 0.0)

    def body(_, carry):
        cur, go = carry
        nw = cur[:, None, :] + offs[None, :, :]
        n_patch = _bilinear(next_img, nw)
        di = n_patch - t_patch                          # [N, K]
        bx = jnp.sum(di * gx, -1)
        by = jnp.sum(di * gy, -1)
        dx = -(gyy * bx - gxy * by) * inv_det
        dy = -(-gxy * bx + gxx * by) * inv_det
        step = jnp.stack([dx, dy], -1)
        cur = cur + jnp.where((ok_g & go)[:, None], step, 0.0)
        # per-feature convergence mask, mirroring the reference's
        # TermCriteria epsilon early-out
        # (ref Tracker2D.cpp:145): apply the sub-eps step, then stop
        go = go & ((jnp.abs(dx) + jnp.abs(dy)) > eps)
        return cur, go

    tracked, _ = jax.lax.fori_loop(
        0, iterations, body, (guess, jnp.ones(points.shape[:1], bool)))

    h, w = next_img.shape
    half = (window - 1) / 2.0
    inb = ((tracked[:, 0] >= half) & (tracked[:, 0] < w - half)
           & (tracked[:, 1] >= half) & (tracked[:, 1] < h - half))
    nw = tracked[:, None, :] + offs[None, :, :]
    resid = jnp.mean(jnp.abs(_bilinear(next_img, nw) - t_patch), axis=-1)
    valid = ok_g & inb
    return tracked, valid, resid


def lk_track_prebuilt(prev_pyr: Sequence[jnp.ndarray],
                      next_pyr: Sequence[jnp.ndarray],
                      points: jnp.ndarray,
                      window: int = 16,
                      iterations: int = 10,
                      max_residual: float = 0.08,
                      active: jnp.ndarray | None = None):
    """Pyramidal LK over PREBUILT pyramids (finest first).

    The 2D tracker calls LK 4x per frame over a sliding frame window;
    caching each frame's pyramid in the tracker state and tracking over
    the cached levels skips 6 of the 8 per-frame pyramid builds the
    build-per-call API pays (ref cv::calcOpticalFlowPyrLK's internal
    pyramids, Tracker2D.cpp:776, 871)."""
    levels = len(prev_pyr)
    scale = 2.0 ** (levels - 1)
    cur = points / scale
    n = points.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    valid = active
    resid = jnp.zeros((n,), points.dtype)
    for lvl in range(levels - 1, -1, -1):
        src = points / (2.0 ** lvl)
        ix, iy = image_gradients(prev_pyr[lvl])
        cur, v, resid = lk_track_points(prev_pyr[lvl], next_pyr[lvl], ix, iy,
                                        src, cur, window=window,
                                        iterations=iterations)
        valid = valid & v
        if lvl > 0:
            cur = cur * 2.0
    status = valid & (resid < max_residual)
    return cur, status, resid


@functools.partial(jax.jit, static_argnames=("levels", "window", "iterations"))
def lk_track_pyramid(prev_img: jnp.ndarray,
                     next_img: jnp.ndarray,
                     points: jnp.ndarray,
                     levels: int = 3,
                     window: int = 16,
                     iterations: int = 10,
                     max_residual: float = 0.08,
                     active: jnp.ndarray | None = None):
    """Pyramidal LK: track [N, 2] points from prev_img to next_img.

    Images are [H, W] float gray in [0, 1]; H, W divisible by 2**(levels-1).
    `active` marks real (non-padding) features: inactive ones return
    status False.
    Returns (tracked [N, 2], status [N] bool, residual [N]).
    """
    prev_pyr = build_pyramid(prev_img, levels)
    next_pyr = build_pyramid(next_img, levels)
    return lk_track_prebuilt(prev_pyr, next_pyr, points, window=window,
                             iterations=iterations,
                             max_residual=max_residual, active=active)
