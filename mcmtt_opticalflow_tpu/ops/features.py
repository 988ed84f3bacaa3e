"""Grid-distributed corner features inside detection boxes.

The reference extracts "GridFAST" keypoints inside each detection box and
randomly keeps at most 100 (ref psn_where/PSNWhere_Tracker2D.cpp:142,
735-757).  The batched equivalent: one Shi-Tomasi (min-eigenvalue)
response map per frame, then for every box a fixed lattice of candidate
positions whose responses are gathered and reduced per grid cell — giving a
static-shape [num_boxes, max_features] feature set with a validity mask and
the same grid-spread property the reference's detector provides.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mcmtt_opticalflow_tpu.ops.pyramid import _sep_conv, _K3


def shi_tomasi_response(img: jnp.ndarray) -> jnp.ndarray:
    """Min-eigenvalue corner response. img: [H, W] float -> [H, W]."""
    ix = 0.5 * (jnp.roll(img, -1, -1) - jnp.roll(img, 1, -1))
    iy = 0.5 * (jnp.roll(img, -1, -2) - jnp.roll(img, 1, -2))
    sxx = _sep_conv(ix * ix, _K3)
    syy = _sep_conv(iy * iy, _K3)
    sxy = _sep_conv(ix * iy, _K3)
    tr = sxx + syy
    dt = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy ** 2, 0.0))
    return 0.5 * (tr - dt)


@functools.partial(jax.jit, static_argnames=("grid", "sub"))
def detect_grid_features(img: jnp.ndarray,
                         boxes: jnp.ndarray,
                         box_mask: jnp.ndarray,
                         grid: int = 8,
                         sub: int = 2,
                         quality: float = 0.01):
    """Pick grid-spread corners inside each box.

    Args:
      img:      [H, W] gray float frame.
      boxes:    [B, 4] (x, y, w, h) detection boxes.
      box_mask: [B] bool valid boxes.
      grid:     cells per side -> grid*grid features per box.
      sub:      candidate positions per cell side (sub*sub candidates/cell).
      quality:  min response relative to the box's best corner.

    Returns:
      points: [B, grid*grid, 2] feature (x, y) positions.
      valid:  [B, grid*grid] bool.
    """
    # barrier: without it XLA may fuse the response-map producer into the
    # scattered point-sample consumer and RECOMPUTE the map per sample;
    # with the barrier the map materializes once
    resp = jax.lax.optimization_barrier(shi_tomasi_response(img))
    b = boxes.shape[0]
    n = grid * sub
    # normalized lattice in (0, 1), cell-centered
    lin = (jnp.arange(n, dtype=img.dtype) + 0.5) / n
    gx, gy = jnp.meshgrid(lin, lin)                     # [n, n]
    lattice = jnp.stack([gx, gy], -1).reshape(-1, 2)    # [n*n, 2]
    xy = (boxes[:, None, 0:2]
          + lattice[None, :, :] * boxes[:, None, 2:4])  # [B, n*n, 2]

    h, w = img.shape
    xi = jnp.clip(xy[..., 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(xy[..., 1].astype(jnp.int32), 0, h - 1)
    # sample with FLAT 1-D index vectors: the flattened form is one plain
    # gather, where multi-dim index arrays can lower to a slice-per-row
    # path
    r = resp[yi.reshape(-1), xi.reshape(-1)].reshape(yi.shape)  # [B, n*n]
    inb = ((xy[..., 0] >= 1) & (xy[..., 0] < w - 1)
           & (xy[..., 1] >= 1) & (xy[..., 1] < h - 1))
    r = jnp.where(inb, r, -jnp.inf)

    # reduce each grid cell (sub*sub candidates) to its best candidate
    r_cells = r.reshape(b, grid, sub, grid, sub).transpose(0, 1, 3, 2, 4)
    r_cells = r_cells.reshape(b, grid * grid, sub * sub)
    xy_cells = xy.reshape(b, grid, sub, grid, sub, 2).transpose(0, 1, 3, 2, 4, 5)
    xy_cells = xy_cells.reshape(b, grid * grid, sub * sub, 2)
    best = jnp.argmax(r_cells, axis=-1)                 # [B, G]
    best_r = jnp.take_along_axis(r_cells, best[..., None], -1)[..., 0]
    points = jnp.take_along_axis(
        xy_cells, best[..., None, None].repeat(2, -1), -2)[..., 0, :]

    box_best = jnp.max(best_r, axis=-1, keepdims=True)
    valid = (best_r > quality * jnp.maximum(box_best, 1e-12)) \
        & jnp.isfinite(best_r) & box_mask[:, None]
    return points, valid
