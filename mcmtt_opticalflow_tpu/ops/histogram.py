"""RGB appearance histograms from fixed-lattice box samples.

The reference crops each tracklet's detection box and histograms each colour
channel into 16 bins, concatenated [R; G; B] and normalised by pixel count
(ref psn_where/PSNWhere_Associator3D.cpp:2542-2556, psn::histogram
PSNWhere_Utils.cpp:445-460).  Variable-size crops are hostile to static
shapes, so we sample a fixed PxP lattice inside the box — the histogram of a
uniform sample converges to the crop histogram and keeps every box the same
shape, letting all boxes of all cameras batch in one call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("num_bins", "patch"))
def rgb_histogram(img: jnp.ndarray,
                  boxes: jnp.ndarray,
                  num_bins: int = 16,
                  patch: int = 16) -> jnp.ndarray:
    """Normalised concatenated RGB histogram per box.

    Args:
      img:   [H, W, 3] image, float in [0, 1] or uint8 in [0, 255]
             (channel order R, G, B).  uint8 is the cheap-transfer path —
             the reference's frames are 8-bit JPEGs anyway
             (ref psn_where/main.cpp:128-151).
      boxes: [B, 4] (x, y, w, h).

    Returns [B, 3*num_bins] float histogram, rows ordered R, G, B to match
    the reference's vconcat(R, G, B) layout.
    """
    h, w, _ = img.shape
    b = boxes.shape[0]
    lin = (jnp.arange(patch, dtype=boxes.dtype) + 0.5) / patch
    gx, gy = jnp.meshgrid(lin, lin)
    lattice = jnp.stack([gx, gy], -1).reshape(-1, 2)         # [P*P, 2]
    xy = boxes[:, None, 0:2] + lattice[None] * boxes[:, None, 2:4]
    xi = jnp.clip(xy[..., 0].astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(xy[..., 1].astype(jnp.int32), 0, h - 1)
    px = img[yi, xi]                                         # [B, P*P, 3]
    if img.dtype == jnp.uint8:
        bins = jnp.clip(px.astype(jnp.int32) * num_bins // 256,
                        0, num_bins - 1)
    else:
        bins = jnp.clip((px * num_bins).astype(jnp.int32), 0, num_bins - 1)
    one_hot = jax.nn.one_hot(bins, num_bins, dtype=boxes.dtype)  # [B,P*P,3,bins]
    hist = jnp.sum(one_hot, axis=1)                          # [B, 3, bins]
    hist = hist / jnp.asarray(patch * patch, one_hot.dtype)
    return hist.reshape(b, 3 * num_bins)


def host_rgb_histogram(img, boxes, num_bins: int = 16, patch: int = 16):
    """Numpy mirror of `rgb_histogram` for host-side tracklet ingest.

    Sampling matches the device kernel exactly (same lattice, same int
    cast, same binning) so the two paths are interchangeable.  At tracklet
    batch sizes (tens of boxes) a numpy pass beats a device dispatch and
    its round trip.
    """
    import numpy as np

    img = np.asarray(img)
    boxes = np.asarray(boxes, np.float32)
    h, w, _ = img.shape
    b = boxes.shape[0]
    lin = (np.arange(patch, dtype=np.float32) + 0.5) / patch
    gx, gy = np.meshgrid(lin, lin)
    lattice = np.stack([gx, gy], -1).reshape(-1, 2)          # [P*P, 2]
    xy = boxes[:, None, 0:2] + lattice[None] * boxes[:, None, 2:4]
    xi = np.clip(xy[..., 0].astype(np.int32), 0, w - 1)
    yi = np.clip(xy[..., 1].astype(np.int32), 0, h - 1)
    px = img[yi, xi]                                         # [B, P*P, 3]
    if img.dtype == np.uint8:
        bins = np.clip(px.astype(np.int32) * num_bins // 256,
                       0, num_bins - 1)
    else:
        bins = np.clip((px * num_bins).astype(np.int32), 0, num_bins - 1)
    offs = (np.arange(b)[:, None, None] * 3
            + np.arange(3)[None, None, :]) * num_bins        # [B, 1, 3]
    cnt = np.bincount((bins + offs).reshape(-1),
                      minlength=b * 3 * num_bins)
    hist = cnt.reshape(b, 3 * num_bins).astype(np.float32) / (patch * patch)
    return hist


def rgb_cost(feat1: jnp.ndarray, feat2: jnp.ndarray, time_gap,
             min_dist: float = 0.2, coef: float = 100.0,
             decay: float = 0.1) -> jnp.ndarray:
    """Appearance cost between two histogram features (batched)
    (ref ComputeRGBCost, PSNWhere_Associator3D.cpp:2394-2400)."""
    diff = feat1 - feat2
    norm2 = jnp.sum(diff * diff, axis=-1)
    gap = jnp.asarray(time_gap, norm2.dtype)
    scale = coef * jnp.exp(-decay * (gap - 1.0))
    return jnp.where(norm2 > min_dist, scale * (norm2 - min_dist), 0.0)
