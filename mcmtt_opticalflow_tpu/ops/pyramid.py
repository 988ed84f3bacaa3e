"""Gaussian image pyramids (batched, XLA-fused convolutions).

Feeds the pyramidal Lucas-Kanade tracker; replaces OpenCV's internal
pyramid construction inside cv::calcOpticalFlowPyrLK
(ref psn_where/PSNWhere_Tracker2D.cpp:776, 871).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

# 5-tap binomial kernel (OpenCV pyrDown's separable Gaussian).
# numpy, NOT jnp: a module-level device array would initialise the XLA
# backend at import time, which breaks jax.distributed.initialize()
# (multi-host launch imports this package before joining the cluster).
_K5 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_K3 = np.asarray([1.0, 2.0, 1.0], np.float32) / 4.0


def _sep_conv(img: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Separable 2D convolution with edge padding. img: [..., H, W].

    Written as explicit shifted adds rather than conv_general_dilated:
    the shifted-add form stays elementwise and fuses with its consumers
    instead of going through a generic convolution for a 3- or 5-tap
    kernel."""
    pad = (k.shape[0] - 1) // 2
    h, w = img.shape[-2:]
    kk = [float(v) for v in np.asarray(k)]
    x = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(pad, pad), (0, 0)],
                mode="edge")
    y = sum(kk[i] * jax.lax.slice_in_dim(x, i, i + h, axis=-2)
            for i in range(len(kk)))
    y = jnp.pad(y, [(0, 0)] * (img.ndim - 2) + [(0, 0), (pad, pad)],
                mode="edge")
    return sum(kk[i] * jax.lax.slice_in_dim(y, i, i + w, axis=-1)
               for i in range(len(kk)))


def gaussian_blur_3x3(img: jnp.ndarray) -> jnp.ndarray:
    return _sep_conv(img, _K3)


def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """Blur + 2x decimation. img: [..., H, W] with even H, W."""
    return _sep_conv(img, _K5)[..., ::2, ::2]


def build_pyramid(img: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """List of `levels` images, finest first. img: [..., H, W] float32.
    H and W must be divisible by 2**(levels-1)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def image_gradients(img: jnp.ndarray):
    """Central-difference gradients (Scharr-free, matches LK's needs).
    img: [..., H, W] -> (ix, iy) same shape."""
    ix = 0.5 * (jnp.roll(img, -1, axis=-1) - jnp.roll(img, 1, axis=-1))
    iy = 0.5 * (jnp.roll(img, -1, axis=-2) - jnp.roll(img, 1, axis=-2))
    return ix, iy
