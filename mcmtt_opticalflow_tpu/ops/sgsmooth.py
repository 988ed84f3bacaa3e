"""Savitzky-Golay trajectory smoothing as batched matmuls.

The reference smooths each track's 3D trajectory incrementally with a scalar
Savitzky-Golay filter per axis (span 9, degree 1; psn_where/PSNWhere_SGSmooth.h:15-16),
re-smoothing only the tail after each insert (PSNWhere_SGSmooth.cpp:198-260)
and precomputing per-window-size Q matrices via Vandermonde + Gram-Schmidt QR
(CalculateQ, PSNWhere_SGSmooth.cpp:109-196).

Batched design: smoothing a length-n sequence is a linear map, so we
precompute one [n, n] smoothing matrix per valid window length — built from
the same Q-projection rows as the reference:

  * rows 0..h-1      : (Q Q^T)[0:h]      — the reference's Qbegin
  * rows h..n-h-1    : middle row of Q Q^T (= uniform 1/w for degree<=1,
                       identical to the reference's Qmid, SGSmooth.cpp:115-117)
  * rows n-h..n-1    : (Q Q^T)[h+1:w]    — the reference's Qend

Batched smoothing over T tracks x 3 axes becomes a single gathered batch
matmul instead of per-track incremental tail updates: recomputing the
whole windowed trajectory is one fused matmul.  The matmuls run at
Precision.HIGHEST: positions are ~1e4 mm, and a TF32 product (~3 decimal
digits) would move smoothed points by ~10 mm.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _sg_projection(window: int, degree: int) -> np.ndarray:
    """Q Q^T for the orthonormalised Vandermonde basis on [-h, h]
    (float64; matches the reference's Gram-Schmidt QR,
    ref PSNWhere_SGSmooth.cpp:109-196)."""
    h = (window - 1) // 2
    t = np.arange(-h, h + 1, dtype=np.float64)
    v = np.stack([t ** k for k in range(degree + 1)], axis=1)  # [w, d+1]
    q, _ = np.linalg.qr(v)
    return q @ q.T


def smoothing_matrix_np(n: int, span: int, degree: int) -> np.ndarray:
    """[n, n] float64 smoothing matrix reproducing the reference's
    begin/mid/end row structure (ref PSNWhere_SGSmooth.cpp:198-260)."""
    w = min(span, n)
    w -= (w + 1) % 2           # force odd (ref :203)
    if w <= degree:            # bypass (ref :204-212)
        return np.eye(n)
    h = (w - 1) // 2
    b = _sg_projection(w, degree)
    s = np.zeros((n, n))
    for i in range(h):                      # begin rows
        s[i, :w] = b[i]
    for i in range(h, n - h):               # middle rows (uniform for deg<=1)
        s[i, i - h:i + h + 1] = b[h]
    for j in range(h):                      # end rows
        s[n - h + j, n - w:] = b[h + 1 + j]
    return s


@functools.lru_cache(maxsize=8)
def _sg_matrix_stack_np(capacity: int, span: int, degree: int) -> np.ndarray:
    out = np.zeros((capacity + 1, capacity, capacity), dtype=np.float32)
    for n in range(1, capacity + 1):
        out[n, :n, :n] = smoothing_matrix_np(n, span, degree)
    return out


def sg_smoothing_matrix(capacity: int, span: int, degree: int) -> jnp.ndarray:
    """[capacity+1, capacity, capacity] stack: entry L is the smoothing
    matrix for a length-L sequence, zero-padded to capacity.  Gathered by
    per-track length on device, so variable-length tracks smooth in one
    batched matmul.  (The cache holds numpy; conversion happens per call so
    traced contexts never capture a stale tracer.)"""
    return jnp.asarray(_sg_matrix_stack_np(capacity, span, degree))


def sg_smooth(data: jnp.ndarray, span: int = 9, degree: int = 1) -> jnp.ndarray:
    """Smooth [n] or [n, d] data directly (test/reference path)."""
    n = data.shape[0]
    s = jnp.asarray(smoothing_matrix_np(n, span, degree), data.dtype)
    return jnp.matmul(s, data, precision=jax.lax.Precision.HIGHEST)


def sg_smooth_masked(data: jnp.ndarray, lengths: jnp.ndarray,
                     span: int = 9, degree: int = 1) -> jnp.ndarray:
    """Batched smoothing of padded trajectories.

    Args:
      data:    [B, T, D] padded trajectories (valid prefix per row).
      lengths: [B] int32 valid lengths.

    Returns [B, T, D]; positions >= length are passed through unchanged.
    """
    b, t, d = data.shape
    mats = sg_smoothing_matrix(t, span, degree)          # [T+1, T, T]
    sel = mats[jnp.clip(lengths, 0, t)]                  # [B, T, T]
    smoothed = jnp.einsum("bij,bjd->bid", sel, data,
                          precision=jax.lax.Precision.HIGHEST)
    idx = jnp.arange(t)[None, :, None]
    return jnp.where(idx < lengths[:, None, None], smoothed, data)
