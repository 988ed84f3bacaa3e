"""Batched 3D reconstruction primitives.

Batched replacements for the reference's per-pair scalar loops:

  * two-line triangulation           (ref psn_where/PSNWhere_Utils.cpp:499-525)
  * N-view least-squares line meet   (ref PSNWhere_Associator3D.cpp:930-982)
  * N-view grounding-point mean      (ref PSNWhere_Associator3D.cpp:995-1046)
  * 2D segment intersection test     (ref PSNWhere_Utils.cpp:472-487)

Everything broadcasts over arbitrary leading batch axes, so the O(T*M)
cross-camera gating hot loop (ref Associator3D.cpp:1233-1268) becomes one
batched call.  Contractions run at Precision.HIGHEST (mm coordinates of
~1e4 lose ~10 mm in a TF32 product).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def triangulate_two_lines(p1a, p1b, p2a, p2b):
    """Closest-point midpoint of two 3D lines (batched).

    Lines are (first, second) point pairs, matching the reference's
    psn::Triangulation solving the 2x2 normal equations in closed form
    (ref PSNWhere_Utils.cpp:499-525).

    Returns (midpoint [..., 3], gap distance [...]).
    """
    d1 = p1a - p1b                  # line1 direction (first - second), as ref
    d2 = p2a - p2b
    off = p2b - p1b
    a11 = jnp.sum(d1 * d1, -1)
    a12 = jnp.sum(d1 * -d2, -1)
    a21 = jnp.sum(d2 * d1, -1)
    a22 = jnp.sum(d2 * -d2, -1)
    b1 = jnp.sum(d1 * off, -1)
    b2 = jnp.sum(d2 * off, -1)
    det = a11 * a22 - a12 * a21
    safe_det = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    t1 = (b1 * a22 - a12 * b2) / safe_det
    t2 = (a11 * b2 - b1 * a21) / safe_det
    c1 = p1b + d1 * t1[..., None]
    c2 = p2b + d2 * t2[..., None]
    mid = 0.5 * (c1 + c2)
    gap = jnp.linalg.norm(c1 - c2, axis=-1)
    # degenerate (parallel) lines: report an infinite gap
    gap = jnp.where(jnp.abs(det) < 1e-12, jnp.inf, gap)
    return mid, gap


def nview_point_reconstruction(points_a, points_b, mask):
    """Least-squares intersection of N back-projection lines (batched).

    Solves A x = b with A = sum_i P_i^T P_i, P_i = (v_i v_i^T - I),
    b = sum_i P_i^T P_i s_i over the *masked* lines, then reports the mean
    point-to-line distance — the same system as ref
    PSNWhere_Associator3D.cpp:930-982, but vmapped/batched instead of a
    per-pair OpenCV solve.

    Args:
      points_a: [..., N, 3] line first points (e.g. z=2000 ends).
      points_b: [..., N, 3] line second points (e.g. ground ends).
      mask:     [..., N] bool, which lines participate.

    Returns (point [..., 3], mean_distance [...], num_lines [...]).
    With fewer than 2 valid lines the point falls back to the first valid
    line's second point and distance to max_tracklet_distance/2 semantics
    are left to the caller (returned distance is 0 there).
    """
    m = mask[..., None].astype(points_a.dtype)
    d = points_b - points_a
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    eye = jnp.eye(3, dtype=points_a.dtype)
    # P = v v^T - I ; PP = P^T P  (P is symmetric here)
    vvt = d[..., :, None] * d[..., None, :]          # [..., N, 3, 3]
    p = vvt - eye
    pp = jnp.einsum("...nij,...njk->...nik", p, p,   # P^T P (P symmetric)
                    precision=jax.lax.Precision.HIGHEST)
    pp = pp * m[..., None]
    a_mat = jnp.sum(pp, axis=-3)                     # [..., 3, 3]
    b_vec = jnp.einsum("...nij,...nj->...i", pp, points_a * m,
                       precision=jax.lax.Precision.HIGHEST)
    # regularise for masked-out / degenerate batches
    num = jnp.sum(mask, axis=-1)
    degenerate = (num < 2)[..., None, None]
    a_mat = jnp.where(degenerate, eye, a_mat)
    x = jnp.linalg.solve(a_mat, b_vec[..., None])[..., 0]

    # fallback for < 2 lines: first valid line's second point
    first_idx = jnp.argmax(mask, axis=-1)
    fallback = jnp.take_along_axis(
        points_b, first_idx[..., None, None].repeat(3, -1), axis=-2)[..., 0, :]
    point = jnp.where(degenerate[..., 0], fallback, x)

    # mean distance from point to each masked line (ref :965-979)
    lam = jnp.sum(d * (point[..., None, :] - points_a), -1)
    foot = points_a + lam[..., None] * d
    dist = jnp.linalg.norm(foot - point[..., None, :], axis=-1)
    mean_dist = jnp.sum(dist * mask, -1) / jnp.maximum(num, 1)
    mean_dist = jnp.where(num < 2, 0.0, mean_dist)
    return point, mean_dist, num


def nview_ground_reconstruction(ground_points, mask):
    """Mean of per-camera ground-plane points + mean scatter distance
    (full-body PETS mode, ref PSNWhere_Associator3D.cpp:995-1046 with
    CONSIDER_SENSITIVITY=false).

    Args:
      ground_points: [..., N, 3] per-camera ground points (z==0).
      mask:          [..., N] bool.

    Returns (point [..., 3], mean_distance [...], num_points [...]).
    mean_distance is 0 when fewer than 2 points (caller applies the
    MAX_BODY_WIDTH/2 fallback, ref :1030-1036).
    """
    m = mask[..., None].astype(ground_points.dtype)
    num = jnp.sum(mask, axis=-1)
    denom = jnp.maximum(num, 1)[..., None]
    point = jnp.sum(ground_points * m, axis=-2) / denom
    dist = jnp.linalg.norm(point[..., None, :] - ground_points, axis=-1)
    mean_dist = jnp.sum(dist * mask, axis=-1) / jnp.maximum(num, 1)
    mean_dist = jnp.where(num < 2, 0.0, mean_dist)
    return point, mean_dist, num


def segments_intersect(a1, a2, b1, b2):
    """2D (x, y) segment intersection test, batched
    (ref psn_where/PSNWhere_Utils.cpp:472-487)."""
    s1x = a2[..., 0] - a1[..., 0]
    s1y = a2[..., 1] - a1[..., 1]
    s2x = b2[..., 0] - b1[..., 0]
    s2y = b2[..., 1] - b1[..., 1]
    den = -s2x * s1y + s1x * s2y
    safe = jnp.where(jnp.abs(den) < 1e-12, 1.0, den)
    s = (-s1y * (a1[..., 0] - b1[..., 0]) + s1x * (a1[..., 1] - b1[..., 1])) / safe
    t = (s2x * (a1[..., 1] - b1[..., 1]) - s2y * (a1[..., 0] - b1[..., 0])) / safe
    hit = (s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
    return hit & (jnp.abs(den) >= 1e-12)
