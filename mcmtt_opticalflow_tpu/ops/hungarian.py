"""Linear assignment (detection <-> tracker matching).

The reference ports Munkres from MATLAB as a 6-step state machine with
square-padding + infinity preprocessing (psn_where/helpers/PSNWhere_Hungarian.cpp:212-737).
A state machine is the wrong shape for batched device code; the path here is the
Jonker-Volgenant successive-shortest-augmenting-path algorithm expressed
as fixed-shape lax loops: one Dijkstra sweep per valid row, every inner
step a vectorised [C] min/argmin/where, and cameras batch with vmap.  The
result is EXACT (same optimum as scipy) — an earlier epsilon-auction
variant was abandoned because epsilon-complementary-slackness either left
real optimality gaps or degenerated into unbounded +eps bidding wars on
the padded square problems the 2D tracker feeds it.

The host path (`hungarian_host`) is an exact reference via
scipy.optimize.linear_sum_assignment, used by tests to certify the device
solver's optimality and available to host-side callers.

Infinite / forbidden entries follow the reference's convention: they are
replaced by (finite max + margin) before solving, and any match that lands
on such an entry is reported invalid (ref PSNWhere_Tracker2D.cpp:1040-1063).
Both solvers use the SAME margin, so they optimise the same objective.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_INF = 1e18


def hungarian_host(cost: np.ndarray):
    """Exact rectangular min-cost assignment on host.

    Returns (rows, cols) index arrays like scipy's linear_sum_assignment,
    with infinite-cost pairs filtered out.
    """
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, dtype=np.float64)
    finite = np.isfinite(cost)
    if not finite.any():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    big = cost[finite].max() + 100.0
    work = np.where(finite, cost, big)
    rows, cols = linear_sum_assignment(work)
    keep = finite[rows, cols]
    return rows[keep], cols[keep]


@functools.partial(jax.jit, static_argnames=("num_iters",))
def solve_assignment(cost: jnp.ndarray,
                     row_mask: jnp.ndarray,
                     col_mask: jnp.ndarray,
                     num_iters: int = 2000):
    """Exact min-cost assignment (Jonker-Volgenant shortest augmenting
    paths with column potentials).

    Args:
      cost:     [R, C] float cost matrix (np.inf / masked = forbidden).
      row_mask: [R] bool, valid rows.
      col_mask: [C] bool, valid columns.
      num_iters: unused (kept for API compatibility; JV's loop counts are
        intrinsically bounded by the matrix dimensions).

    Returns:
      col_of_row: [R] int32, matched column per row, -1 if unmatched.
      match_cost: [R] float, cost of the match (inf if unmatched).
    """
    r, c = cost.shape
    if r > c:
        # JV below augments one row at a time and needs rows <= cols so a
        # free column always exists; solve the transposed problem and
        # invert the matching
        row_of_col, _ = solve_assignment(cost.T, col_mask, row_mask,
                                         num_iters)
        col_of_row = jnp.full((r,), -1, jnp.int32)
        ok = row_of_col >= 0
        col_of_row = col_of_row.at[jnp.where(ok, row_of_col, r)].set(
            jnp.arange(c, dtype=jnp.int32), mode="drop")
        matched = col_of_row >= 0
        safe = jnp.where(matched, col_of_row, 0)
        mcost = cost[jnp.arange(r), safe]
        return (jnp.where(matched, col_of_row, -1),
                jnp.where(matched, mcost, jnp.inf))

    finite = jnp.isfinite(cost) & row_mask[:, None] & col_mask[None, :]
    maxfin = jnp.max(jnp.where(finite, cost, -jnp.inf))
    maxfin = jnp.where(jnp.isfinite(maxfin), maxfin, 0.0)
    minfin = jnp.min(jnp.where(finite, cost, jnp.inf))
    minfin = jnp.where(jnp.isfinite(minfin), minfin, 0.0)
    span = jnp.maximum(maxfin - minfin, 1.0)
    # normalised working costs in span units keep float32 resolution;
    # forbidden = the normalised image of hungarian_host's max+100
    # substitution, so both solvers optimise the SAME objective
    big = (maxfin + 100.0 - minfin) / span
    w = jnp.where(finite, (cost - minfin) / span, big).astype(jnp.float32)

    cols = jnp.arange(c, dtype=jnp.int32)

    def augment(i, state):
        """Assign row i via one Dijkstra sweep over reduced costs."""
        x, y, v = state          # x[C] row-owning-col, y[R] col-of-row,
        #                          v[C] column potentials
        rm = row_mask[i]
        wi = jnp.where(rm, w[i], 0.0)   # masked rows: trivial sweep

        def dij_body(s):
            dist, par, visited, sink, dsink = s
            dmask = jnp.where(visited, _INF, dist)
            j = jnp.argmin(dmask).astype(jnp.int32)
            dj = dmask[j]
            visited = visited.at[j].set(True)
            owner = x[j]
            free = owner < 0
            # relax through owner's row when the column is taken
            i2 = jnp.clip(owner, 0)
            nd = dj + (w[i2] - v) - (w[i2, j] - v[j])
            upd = (~free) & (~visited) & (nd < dist)
            dist = jnp.where(upd, nd, dist)
            par = jnp.where(upd, i2, par)
            sink = jnp.where(free, j, sink)
            dsink = jnp.where(free, dj, dsink)
            return dist, par, visited, sink, dsink

        dist0 = wi - v
        par0 = jnp.full((c,), i, jnp.int32)
        dist, par, visited, sink, dsink = jax.lax.while_loop(
            lambda s: s[3] < 0, dij_body,
            (dist0, par0, jnp.zeros((c,), bool), jnp.int32(-1),
             jnp.float32(0)))

        # potential update for scanned columns (standard JV: keeps reduced
        # costs non-negative for the next augmentation)
        v = jnp.where(rm & visited & (cols != sink), v + dist - dsink, v)

        # augment: walk the parent chain back from the free column
        def aug_body(s):
            j, x, y, _ = s
            i2 = par[j]
            pj = y[i2]
            y = y.at[i2].set(j)
            x = x.at[j].set(i2)
            return pj, x, y, i2 != i

        def do_augment(args):
            x, y = args
            j, x, y, _ = jax.lax.while_loop(
                lambda s: s[3], aug_body, (sink, x, y, True))
            return x, y

        x, y = jax.lax.cond(rm, do_augment, lambda a: a, (x, y))
        return x, y, v

    x0 = jnp.full((c,), -1, jnp.int32)
    y0 = jnp.full((r,), -1, jnp.int32)
    v0 = jnp.zeros((c,), jnp.float32)
    x, y, v = jax.lax.fori_loop(0, r, augment, (x0, y0, v0))

    col_of_row = y
    matched = col_of_row >= 0
    safe_col = jnp.where(matched, col_of_row, 0)
    mcost = cost[jnp.arange(r), safe_col]
    valid = matched & jnp.isfinite(mcost) & finite[jnp.arange(r), safe_col]
    return (jnp.where(valid, col_of_row, -1),
            jnp.where(valid, mcost, jnp.inf))


solve_assignment_batch = jax.vmap(solve_assignment, in_axes=(0, 0, 0))
