"""Batched Breakout Local Search for the maximum-weight clique problem.

The reference selects each frame's K-best global hypotheses by running a
*serial* BLS chain per hypothesis over a track-compatibility graph
(hj::CGraphSolver, psn_where/GraphSolver.cpp:532-669), parallelised only by
OpenMP across hypotheses (ref PSNWhere_Associator3D.cpp:2676-2684).

Device redesign: R independent replicas per hypothesis run *in lockstep* as
one vectorised while-loop —

  * membership is a [V] bool mask; neighbour counts are a single
    adjacency matvec;
  * the PA (insert) and OM (swap) move sets of the reference
    (GraphSolver.h:216-219) are boolean masks derived from the counts;
  * swap partners resolve via a complement-adjacency matvec;
  * the adaptive perturbation (directed vs random, strength L escalating
    L0 -> Lmax, tabu tenure Phi + rand*|OM|; ref GraphSolver.cpp:1173-1184,
    527-531, 1658-1661) runs one move per iteration with per-replica PRNG
    streams (deterministic, replacing rand());
  * every distinct local optimum lands in a per-replica ring buffer —
    preserving the reference's "collect all local optima, dedup, sort"
    K-best semantics (GraphSolver.cpp:967-975, 644-660).

Hypotheses batch over the leading axis with vmap, so the whole K-hypothesis
formation step is one device program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmtt_opticalflow_tpu.config import SolverConfig

NEG = -1e30


class MwcpResult(NamedTuple):
    best_mask: jnp.ndarray      # [R, V] bool, per-replica best clique
    best_score: jnp.ndarray     # [R]
    sol_masks: jnp.ndarray      # [R, S, V] bool local-optima ring buffers
    sol_scores: jnp.ndarray     # [R, S] (NEG = empty slot)


def _greedy_initial(weights, adj, valid, order):
    """Greedy weight-descending clique construction
    (ref BLS_GenerateInitialSolution, GraphSolver.cpp:986-1090)."""
    v = weights.shape[0]

    def body(i, in_c):
        idx = order[i]
        cnt = jnp.sum(adj[idx] & in_c)
        can = (valid[idx] & (weights[idx] >= 0.0)
               & (cnt == jnp.sum(in_c)))
        return in_c.at[idx].set(in_c[idx] | can)

    return jax.lax.fori_loop(0, v, body, jnp.zeros((v,), bool))


def _move_sets(in_c, adj, valid):
    """cnt, csize, PA mask, OM mask (ref GraphSolver.h:216-219)."""
    cnt = jnp.sum(adj & in_c[None, :], axis=-1)
    csize = jnp.sum(in_c)
    pa = valid & ~in_c & (cnt == csize)
    om = valid & ~in_c & (cnt == csize - 1) & (csize > 0)
    return cnt, csize, pa, om


def _gumbel_pick(g, mask):
    """Uniform random index among True entries (NEG-masked gumbel argmax).
    g is a pregenerated gumbel field of mask's shape."""
    return jnp.argmax(jnp.where(mask, g, NEG)), jnp.any(mask)


@functools.partial(jax.jit, static_argnames=("cfg", "iters"))
def solve_mwcp(weights: jnp.ndarray,
               adj: jnp.ndarray,
               valid: jnp.ndarray,
               init_mask: jnp.ndarray,
               key: jnp.ndarray,
               cfg: SolverConfig,
               iters: int | None = None) -> MwcpResult:
    """Solve one max-weight-clique instance with R lockstep BLS replicas.

    Args:
      weights:   [V] vertex weights (track log-likelihoods).
      adj:       [V, V] bool symmetric compatibility, diag False.
      valid:     [V] bool vertex mask.
      init_mask: warm starts (ref BLS_SetInitialSolutions,
                 GraphSolver.cpp:820-956).  Either [V] bool — replica 0
                 starts here when it is a valid clique — or [R', V] bool
                 with R' <= R: replica i starts from row i when that row
                 is a valid nonempty clique (one row per carried
                 hypothesis; the engine solves ONE instance per frame with
                 all K hypotheses as warm-started replicas instead of K
                 separate instances — the union pool and the merged
                 local-optima K-best make the two equivalent, without the
                 K-fold device cost of the reference's per-hypothesis
                 OpenMP solves, ref Associator3D.cpp:2676-2684).
      key:       PRNG key.

    vmap over a leading axis for a batch of instances.
    """
    v = weights.shape[0]
    r = cfg.num_replicas
    s = cfg.solutions_per_replica
    if iters is None:
        iters = cfg.max_iterations
    l0 = jnp.maximum(cfg.l0_ratio * jnp.sum(valid), 1.0)
    lmax = jnp.maximum(cfg.lmax_ratio * jnp.sum(valid), 2.0)

    # normalise warm starts to one [R, V] stack (False rows = cold start)
    if init_mask.ndim == 1:
        init_mask = init_mask[None, :]
    warm = jnp.zeros((r, v), bool)
    rw = min(init_mask.shape[0], r)
    warm = warm.at[:rw].set(init_mask[:rw])

    # ---- initial solutions per replica -------------------------------------
    order = jnp.argsort(-jnp.where(valid, weights, NEG))
    greedy = _greedy_initial(weights, adj, valid, order)

    def replica_init(i, k, wm):
        # replica i: its warm start if that is a valid nonempty clique
        # (invalidated rows fall back like the reference's validity check,
        # GraphSolver.cpp:830-868); else greedy from a randomly perturbed
        # weight order (one replica keeps the unperturbed greedy order)
        cnt = jnp.sum(adj & wm[None, :], axis=-1)
        is_clique = jnp.all(~wm | (cnt == jnp.sum(wm) - 1)) \
            & jnp.any(wm) & jnp.all(~wm | valid)
        noise = jax.random.uniform(k, (v,)) * jnp.where(i == 0, 0.0, 1.0) \
            * jnp.maximum(jnp.max(jnp.abs(weights)), 1.0) * 0.3
        ordr = jnp.argsort(-jnp.where(valid, weights + noise, NEG))
        g = _greedy_initial(weights, adj, valid, ordr)
        return jnp.where(is_clique, wm, jnp.where(i == 0, greedy, g))

    keys = jax.random.split(key, r + 1)
    in_c0 = jax.vmap(replica_init)(jnp.arange(r), keys[:r], warm)  # [R, V]

    score0 = jnp.sum(jnp.where(in_c0, weights[None, :], 0.0), -1)

    class _S(NamedTuple):
        in_c: jnp.ndarray        # [R, V]
        tabu: jnp.ndarray        # [R, V] int32 iteration stamp
        fbest: jnp.ndarray       # [R]
        best: jnp.ndarray        # [R, V]
        cp: jnp.ndarray          # [R, V] previous local optimum
        w: jnp.ndarray           # [R] non-improving counter
        l_left: jnp.ndarray      # [R] perturbation moves remaining
        use_directed: jnp.ndarray  # [R] bool, current perturbation flavour
        sol_masks: jnp.ndarray   # [R, S, V]
        sol_scores: jnp.ndarray  # [R, S]
        sol_next: jnp.ndarray    # [R] ring position
        it: jnp.ndarray          # scalar

    def record(sol_masks, sol_scores, sol_next, mask, score, do):
        """Insert a local optimum unless empty/negative/duplicate
        (ref BLS_InsertSolution + CheckSolutionExistance,
        GraphSolver.cpp:686-701, 967-975)."""
        dup = jnp.any((jnp.abs(sol_scores - score) < 1e-5)
                      & jnp.all(sol_masks == mask[None, :], axis=-1))
        ok = do & ~dup & (score > 0.0) & jnp.any(mask)
        slot = sol_next % s
        sol_masks = jnp.where(ok, sol_masks.at[slot].set(mask), sol_masks)
        sol_scores = jnp.where(ok, sol_scores.at[slot].set(score), sol_scores)
        return sol_masks, sol_scores, sol_next + ok.astype(jnp.int32)

    # f32 adjacency views: the per-iteration neighbour counts and partner
    # weights become batched matvecs instead of [V, V] masked reductions.
    # HIGHEST precision: the partner weights feed weight DIFFERENCES
    # (swap gains), which a TF32 product would round away
    adj_f = adj.astype(jnp.float32)
    adjc_f = (~adj).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST

    def one_replica_step(st_in_c, st_tabu, st_fbest, st_best, st_cp, st_w,
                         st_l, st_dir, st_sm, st_ss, st_sn, it,
                         u_dir, g_dir, u_ten, g_rnd):
        in_c_f = st_in_c.astype(jnp.float32)
        cnt = jnp.matmul(adj_f, in_c_f, precision=hi).astype(jnp.int32)
        csize = jnp.sum(st_in_c)
        pa = valid & ~st_in_c & (cnt == csize)
        om = valid & ~st_in_c & (cnt == csize - 1) & (csize > 0)
        fc = jnp.sum(jnp.where(st_in_c, weights, 0.0))

        # swap partner weights via complement matvec (diag of ~adj is True
        # but only contributes for vertices already in C, never OM ones)
        in_w = in_c_f * weights
        w_partner = jnp.matmul(adjc_f, in_w, precision=hi)
        gain_ins = jnp.where(pa, weights, NEG)
        gain_swp = jnp.where(om, weights - w_partner, NEG)

        bi = jnp.argmax(gain_ins)
        bs = jnp.argmax(gain_swp)
        gi, gs = gain_ins[bi], gain_swp[bs]
        use_swap = gs > gi
        gain = jnp.maximum(gi, gs)
        mv_v = jnp.where(use_swap, bs, bi)
        partner = jnp.argmax(st_in_c & ~adj[mv_v])
        improving = gain > 1e-9

        searching = st_l <= 0

        # ---- local-search move -------------------------------------------
        ls_in_c = st_in_c.at[mv_v].set(True)
        ls_in_c = jnp.where(use_swap, ls_in_c.at[partner].set(False), ls_in_c)
        do_ls = searching & improving

        # ---- local optimum event -----------------------------------------
        at_opt = searching & ~improving
        better = fc > st_fbest
        new_fbest = jnp.where(at_opt & better, fc, st_fbest)
        new_best = jnp.where(at_opt & better, st_in_c, st_best)
        new_w = jnp.where(at_opt, jnp.where(better, 0, st_w + 1), st_w)

        same_as_cp = jnp.all(st_in_c == st_cp)
        esc = new_w > cfg.t_nonimprove
        l_new = jnp.where(esc, lmax,
                          jnp.where(same_as_cp, st_l + 1.0, l0))
        new_w = jnp.where(at_opt & esc, 0, new_w)
        st_sm, st_ss, st_sn = record(st_sm, st_ss, st_sn, st_in_c, fc,
                                     at_opt & ~same_as_cp & ~esc)
        new_cp = jnp.where(at_opt, st_in_c, st_cp)

        # perturbation flavour (ref BLS_Perturbation, GraphSolver.cpp:1173-1184)
        p = jnp.where(st_w == 0, 0.0,
                      jnp.minimum(jnp.exp(-st_w / cfg.t_nonimprove), cfg.p0))
        directed = u_dir < p
        new_dir = jnp.where(at_opt, directed, st_dir)
        new_l = jnp.where(at_opt, l_new, st_l)

        # ---- perturbation move -------------------------------------------
        perturbing = (st_l > 0) | at_opt
        tabu_ok = st_tabu <= it
        # directed: uniform among {PA insert (tabu ok)} U {OM swap (tabu ok)}
        # U {C removal}
        dir_mask = (pa & tabu_ok) | (om & tabu_ok) | st_in_c
        dv, dany = _gumbel_pick(g_dir, dir_mask)
        d_is_rem = st_in_c[dv]
        d_is_swap = om[dv]
        d_partner = jnp.argmax(st_in_c & ~adj[dv])
        pert_dir = jnp.where(d_is_rem, st_in_c.at[dv].set(False),
                             st_in_c.at[dv].set(True))
        pert_dir = jnp.where(d_is_swap & ~d_is_rem,
                             pert_dir.at[d_partner].set(False), pert_dir)
        # tabu stamp on removed vertices (ref :1658-1661)
        om_count = jnp.sum(om)
        tenure = cfg.phi + (u_ten * jnp.maximum(om_count, 1)
                            ).astype(jnp.int32)
        removed_dir = jnp.where(d_is_rem, dv, jnp.where(d_is_swap, d_partner, -1))

        # random: uniform among OC with (tabu ok | strong neighbourhood),
        # repair by removing non-neighbours (M4, ref GraphSolver.cpp:1281-1338)
        alpha = jnp.where(st_w == 0, cfg.alpha_s, cfg.alpha_r)
        nbr_w_in_c = jnp.matmul(adj_f, in_w, precision=hi)
        rnd_mask = valid & ~st_in_c & (tabu_ok | (nbr_w_in_c >= alpha * fc))
        rv, rany = _gumbel_pick(g_rnd, rnd_mask)
        pert_rnd = (st_in_c & adj[rv]).at[rv].set(True)

        use_dir_now = jnp.where(at_opt, directed, st_dir)
        pert = jnp.where(use_dir_now & dany, pert_dir,
                         jnp.where(rany, pert_rnd, st_in_c))
        do_pert = perturbing

        # ---- combine ------------------------------------------------------
        out_in_c = jnp.where(do_ls, ls_in_c, jnp.where(do_pert, pert, st_in_c))
        # tabu update: stamp vertices that left the solution
        left = st_in_c & ~out_in_c
        new_tabu = jnp.where(left, it + tenure, st_tabu)
        out_l = jnp.where(do_ls, st_l, jnp.maximum(new_l - 1.0, 0.0))
        return (out_in_c, new_tabu, new_fbest, new_best, new_cp, new_w,
                out_l, new_dir, st_sm, st_ss, st_sn)

    # pregenerate ALL the loop's randomness in one parallel pass — the
    # per-iteration threefry splits otherwise dominate the (latency-bound)
    # while-loop body
    unroll = max(int(cfg.unroll), 1)
    iters_pad = ((iters + unroll - 1) // unroll) * unroll
    ku1, kg2, ku3, kg4 = jax.random.split(keys[r], 4)
    u_dir_all = jax.random.uniform(ku1, (iters_pad, r))
    g_dir_all = jax.random.gumbel(kg2, (iters_pad, r, v))
    u_ten_all = jax.random.uniform(ku3, (iters_pad, r))
    g_rnd_all = jax.random.gumbel(kg4, (iters_pad, r, v))

    def substep(st: _S) -> _S:
        outs = jax.vmap(one_replica_step)(
            st.in_c, st.tabu, st.fbest, st.best, st.cp, st.w, st.l_left,
            st.use_directed, st.sol_masks, st.sol_scores, st.sol_next,
            jnp.broadcast_to(st.it, (r,)),
            u_dir_all[st.it], g_dir_all[st.it], u_ten_all[st.it],
            g_rnd_all[st.it])
        return _S(*outs, st.it + 1)

    def step(st: _S) -> _S:
        # each while-loop trip applies `unroll` BLS moves: the per-move
        # compute is microscopic (a [V, R] matmul pair), so wall-clock is
        # loop-carry latency — unrolling cuts the trip count `unroll`-fold
        # for the same move sequence
        for _ in range(unroll):
            st = substep(st)
        return st

    st0 = _S(
        in_c=in_c0,
        tabu=jnp.zeros((r, v), jnp.int32),
        fbest=score0,
        best=in_c0,
        cp=in_c0,
        w=jnp.zeros((r,), jnp.int32),
        l_left=jnp.zeros((r,)),
        use_directed=jnp.zeros((r,), bool),
        sol_masks=jnp.zeros((r, s, v), bool),
        sol_scores=jnp.full((r, s), NEG),
        sol_next=jnp.zeros((r,), jnp.int32),
        it=jnp.asarray(0, jnp.int32),
    )
    # seed ring buffers with the initial solutions
    sm, ss, sn = jax.vmap(
        lambda m, sc, a, b, c: record(a, b, c, m, sc, jnp.asarray(True)))(
        in_c0, score0, st0.sol_masks, st0.sol_scores, st0.sol_next)
    st0 = st0._replace(sol_masks=sm, sol_scores=ss, sol_next=sn)

    st = jax.lax.while_loop(lambda s_: s_.it < iters_pad, step, st0)

    # fold the final bests into the ring buffers
    sm, ss, sn = jax.vmap(
        lambda m, sc, a, b, c: record(a, b, c, m, sc, jnp.asarray(True)))(
        st.best, st.fbest, st.sol_masks, st.sol_scores, st.sol_next)
    return MwcpResult(best_mask=st.best, best_score=st.fbest,
                      sol_masks=sm, sol_scores=ss)


solve_mwcp_batch = jax.vmap(solve_mwcp,
                            in_axes=(0, 0, 0, 0, 0, None, None))


def device_k_best(result: MwcpResult, k: int):
    """Device-side top-k distinct local optima: [K, V] masks + [K] scores
    (empty slots score NEG).  Same semantics as collect_k_best — merge all
    replicas' ring buffers, dedup identical cliques, sort by score — but
    traceable, so the fused per-frame program ships K masks to the host
    instead of the full [R, S, V] ring (~20x fewer download bytes).

    Dedup key: identical cliques have identical (score, hash1, hash2);
    two multiplicative int32 hashes over the membership mask make a
    same-score collision between DIFFERENT cliques vanishingly rare."""
    v = result.sol_masks.shape[-1]
    flat_m = result.sol_masks.reshape(-1, v)
    flat_s = result.sol_scores.reshape(-1)
    iota = jnp.arange(v, dtype=jnp.int32)
    salt1 = (iota + 1) * jnp.int32(-1640531527)      # Knuth multiplicative
    salt2 = (iota + 1) * (iota + 7) * jnp.int32(40503)
    m32 = flat_m.astype(jnp.int32)
    h1 = (m32 * salt1[None, :]).sum(-1)
    h2 = (m32 * salt2[None, :]).sum(-1)
    order = jnp.lexsort((h2, h1, -flat_s))
    ss, hh1, hh2 = flat_s[order], h1[order], h2[order]
    dup = jnp.concatenate([
        jnp.zeros((1,), bool),
        (ss[1:] == ss[:-1]) & (hh1[1:] == hh1[:-1]) & (hh2[1:] == hh2[:-1])])
    empty = ss <= NEG / 2
    uniq = ~dup & ~empty
    rank = jnp.cumsum(uniq) - 1                       # rank of each unique
    n = flat_s.shape[0]
    slot = jnp.where(uniq, rank, k)                   # clamp non-unique away
    src = jnp.full((k,), n, jnp.int32).at[slot].min(
        jnp.arange(n, dtype=jnp.int32), mode="drop")  # first row per rank
    got = src < n
    src_safe = jnp.clip(src, 0, n - 1)
    masks = jnp.where(got[:, None], flat_m[order][src_safe], False)
    scores = jnp.where(got, ss[src_safe], NEG)
    return masks, scores


def collect_k_best(result: MwcpResult, k: int):
    """Host-side: merge all replicas' local optima, dedup by (score, mask),
    sort by score descending, return top-k (mask, score) pairs — the
    reference's K-best list semantics (ref GraphSolver.cpp:653-660 +
    Hypothesis_BranchHypotheses dedup, Associator3D.cpp:2797-2828)."""
    import numpy as np

    masks = np.asarray(result.sol_masks).reshape(-1, result.sol_masks.shape[-1])
    scores = np.asarray(result.sol_scores).reshape(-1)
    keep = scores > NEG / 2
    masks, scores = masks[keep], scores[keep]
    order = np.argsort(-scores)
    # identical masks always carry identical scores (score is the mask's
    # weight sum), so dedup hashes the packed mask bytes — O(n), not the
    # reference's O(n^2) pairwise comparison
    packed = np.packbits(masks[order], axis=1)
    out_masks, out_scores = [], []
    seen = set()
    for j, i in enumerate(order):
        key = packed[j].tobytes()
        if key in seen:
            continue
        seen.add(key)
        out_masks.append(masks[i])
        out_scores.append(float(scores[i]))
        if len(out_masks) >= k:
            break
    return out_masks, out_scores
