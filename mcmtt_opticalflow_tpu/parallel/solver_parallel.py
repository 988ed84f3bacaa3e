"""Distributed hypothesis solving: replica-sharded BLS + collective K-best.

The reference solves its K hypotheses on OpenMP threads in one address
space (ref psn_where/PSNWhere_Associator3D.cpp:2676-2684).  Here each mesh
'block' shard runs an independent set of BLS replicas with its own PRNG
stream (shard_map), and the global best solution is selected by an
all_gather of per-shard best scores + argmax over the 'block' axis — the
"score allreduce + argmax selection over collectives" design of
BASELINE.json's north star.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mcmtt_opticalflow_tpu.config import SolverConfig
from mcmtt_opticalflow_tpu.models.mwcp import solve_mwcp


def solve_mwcp_sharded(weights, adj, valid, init_mask, key,
                       mesh: Mesh, cfg: SolverConfig, iters: int = 500):
    """Solve one MWCP instance with replicas spread across the 'block' axis.

    Each shard runs cfg.num_replicas BLS replicas locally; the winning
    clique is chosen by a collective score comparison over the mesh.

    Returns (best_mask [V] bool, best_score scalar, all_masks [B*R, V],
    all_scores [B*R]) with B = number of 'block' shards.
    """
    nblock = mesh.shape["block"]
    keys = jax.random.split(key, nblock)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("block")),
        out_specs=(P(), P(), P("block"), P("block")),
        check_vma=False)
    def run(w, a, v, init, k):
        res = solve_mwcp(w, a, v, init, k[0], cfg, iters)
        # local best across this shard's replicas
        li = jnp.argmax(res.best_score)
        local_best = res.best_score[li]
        local_mask = res.best_mask[li]
        # collective selection over the block axis
        scores = jax.lax.all_gather(local_best, "block")       # [B]
        masks = jax.lax.all_gather(local_mask, "block")        # [B, V]
        gi = jnp.argmax(scores)
        return masks[gi], scores[gi], res.best_mask, res.best_score

    return run(weights, adj, valid, init_mask, keys)
