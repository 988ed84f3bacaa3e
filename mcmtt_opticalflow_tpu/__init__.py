"""mcmtt_opticalflow_tpu — multi-camera multi-target tracking engine.

A from-scratch JAX/XLA re-design of the capabilities of the reference
MCMTT_OPTICALFLOW ("PSN_Where") system: per-camera 2D tracklet generation via
pyramidal Lucas-Kanade optical flow, cross-camera 3D reconstruction and MHT
association, K-best global hypothesis selection via a maximum-weight-clique
solver, Savitzky-Golay trajectory smoothing, and CLEAR-MOT evaluation.

Design stance (batched device programs, not a port):
  * struct-of-arrays state with fixed capacities + validity masks
    (replaces the reference's pointer-linked std::list/deque data model,
    psn_where/PSNWhere_Types.h:258-469)
  * batched / vmapped device kernels for every hot loop
    (LK pyramids, pairwise gating, track scoring, clique search)
  * host-side Python only for variable-topology bookkeeping
    (track-tree tables, id allocation, dataset I/O)
  * pjit/shard_map over a (cam, block) device mesh for multi-device scale-out
"""

import contextlib
import os

__version__ = "0.1.0"

# persistent XLA compilation cache: the engine's device programs (the 2D
# step, the fused rescore+solve with its BLS while-loop) take seconds to
# compile; cache them across processes.  The path is part of the cache's
# key, so it is one fixed directory: JAX_COMPILATION_CACHE_DIR when set
# (JAX reads it itself), else `.jax_cache` at the checkout root.
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ=os.environ):
    """The directory this package points JAX's compile cache at, or None
    when it sets none: JAX_COMPILATION_CACHE_DIR is set, or the run is
    pinned to the CPU (XLA:CPU entries are machine-specific, and CPU runs
    stay out of the accelerator's cache)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if environ.get("JAX_PLATFORMS", "").lower().startswith("cpu"):
        return None
    return CACHE_DIR


def _setup_compile_cache() -> None:
    cache_dir = compile_cache_dir()
    if cache_dir is None:
        return
    import jax

    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)


_setup_compile_cache()


@contextlib.contextmanager
def persistent_cache_off():
    """Compile with JAX's persistent cache neither read nor written.

    For programs compiled for the CPU inside an accelerator process (the
    CPU references of a device program): XLA:CPU executables are built
    for this host's CPU features and must not reach a cache that other
    hosts load.  JAX decides once per process whether the cache is used;
    reset_cache makes it decide again on entry and on exit."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as cc

    was = jax.config.jax_enable_compilation_cache
    cc.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        cc.reset_cache()

from mcmtt_opticalflow_tpu.config import (  # noqa: F401
    EngineConfig,
    Tracker2DConfig,
    Associator3DConfig,
    SolverConfig,
    EvalConfig,
)
