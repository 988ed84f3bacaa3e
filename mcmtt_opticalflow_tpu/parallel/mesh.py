"""Device mesh and sharding specs.

The reference has no distribution model at all (OpenMP threads only,
ref psn_where/PSNWhere.cpp:49,257; PSNWhere_Associator3D.cpp:2676), so the
engine *introduces* one along the reference's natural concurrency axes
(SURVEY.md §2 parallelism table):

  * 'cam'   — camera streams: the per-camera 2D stage is embarrassingly
              data-parallel; cross-camera exchange happens only at
              tracklet level (small tensors).
  * 'block' — track blocks / solver replicas: window scoring, the pairwise
              compatibility matrix and BLS replicas shard here; the global
              K-best selection is a collective score reduction.

Multi-host: `jax.distributed.initialize` + the same mesh spanning all
processes.  The cards of one host reach each other all to all at one
rate (NVLink), so the mesh's shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_cam_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('cam', 'block') mesh over the available devices.

    num_cam_shards defaults to the largest power-of-two <= min(4, n).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if num_cam_shards is None:
        num_cam_shards = 1
        while (num_cam_shards * 2 <= min(4, n)
               and n % (num_cam_shards * 2) == 0):
            num_cam_shards *= 2
    assert n % num_cam_shards == 0, (n, num_cam_shards)
    arr = np.asarray(devices).reshape(num_cam_shards, n // num_cam_shards)
    return Mesh(arr, ("cam", "block"))


def cam_sharding(mesh: Mesh, *rest) -> NamedSharding:
    """Leading axis over cameras."""
    return NamedSharding(mesh, P("cam", *rest))


def block_sharding(mesh: Mesh, *rest) -> NamedSharding:
    """Leading axis over track blocks / solver replicas."""
    return NamedSharding(mesh, P("block", *rest))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leaves(tree, sharding: NamedSharding):
    """device_put every leaf with the given sharding."""
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


class AsyncFetch:
    """Background-thread device->host fetch.

    Started right after dispatch, the blocking fetch waits for the device
    program and copies its result on a thread, overlapping that wait with
    the caller's host work (the GIL is released while it waits); get()
    joins."""

    def __init__(self, tree):
        import threading

        self._out = None
        self._err = None

        def run():
            try:
                self._out = fetch(tree)
            except BaseException as e:          # surfaced at get()
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def get(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


def fetch(tree):
    """device_get that also works under multi-process meshes: leaves whose
    shards live partly on other hosts (non-fully-addressable) are pulled
    with a cross-process all-gather instead.  Single-process arrays take
    the plain device_get fast path."""
    leaves = jax.tree.leaves(tree)
    if all(getattr(x, "is_fully_addressable", True) for x in leaves):
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    def one(x):
        if getattr(x, "is_fully_addressable", True):
            return np.asarray(jax.device_get(x))
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))

    return jax.tree.map(one, tree)
