"""Multi-host launch helpers.

The reference is single-process (SURVEY.md §5 — no distributed backend);
this engine scales across hosts with jax.distributed + one global mesh
of ('cam', 'block') axes: camera shards and solver/track blocks.

Typical 2-host launch (one process per host):

    python -c "from mcmtt_opticalflow_tpu.parallel.launch import init; \
               init('host0:1234', num_processes=2, process_id=0)"
"""

from __future__ import annotations

from typing import Optional

import jax


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialise jax.distributed for multi-host operation.  With no
    arguments, JAX's cluster auto-detection supplies them (a cluster
    manager such as SLURM); elsewhere pass all three."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(num_cam_shards: Optional[int] = None):
    """Mesh over ALL devices of every process (call after init())."""
    from mcmtt_opticalflow_tpu.parallel.mesh import make_mesh

    return make_mesh(num_cam_shards=num_cam_shards, devices=jax.devices())


def scaling_report(mesh, frames_per_sec_1chip: float,
                   frames_per_sec_mesh: float) -> dict:
    """Scaling-efficiency record for BASELINE.json's 1 chip / 1 host /
    N hosts measurement protocol."""
    n = mesh.size
    ideal = frames_per_sec_1chip * n
    return {
        "devices": n,
        "mesh": dict(mesh.shape),
        "fps_1chip": frames_per_sec_1chip,
        "fps_mesh": frames_per_sec_mesh,
        "scaling_efficiency": (frames_per_sec_mesh / ideal) if ideal else 0.0,
    }
