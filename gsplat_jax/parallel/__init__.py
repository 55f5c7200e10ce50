"""Multi-chip / multi-host scale-out (shard_map over a jax.sharding.Mesh).

Two sharding modes (both keep Gaussian parameters + Adam state replicated):
- data_parallel: one camera per chip (a capability extension over the
  reference's single image/step), gradients psum'd over ICI;
- tile_parallel: ONE camera's tile rows sharded across chips (the
  workload's sequence-parallel analogue) for very high resolutions.

``initialize_multihost`` wires jax.distributed for multi-process runs; in
one process it is a no-op.
"""

from __future__ import annotations

from .data_parallel import dp_train_step, get_dp_train_step, make_mesh
from .tile_parallel import get_tp_train_step, make_tile_mesh, tp_train_step

__all__ = [
    "dp_train_step",
    "get_dp_train_step",
    "make_mesh",
    "tp_train_step",
    "get_tp_train_step",
    "make_tile_mesh",
    "initialize_multihost",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed for multi-process training.

    Nothing discovers a cluster on its own, so a multi-process run passes
    all three: the coordinator's ``host:port``, the process count and this
    process's id. Collectives in dp/tp_train_step then span all processes'
    devices: build the mesh from ``jax.devices()`` (global) and feed each
    process its own cameras via the usual shard_map in_specs.

    No-op for a single process (no coordinator, at most one process).
    """
    import jax

    if coordinator_address is None and num_processes in (None, 1):
        return
    if coordinator_address is None or num_processes is None or (
        process_id is None
    ):
        raise ValueError(
            "multi-process runs need coordinator_address, num_processes "
            "and process_id"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
