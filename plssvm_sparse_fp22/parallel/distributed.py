"""Multi-host (DCN) initialization.

JAX replacement for the reference's missing multi-node story
(SURVEY.md §2.4 item 4: no NCCL/MPI/Gloo — its all-reduce is host-staged and
single-node).  On a multi-host GPU cluster every host runs the same
program; ``initialize_distributed`` wires them into one JAX runtime so the
row-sharded training in ``parallel/sharded.py`` spans all devices: the
identical ``shard_map`` code then rides NVLink within a host and the
network across hosts.

Typical usage (one process per host)::

    from plssvm_sparse_fp22.parallel import distributed, mesh, sharded

    distributed.initialize_distributed("host0:1234", num_processes, rank)
    m = mesh.make_mesh()                          # all global devices
    learn = sharded.make_sharded_learn(m, kernel, degree, "implicit")

Each host feeds its local rows via ``jax.make_array_from_process_local_data``
(helper below), so datasets larger than any single host's memory stream in
shard-by-shard.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """``jax.distributed.initialize`` (cluster auto-detection when the
    arguments are omitted, as on SLURM).

    Returns True when a multi-process runtime was initialized (idempotent;
    False on single-process setups where initialization isn't needed).
    """
    # NB: probe via is_initialized(), NOT jax.process_count() — the latter
    # initializes the local backend, after which distributed init is refused
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return jax.process_count() > 1
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return jax.process_count() > 1
    except (ValueError, RuntimeError):
        # single-process / no coordinator configured: run locally
        return False


def make_global_row_sharded(mesh, local_rows: np.ndarray):
    """Assemble a globally row-sharded array from per-process local rows.

    Each process passes its own block of rows; the result is one logical
    (global_rows, ...) array sharded over the mesh's data axis across all
    hosts — rows never gather on a single host.
    """
    sharding = NamedSharding(mesh, P(DATA_AXIS, *([None] * (local_rows.ndim - 1))))
    return jax.make_array_from_process_local_data(sharding, local_rows)
