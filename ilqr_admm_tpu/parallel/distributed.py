"""Multi-host orchestration helpers (JAX multi-controller SPMD).

The reference is single-process (SURVEY §2.3); the scale-out story is
standard JAX SPMD. On one host, one process drives all its GPUs (four
NVLink-joined cards, all to all) and needs none of this module. Across
hosts, every host runs the same program, `jax.distributed.initialize`
wires the runtime, the global mesh spans every card, and the instance
axis shards across hosts while `psum` reductions ride NCCL.

Collective traffic in this problem class is tiny relative to compute
(duals are O(N·d) per instance), so scaling efficiency is a
batching/occupancy problem, not a bandwidth one (SURVEY §5).

Usage on several hosts (same script on every host):

    from ilqr_admm_tpu.parallel import distributed, make_mesh
    distributed.initialize("host0:1234", num_processes=2, process_id=i)
    mesh = make_mesh()                # spans all global devices
    ...
    # host-local shard of the instance batch:
    x0s_local = distributed.host_shard(x0s_global)
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the multi-controller runtime; no-op when single-process.

    Pass the coordinator address ("host:port"), the number of processes
    and this process's id — nothing on a GPU host detects a cluster by
    itself. `JAX_NUM_PROCESSES` stands in for `num_processes`. Returns
    True when a multi-process runtime was initialized.
    """
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    multi_env = coordinator_address is not None or (num_processes or 1) > 1
    if not multi_env:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # only the "already initialized" case (single-host interactive
        # use) degrades gracefully; a coordinator/handshake failure on a
        # real multi-host run must NOT silently fall back to single-host
        # (each host would compute independent "global" results)
        if "already" in str(e).lower():
            return False
        raise
    return jax.process_count() > 1


def host_shard(global_array: np.ndarray) -> np.ndarray:
    """This host's contiguous shard of a host-replicated instance batch.

    Remainder instances (batch % process_count) go one-per-host to the
    first hosts, so every instance is assigned exactly once (shards may
    differ in length by 1 — pass through `make_global_batch` for ragged
    assembly, or size batches divisibly for fully uniform shards).
    """
    n = jax.process_count()
    i = jax.process_index()
    per, rem = divmod(global_array.shape[0], n)
    start = i * per + min(i, rem)
    stop = start + per + (1 if i < rem else 0)
    return global_array[start:stop]


def make_global_batch(local_batch, mesh, axis: str = "data"):
    """Assemble a global sharded array from per-host local shards.

    Wraps `jax.make_array_from_process_local_data` so batched solvers can
    consume a (global_batch, ...) array sharded over the instance axis.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_batch))
