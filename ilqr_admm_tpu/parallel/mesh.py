"""Device-mesh helpers for instance-parallel solves.

The parallelism inventory (SURVEY §2.3): the dominant axis of this
problem class is *instance/scenario data parallelism* — ≥10k independent
iLQR-ADMM problem instances (multi-start, scenario sampling, MC
validation) with no cross-instance communication except metric
reductions. Mesh axes:

- 'data'      : problem instances, sharded across devices (NVLink-joined
                cards of one host, or several hosts);
- 'consensus' : optional second axis for consensus-ADMM constraint blocks
                and SLS column blocks.

Collectives ride XLA (`psum` for dual/metric reductions) — no hand-rolled
NCCL/MPI equivalent is needed (reference has none either).
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: Sequence[int] = None, axis_names: Sequence[str] = ("data",)):
    """Create a Mesh over all available devices.

    Default: 1-D ('data',) mesh over every device. Pass axis_sizes to
    factor the devices, e.g. make_mesh((4, 2), ('data', 'consensus')).
    """
    devices = np.asarray(jax.devices())
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    devices = devices[: int(np.prod(axis_sizes))].reshape(axis_sizes)
    return Mesh(devices, axis_names)


def instance_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding that splits the leading (instance) axis over `axis`."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
