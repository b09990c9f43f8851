"""ilqr_admm_tpu — accelerator-native constrained robust optimal control.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference `isls` library (chenjianxing1/iLQR-ADMM): finite-horizon
LQT / iLQR solvers, ADMM constraint splitting with a projection-operator
library, and robust System Level Synthesis (SLS) with chance constraints —
redesigned for batched accelerator execution:

- Riccati backward passes and rollouts are `lax.scan` recursions (O(N)
  memory) instead of Python loops (reference `sls.py:122-162`,
  `isls.py:261-334`).
- The Woodbury rank-downdate inverse cascade (reference `base.py:32-53`)
  is replaced by a single Cholesky of the time-reversed lifted normal
  matrix + batched masked triangular solves
  (`ops/sls_synthesis.py`).
- Line search, Monte-Carlo validation and multi-start solves are
  `vmap`-batched; instance batches shard over a `jax.sharding.Mesh`
  (`parallel/`).
- Projections are branchless vectorized ops; intersection projections
  (consensus ADMM / Dykstra) are bounded-iteration scans.

The public facade (`SLS`, `iSLS`) mirrors the reference API
(`isls/__init__.py:1-4`) so reference users can switch directly, while
`ilqr_admm_tpu.solvers` exposes the functional, jit/vmap/shard_map-ready
core.
"""

from ilqr_admm_tpu.problem import (
    LQTProblem,
    QuadCost,
    ADMMConfig,
    ILQRConfig,
    SolveStatus,
)
from ilqr_admm_tpu.facade import SLS, iSLS
from ilqr_admm_tpu.utils.cost_assembly import (
    find_mus,
    find_precs,
    get_double_integrator_AB,
    run_once,
)
from ilqr_admm_tpu.projections import *  # noqa: F401,F403 — mirrors reference `from isls.projections import *`
from ilqr_admm_tpu.chance import (
    ChanceCalibration,
    calibrate,
    count_binding_rows,
    make_box_chance_projection,
    make_state_box_chance_projection,
    per_row_confidence,
)

__version__ = "0.1.0"

__all__ = [
    "SLS",
    "iSLS",
    "ChanceCalibration",
    "calibrate",
    "count_binding_rows",
    "make_box_chance_projection",
    "make_state_box_chance_projection",
    "per_row_confidence",
    "LQTProblem",
    "QuadCost",
    "ADMMConfig",
    "ILQRConfig",
    "SolveStatus",
    "find_mus",
    "find_precs",
    "get_double_integrator_AB",
    "run_once",
]
