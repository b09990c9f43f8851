"""Matmul-precision policy.

On the GPU an f32 matmul at default precision may run in TF32 on the
tensor cores (10 mantissa bits, ~1e-3 relative), which is catastrophic
for this problem class (NaN Cholesky factors at the reference's 1e6
cost weights, diverging ADMM iterates, ADMM converging to the optimum
of a perturbed problem — see docs/architecture.md §4). Every solver/op
whose accuracy feeds a factorization, a recursion, or an accept/reject
decision traces under HIGHEST precision (IEEE f32) via this decorator.
Hot kernels that manage precision explicitly (the in-kernel product
precision of `ops/pallas_admm.py`, pinned `_mm` in `solvers/batched.py`)
opt out deliberately.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Trace fn under default_matmul_precision('highest')."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper


def use_x64():
    """Enable float64 globally (native on the GPU, at a lower rate than f32).

    Required for weight ratios beyond ~1e7 (e.g. the 3DoF arm benchmark's
    x_std=1e6 / u_std=1e-4): no f32 formulation survives condition numbers
    past ~1e7 in the Riccati/lifted solves. Call before creating arrays.
    """
    jax.config.update("jax_enable_x64", True)


def stiffness_ratio(Q, R) -> float:
    """max state weight / min positive control weight — the conditioning
    driver of this problem class."""
    import jax.numpy as jnp

    q_max = float(jnp.max(jnp.abs(Q)))
    r_diag = jnp.abs(jnp.diagonal(R, axis1=-2, axis2=-1))
    r_min = float(jnp.min(jnp.where(r_diag > 0, r_diag, jnp.inf)))
    if not (r_min < float("inf")):  # all-zero R: worst conditioning
        return float("inf") if q_max > 0 else 0.0
    return q_max / r_min
