"""Per-phase latency of one boxDDP iteration on the N=500 car (1 chip).

Decomposes the ~6.4 ms/iteration of the single-instance boxDDP row
(HEADTOHEAD: 1.09 s / ~170 iterations) into its four phases — get_AB
Jacobians, get_Cs cost model, the sequential box-QP backward scan, and
the 50-candidate clipped rollout batch — each timed dispatch-amortized
(K iterations chained inside one jit so XLA cannot CSE them; the chain
carry perturbs the input). Identifies which phase a Pallas/parallel
treatment would actually pay on.

Run: python benchmarks/bench_boxddp_phases.py
"""

import os

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.ops.constrained_riccati import (
    ilqr_backward_box,
    rollout_closed_loop_clipped,
)
from ilqr_admm_tpu.ops.riccati import ilqr_backward
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.problem import ILQRConfig, line_search_alphas

f32 = jnp.float32
N = 500
K_CHAIN = 50


def main():
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost()
    rng = np.random.default_rng(0)
    u_nom = jnp.asarray(rng.normal(size=(N, 2)) * 0.1, f32)
    x0 = jnp.asarray([1.0, 1.0, 3 * np.pi / 2, 0.0], f32)
    lo = jnp.asarray([-0.5, -2.0], f32)
    hi = jnp.asarray([0.5, 2.0], f32)
    x_nom = rollout_nonlinear(car.step, x0, u_nom)
    alphas = line_search_alphas(ILQRConfig(max_line_search_iter=50), f32)

    with jax.default_matmul_precision("highest"):
        A, B = car.get_AB(x_nom, u_nom)
        cts, Cts = cost.get_Cs(x_nom, u_nom)

    def chain(fn_scalar_out):
        """Run fn K times inside one dispatch, carry-perturbed."""

        def body(c, _):
            out = fn_scalar_out(c)
            return out * jnp.asarray(1e-30, f32), out

        def run(_):
            return lax.scan(body, jnp.asarray(0.0, f32), None, length=K_CHAIN)[0]

        return jax.jit(run)

    phases = {
        "get_AB": chain(lambda c: jnp.sum(car.get_AB(x_nom + c, u_nom)[0])),
        "get_Cs": chain(lambda c: jnp.sum(cost.get_Cs(x_nom + c, u_nom)[1])),
        "backward_box_enum": chain(
            lambda c: jnp.sum(
                ilqr_backward_box(A, B, Cts + c, cts, u_nom, lo, hi)[1]
            )
        ),
        "backward_unconstrained": chain(
            lambda c: jnp.sum(ilqr_backward(A, B, Cts + c, cts)[1])
        ),
        "rollout_50alphas_clipped": chain(
            lambda c: jnp.sum(
                jax.vmap(
                    lambda a: rollout_closed_loop_clipped(
                        car.step, x_nom[0] + c, jnp.zeros((N, 2, 4), f32),
                        a * u_nom, x_nom, u_nom, lo, hi,
                    )[1]
                )(alphas)
            )
        ),
    }

    for name, fn in phases.items():
        v = float(fn(0.0))  # compile + warm up
        t0 = time.perf_counter()
        v = float(fn(0.0))
        ms = (time.perf_counter() - t0) / K_CHAIN * 1e3
        print(f"{name:26s}: {ms:7.3f} ms/call (dispatch-amortized, K={K_CHAIN})",
              flush=True)


if __name__ == "__main__":
    main()
