"""Fleet-level early exit on the certified arm workload.

Per-instance early exit on the vmapped `ilqr_admm` path comes from
JAX's vmap-of-while_loop semantics: the batching rule rewrites the
outer while_loop to `while any(cond)` with select-masked carries, so a
converged instance freezes (exact per-instance stopping — the SPMD
analogue of the reference's per-problem loop, `admm.py:72-85`) and the
FLEET exits as soon as the last instance converges. This study measures
what that is worth on the certified arm workload (bench_arm_admm.py
fixture: all instances converge in <= 4 outer iterations) against the
same solver with the convergence tests disabled (outer_tol = osc_tol
= 0 → every instance runs the full max_iter=12 budget).

Prints one JSON line with both rates and the speedup; asserts the two
schedules land on the same costs (early exit must not change results).
"""

import json
import os

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from benchmarks._certify import timed_rate
from ilqr_admm_tpu.models.arm import PlanarArm
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

U_BOUND = 2.5


def main(batch=1024):
    N = 100
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e4, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0], jnp.float32)
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0], jnp.float32)
    zs = jnp.stack([jnp.zeros(d, jnp.float32), target])
    Qs = jnp.stack([jnp.zeros((d, d), jnp.float32), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)
    alphas = (10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=jnp.float32))[:5]

    def proj_u(u):
        return jnp.clip(u, -U_BOUND, U_BOUND)

    def make_solve(outer_tol, osc_tol):
        def solve_one(q0):
            x0 = jnp.concatenate([q0, jnp.zeros(n, jnp.float32), arm.fk(q0)])
            u0 = jnp.ones((N, m), jnp.float32)
            x_nom0 = rollout_nonlinear(arm.step, x0, u0)
            res = ilqr_admm(
                arm.step, arm.get_AB, quad, x_nom0, u0,
                quad_cost=quad, project_u=proj_u, rho_u=1e-2,
                max_iter=12, max_admm_iter=20, alphas=alphas, tol=1e-4,
                outer_tol=outer_tol, osc_tol=osc_tol, method="batch",
            )
            return res.cost, res.outer_iters

        return jax.jit(jax.vmap(solve_one))

    solve_exit = make_solve(1e-3, 1e-3)   # default convergence exits
    solve_full = make_solve(0.0, 0.0)     # budget-bound: always 12 outer

    rng = np.random.default_rng(0)
    q0s = jnp.asarray(
        np.array([np.pi / 3, -np.pi / 2, -np.pi / 4]) + rng.normal(0, 0.1, (batch, n)),
        jnp.float32,
    )

    c_e, it_e = solve_exit(q0s)
    c_f, it_f = solve_full(q0s)
    jax.block_until_ready((c_e, c_f))
    # identical solutions up to the extra (converged, no-op) iterations'
    # line-search jitter
    dcost = float(jnp.max(jnp.abs(c_e - c_f) / (jnp.abs(c_f) + 1e-9)))

    rate_exit, _ = timed_rate(lambda: solve_exit(q0s)[0], batch, K=5, reps=3)
    rate_full, _ = timed_rate(lambda: solve_full(q0s)[0], batch, K=5, reps=3)

    out = {
        "metric": "arm_fleet_early_exit_speedup",
        "value": round(rate_exit / rate_full, 2),
        "unit": "speedup of convergence-exit fleet vs fixed 12-outer budget",
        "rate_early_exit": round(rate_exit, 1),
        "rate_fixed_budget": round(rate_full, 1),
        "mean_outer_iters_exit": round(float(jnp.mean(it_e.astype(jnp.float32))), 2),
        "max_rel_cost_delta": float(f"{dcost:.3g}"),
    }
    assert dcost < 5e-2, f"early exit changed solutions: {dcost}"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
