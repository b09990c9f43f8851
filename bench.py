"""Benchmark: batched box-constrained LQT-ADMM fleet, iterations/s.

16,384 double-integrator LQT instances at horizon N=100, |u| <= 5,
rho_u = 0.1, 100 ADMM iterations each. Every ADMM iteration solves the
regularized LQT subproblem (the lifted x-update), applies the box
projection and the dual update. Two named paths:

- `pallas` (default): the fused Triton kernel `ops/pallas_admm.py` —
  the whole iteration loop in one kernel, iterates on chip;
- `xla`: the plain GEMM formulation `solvers/batched.py`.

Runs on the GPU only (no fallback, no CPU run): a path that fails, fails
the benchmark. Gates: zero violation of the projected iterate,
converged_frac >= 0.99 at the reference primal tolerance 1e-4, and the
f64-oracle cost gap <= 1e-4 (median and max) on 64 instances.

Baseline: the reference `ADMM_LQT_DP` runs 500 ADMM iterations in 172 ms
single-instance (BASELINE.md, control-bounds c13) -> ~2,907 iterations/s.

Usage: python bench.py [--path pallas|xla]
Prints exactly one JSON line.
"""

import argparse
import json

import numpy as np

N = 100
BATCH = 16384
ADMM_ITERS = 100
# rho_u = 0.1: the well-scaled penalty for this problem (100% of 16k
# instances under the 1e-4 primal tolerance within 100 iterations); rho
# changes the ADMM trajectory, not the optimum — the oracle gates certify
# that
RHO_U = 1e-1
U_BOUND = 5.0
BATCH_TILE = 16
BASELINE_ITERS_PER_S = 500 / 0.172  # reference ADMM_LQT_DP (BASELINE.md)


def lqt_box_problem(n: int = N):
    """The benchmark plant and cost: DoubleIntegrator(1, 2, dt=1/n),
    terminal target [1, 0] at weight 1e3, control std 1e-2."""
    import jax.numpy as jnp

    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    plant = DoubleIntegrator(1, 2, dt=1.0 / n)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(n, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(n)
    return A.astype(jnp.float32), B.astype(jnp.float32), cost


def initial_states(batch: int, d: int = 2, seed: int = 0):
    """x0 ~ N(0, 0.1^2) per instance, f32."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0.0, 0.1, size=(batch, d)), jnp.float32)


def make_solver(path, A, B, cost, n_iters=ADMM_ITERS, batch_tile=BATCH_TILE,
                precision="tf32x3", interpret=False):
    """solve(x0s) -> (u, z_u): last x-update and projected iterate."""
    import jax
    import jax.numpy as jnp

    if path == "pallas":
        from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm

        solve_p = make_pallas_lqt_admm(
            A, B, cost, u_lower=-U_BOUND, u_upper=U_BOUND, rho_u=RHO_U,
            n_iters=n_iters, batch_tile=batch_tile, precision=precision,
            interpret=interpret,
        )
        return jax.jit(lambda x0s: solve_p(x0s)[1:])
    if path == "xla":
        from ilqr_admm_tpu.projections import project_bound
        from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm

        solve_x = make_batched_lqt_admm(
            A, B, cost, project_u=lambda u: project_bound(u, -U_BOUND, U_BOUND),
            rho_u=RHO_U, n_iters=n_iters,
        )

        def solve(x0s):
            u = solve_x(x0s)[1]
            return u, jnp.clip(u, -U_BOUND, U_BOUND)

        return jax.jit(solve)
    raise ValueError(f"unknown path {path!r}; use 'pallas' or 'xla'")


def _oracle_cost_gap(A, B, cost, x0s, z_u, u_bound=U_BOUND):
    """Relative cost gap of the feasible z-iterates vs an f64 oracle.

    Lifts the f32 problem data exactly to f64 (f32->f64 is exact, so the
    oracle solves the *same* QP in higher precision) and solves each
    box-constrained instance min_u u^T M u - 2 r^T u, |u| <= u_bound with
    L-BFGS-B. Returns (median, max) of (J(z) - J(u*)) / |J(u*)|.
    """
    import jax.numpy as jnp
    from scipy.optimize import minimize

    from ilqr_admm_tpu.ops.lifted import build_Su, sw_x0
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked

    Su = np.asarray(build_Su(A, B), np.float64)
    Q = np.asarray(block_diag_stacked(cost.Q), np.float64)
    R = np.asarray(block_diag_stacked(cost.R), np.float64)
    xd = np.asarray(cost.lifted_xd(), np.float64)
    M = Su.T @ Q @ Su + R
    bounds = [(-u_bound, u_bound)] * M.shape[0]

    gaps = []
    for x0, z in zip(np.asarray(x0s, np.float64), z_u):
        free = np.asarray(sw_x0(A, jnp.asarray(x0)).reshape(-1), np.float64)
        r = Su.T @ (Q @ (xd - free))
        const = (free - xd) @ Q @ (free - xd)

        def f_and_g(v):
            Mv = M @ v
            return v @ Mv - 2.0 * r @ v, 2.0 * (Mv - r)

        res = minimize(
            f_and_g, z, jac=True, method="L-BFGS-B", bounds=bounds,
            options={"ftol": 1e-16, "gtol": 1e-12, "maxiter": 2000},
        )
        j_opt = res.fun + const
        j_z = z @ (M @ z) - 2.0 * r @ z + const
        gaps.append((j_z - j_opt) / max(abs(j_opt), 1e-12))
    gaps = np.asarray(gaps)
    return float(np.median(gaps)), float(np.max(gaps))


def certify(A, B, cost, x0s, u, z_u, oracle_n=64):
    """The fleet's solution-quality gates; raises AssertionError on a miss.

    Feasibility of the projected iterate (0 by construction), the share
    of instances whose primal residual ||u - z|| is under the reference
    ADMM tolerance 1e-4, and the f64-oracle cost gap on `oracle_n`
    instances."""
    import jax.numpy as jnp

    max_violation = float(jnp.max(jnp.maximum(jnp.abs(z_u) - U_BOUND, 0.0)))
    prim = jnp.linalg.norm(u - z_u, axis=-1)
    converged_frac = float(jnp.mean((prim < 1e-4).astype(jnp.float32)))
    gap_med, gap_max = _oracle_cost_gap(
        A, B, cost, x0s[:oracle_n], np.asarray(z_u[:oracle_n], np.float64)
    )
    out = {
        "converged_frac": converged_frac,
        "max_violation": max_violation,
        "cost_gap_median": gap_med,
        "cost_gap_max": gap_max,
    }
    for ok, what in (
        (bool(jnp.all(jnp.isfinite(u))), "non-finite iterate"),
        (max_violation == 0.0, "infeasible z-iterate"),
        (gap_med <= 1e-4, "median cost gap > 1e-4"),
        (gap_max <= 1e-4, "max cost gap > 1e-4"),
        (converged_frac >= 0.99, "converged_frac < 0.99"),
    ):
        if not ok:  # a gate, also under python -O
            raise AssertionError(f"{what}: {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("pallas", "xla"), default="pallas")
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args(argv)

    from benchmarks._certify import device_info, enable_compile_cache, timed_windows

    enable_compile_cache()
    dev = device_info(require="gpu")

    A, B, cost = lqt_box_problem(N)
    x0s = initial_states(BATCH)
    solve = make_solver(args.path, A, B, cost)
    u, z_u = solve(x0s)  # compile + warm up
    cert = certify(A, B, cost, x0s, u, z_u)

    times = timed_windows(lambda: solve(x0s), calls=20, windows=args.windows)
    rates = np.sort(BATCH * ADMM_ITERS / times)
    iters_per_s = float(np.median(rates))
    q1, q3 = np.percentile(rates, [25, 75])
    print(json.dumps({
        "metric": "admm_iterations_per_s_N100",
        "value": iters_per_s,
        "unit": "ADMM iterations/s (16,384 instances x N=100, 100 iterations)",
        "path": args.path,
        "precision": "tf32x3" if args.path == "pallas" else "highest",
        "vs_baseline": iters_per_s / BASELINE_ITERS_PER_S,
        "windows": len(times),
        "iqr_low": float(q1),
        "iqr_high": float(q3),
        **cert,
        **dev,
    }))


if __name__ == "__main__":
    main()
