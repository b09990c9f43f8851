"""Certified fused-Pallas robust SLS-ADMM kernel vs the XLA GEMM path.

Four paths on the chance-constrained control-bounds scenario fleet
(the robust benchmark class, BASELINE config #4):

- xla: `solvers/batched_sls.py` with the generic consensus-SOC inner
  projection (the reference's construction);
- consensus: the fused kernel with the inlined consensus loop;
- diamond: the fused kernel with the EXACT closed-form row projection
  onto {|du| + psi*sigma*|phi| <= bound} (the same row set as the
  two-SOC intersection; `ops/pallas_sls.py::_diamond_project_slabs`);
- diamond_ee: diamond + per-tile early exit on a difficulty-sorted
  fleet (stop_tol=3e-3 — the serving mode and the headline).

Each path runs in its OWN SUBPROCESS, one after another: the parent
stays off JAX, so one process at a time holds the card. Within a path:
certified configuration (rho_u = 1.0, well-scaled — see
bench_sls_fleet.py), f64 QP oracle gates (scipy trust-constr,
benchmarks/_oracles.py), exact diamond-projection primal residual,
`block_until_ready` timing windows (median).

Prints one JSON line (the diamond_ee path is the headline).
Run one path directly: python benchmarks/bench_pallas_sls.py <path>.
"""

import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

BASELINE_S = 0.207  # reference ADMM_SLS robust control bounds (BASELINE.md)
PATHS = ("xla", "consensus", "diamond", "diamond_ee")


def run_path(path, batch=1024, n_iters=200, n_cons=30, oracle_n=8):
    """Build + certify + time ONE path; returns its result dict."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from scipy.stats import norm

    from benchmarks._certify import (
        device_info, enable_compile_cache, gaps, run_oracle, timed_rate,
    )

    enable_compile_cache()
    device_info(require="gpu")
    from benchmarks._oracles import _project_diamond
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    N = 100
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    f32 = jnp.float32
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(f32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(f32)
    seq = np.zeros(N, dtype=np.int32); seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(f32), B.astype(f32)

    psi_inv = float(norm.ppf(0.95))
    sigma = 0.1
    c_coef = psi_inv * sigma
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = np.concatenate([Au, (-mu / psi_inv)[None]], 0)
    A_lo = np.concatenate([Au, (mu / psi_inv)[None]], 0)
    b_fixed = np.zeros(3)
    b_bound = np.array([0.0, 0.0, 1.0 / psi_inv])
    cons_rho, rho_u = 10.0, 1.0

    rng = np.random.default_rng(0)
    # binding bounds so the chance constraints are active
    bounds = jnp.asarray(rng.uniform(2.0, 4.0, batch), f32)

    if path == "xla":
        from ilqr_admm_tpu.projections import (
            project_set_convex, project_soc_unit,
        )
        from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm

        A_hi_j, A_lo_j = jnp.asarray(A_hi, f32), jnp.asarray(A_lo, f32)

        def soc_proj(y, bound):
            b = jnp.asarray(b_fixed, f32) + bound * jnp.asarray(b_bound, f32)
            return project_set_convex(y, [A_hi_j, A_lo_j], [b, b],
                                      [project_soc_unit] * 2, rho=cons_rho,
                                      max_iter=n_cons, threshold=0.0,
                                      stall_tol=0.0)

        solve = make_batched_sls_admm(
            A, B, cost, project_u=lambda y, p: jax.vmap(soc_proj)(y, p),
            rho_u=rho_u, robust_dim=1, n_iters=n_iters)
    elif path == "consensus":
        from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm

        # n_cons_iters matches the XLA path at rho_u=1.0 (the r3
        # 5-iteration shortcut left the inner projection unconverged)
        solve = make_pallas_sls_admm(
            A, B, cost, [A_hi, A_lo], [b_fixed, b_fixed],
            [b_bound, b_bound], rho_u=rho_u, robust_dim=1,
            n_iters=n_iters, n_cons_iters=n_cons, cons_rho=cons_rho)
    elif path == "diamond":
        from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm

        solve = make_pallas_sls_admm(
            A, B, cost, (), (), (),
            rho_u=rho_u, robust_dim=1, n_iters=n_iters,
            z_update="diamond", diamond_w=(1.0, c_coef))
    elif path == "diamond_ee":
        from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm

        # serving mode: per-tile early exit on a difficulty-SORTED fleet
        # (easy tiles stop as soon as their residual clears stop_tol)
        bounds = jnp.asarray(np.sort(np.asarray(bounds)), f32)
        solve = make_pallas_sls_admm(
            A, B, cost, (), (), (),
            rho_u=rho_u, robust_dim=1, n_iters=n_iters,
            z_update="diamond", diamond_w=(1.0, c_coef),
            stop_tol=3e-3, check_every=16)
    else:
        raise ValueError(path)

    du, phi, U = solve(bounds)
    jax.block_until_ready(du)
    U_np = np.asarray(U, np.float64)
    prim = np.array([
        np.linalg.norm(U_np[i] - _project_diamond(U_np[i], c_coef,
                                                  float(bounds[i])))
        for i in range(batch)
    ])
    # oracle subsample spread across the fleet (matters for the sorted
    # early-exit path: early-exited easy tiles AND the hard end)
    idx = np.linspace(0, batch - 1, oracle_n).astype(int)
    orc = run_oracle("sls_qp", {
        "A": np.asarray(A, np.float64), "B": np.asarray(B, np.float64),
        "Q": np.asarray(cost.Q, np.float64),
        "R": np.asarray(cost.R, np.float64),
        "xd": np.asarray(cost.lifted_xd(), np.float64),
        "bounds": np.asarray(bounds[idx], np.float64),
        "U": U_np[idx], "c": c_coef,
    })
    gap_med, gap_max = gaps(orc["j_z"], orc["j_star"])
    rate, _ = timed_rate(lambda: solve(bounds), batch, K=5, reps=5)
    return {
        "rate": round(rate, 1),
        "converged_frac": round(float(np.mean(prim < 5e-3)), 4),
        "prim_max": float(f"{prim.max():.3g}"),
        "cost_gap_median": float(f"{gap_med:.3g}"),
        "cost_gap_max": float(f"{gap_max:.3g}"),
    }


def main():
    results = {}
    for path in PATHS:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), path],
            capture_output=True, text=True, timeout=3000, cwd=REPO,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"path {path} failed:\n{out.stdout[-2000:]}\n"
                f"{out.stderr[-2000:]}"
            )
        results[path] = json.loads(out.stdout.strip().splitlines()[-1])

    rd = results["diamond"]
    ree = results["diamond_ee"]
    n_iters, batch = 200, 1024
    out = {
        "metric": "pallas_robust_sls_syntheses_per_s",
        "value": ree["rate"],
        "unit": f"robust SLS syntheses/s (N=100, batch {batch}, fused Pallas "
                "kernel, exact diamond z-update, per-tile early exit on a "
                f"sorted fleet; fixed {n_iters}-iteration schedule: "
                f"{rd['rate']:,.0f}/s)",
        "vs_baseline": round(ree["rate"] * BASELINE_S, 1),
        "speedup_vs_xla": round(ree["rate"] / results["xla"]["rate"], 2),
        "speedup_vs_consensus_kernel":
            round(ree["rate"] / results["consensus"]["rate"], 2),
        "paths": results,
        "oracle": "f64 trust-constr QP, 8 instances/path, fresh process/path",
    }
    for r in (results["consensus"], rd, ree):
        assert r["converged_frac"] >= 0.99, r
        assert r["cost_gap_median"] <= 1e-4, r
        assert r["cost_gap_max"] <= 1e-3, r
    print(json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        print(json.dumps(run_path(sys.argv[1])))
    else:
        main()
