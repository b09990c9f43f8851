"""Certified batched iLQR-ADMM solves/s on the 3DoF arm (1 chip).

BASELINE.json co-primary metric: "batched solves/s on 3DoF arm".
Reference single-instance `ilqr_admm` on the 3DoF arm: 639 ms / solve
(BASELINE.md, `3DoF robot/State and control bound constraints.ipynb`
c24) → 1.56 solves/s. Here the FULL constrained solver (outer
relinearization while_loop with convergence exit, inner ADMM with line
search) is vmapped over sampled initial configurations on one chip.

Workload note (r5): control bounds are ±2.5 — ACTIVE for ~half the
sampled fleet (measured max|u| without bounds ≈ 3.5; the previous ±6
bound was never active, so the old number timed an unconstrained solve).
Per-instance early exit comes from vmap-of-while_loop semantics: the
fleet runs until the LAST instance converges (measured: all instances
converge in 3 outer iterations at these tolerances, statuses
CONVERGED fleet-wide — max_iter=12 is headroom, not the budget).

Certificates (bench.py-grade):
- convergence: fraction of fleet with status == CONVERGED, gated >= 0.99;
- feasibility: the certified iterate is clip(u, ±2.5); its f64 rollout
  cost is what the oracle gap measures (reported u may overshoot the
  bound by the ADMM primal residual — measured <= 1e-3);
- f64 oracle: bounded L-BFGS-B polish from each certified iterate on a
  subsample (local-optimality certificate; nonconvex task);
- `block_until_ready` timing windows, median (`_certify.timed_rate`).

Prints one JSON line. Run: python benchmarks/bench_arm_admm.py [method] [batch]
"""

import json
import os

# persistent compile cache: JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from benchmarks._certify import gaps, run_oracle, timed_rate
from ilqr_admm_tpu.models.arm import PlanarArm
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.solvers.admm import SolveStatus
from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

BASELINE_SOLVES_PER_S = 1.0 / 0.639  # reference ilqr_admm, 3DoF arm
U_BOUND = 2.5


def main(batch=1024, method="batch", oracle_n=8):
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

    def make_solve(line_search):
        def solve_one(q0):
            x0 = jnp.concatenate([q0, jnp.zeros(n, jnp.float32), arm.fk(q0)])
            u0 = jnp.ones((N, m), jnp.float32)
            x_nom0 = rollout_nonlinear(arm.step, x0, u0)
            res = ilqr_admm(
                arm.step, arm.get_AB, quad, x_nom0, u0,
                quad_cost=quad, project_u=proj_u, rho_u=1e-2,
                max_iter=12, max_admm_iter=20, alphas=alphas, tol=1e-4,
                method=method, line_search=line_search,
            )
            return res.cost, res.u_nom, res.status, res.outer_iters

        return jax.jit(jax.vmap(solve_one))

    solve = make_solve("inner")

    rng = np.random.default_rng(0)
    q0s = jnp.asarray(
        np.array([np.pi / 3, -np.pi / 2, -np.pi / 4]) + rng.normal(0, 0.1, (batch, n)),
        jnp.float32,
    )

    costs, us, status, outer_iters = solve(q0s)
    jax.block_until_ready(costs)

    # --- certificates ---------------------------------------------------
    converged_frac = float(jnp.mean((status == SolveStatus.CONVERGED)
                                    .astype(jnp.float32)))
    max_viol = float(jnp.max(jnp.abs(us))) - U_BOUND
    active_frac = float(jnp.mean(
        (jnp.max(jnp.abs(us.reshape(batch, -1)), axis=1) > U_BOUND * 0.98)
        .astype(jnp.float32)))
    mean_cost = float(jnp.mean(costs))

    orc = run_oracle("arm_polish", {
        "lengths": np.array([1.0, 1.0, 1.0]), "dt": 1.0 / N,
        "zs": np.asarray(zs, np.float64), "Qs": np.asarray(Qs, np.float64),
        "seq": seq, "u_std": u_std, "u_lo": -U_BOUND, "u_hi": U_BOUND,
        "q0s": np.asarray(q0s[:oracle_n], np.float64),
        "us": np.asarray(us[:oracle_n], np.float64),
    })
    gap_med, gap_max = gaps(orc["j_ours"], orc["j_star"])

    # --- throughput (median of block_until_ready windows) ---------------
    rate, dt_win = timed_rate(lambda: solve(q0s)[1], batch, K=5, reps=3)

    out = {
        "metric": "arm_ilqr_admm_solves_per_s",
        "value": round(rate, 1),
        "unit": f"3DoF-arm iLQR-ADMM solves/s (N=100, |u|<={U_BOUND}, batch {batch})",
        "vs_baseline": round(rate / BASELINE_SOLVES_PER_S, 1),
        "method": method,
        "mean_cost": round(mean_cost, 5),
        "mean_outer_iters": round(float(jnp.mean(outer_iters.astype(jnp.float32))), 2),
        "max_outer_iters": int(jnp.max(outer_iters)),
        "bounds_active_frac": round(active_frac, 3),
        "converged_frac": round(converged_frac, 4),
        "max_bound_violation": float(f"{max(max_viol, 0.0):.3g}"),
        "cost_gap_median": float(f"{gap_med:.3g}"),
        "cost_gap_max": float(f"{gap_max:.3g}"),
        "oracle": f"f64 bounded L-BFGS-B polish of clip(u), {oracle_n} instances",
    }
    assert converged_frac >= 0.99, f"converged_frac {converged_frac}"
    assert max_viol <= 1e-2, f"bound violation {max_viol}"
    assert gap_med <= 1e-3, f"median cost gap {gap_med}"
    assert gap_max <= 1e-2, f"max cost gap {gap_max}"

    # --- SQP serving mode (line_search='outer', method='batch' only):
    # the inner ADMM iterates on the LINEARIZED trajectory with no
    # rollouts and ONE nonlinear line search globalizes each outer step
    # — it sits on a ~0.1% cost plateau above its fixed point (flat in
    # the inner budget), so it carries its own honest gates rather than
    # the headline's.
    if method == "batch":
        solve_sqp = make_solve("outer")
        costs2, us2, status2, _ = solve_sqp(q0s)
        jax.block_until_ready(costs2)
        conv2 = float(jnp.mean((status2 == SolveStatus.CONVERGED)
                               .astype(jnp.float32)))
        viol2 = float(jnp.max(jnp.abs(us2))) - U_BOUND
        orc2 = run_oracle("arm_polish", {
            "lengths": np.array([1.0, 1.0, 1.0]), "dt": 1.0 / N,
            "zs": np.asarray(zs, np.float64),
            "Qs": np.asarray(Qs, np.float64),
            "seq": seq, "u_std": u_std, "u_lo": -U_BOUND, "u_hi": U_BOUND,
            "q0s": np.asarray(q0s[:oracle_n], np.float64),
            "us": np.asarray(us2[:oracle_n], np.float64),
        })
        g2_med, g2_max = gaps(orc2["j_ours"], orc2["j_star"])
        rate2, _ = timed_rate(lambda: solve_sqp(q0s)[1], batch, K=5, reps=3)
        out["sqp_outer_ls"] = {
            "rate": round(rate2, 1),
            "vs_baseline": round(rate2 / BASELINE_SOLVES_PER_S, 1),
            "speedup_vs_inner": round(rate2 / rate, 2),
            "converged_frac": round(conv2, 4),
            "max_bound_violation": float(f"{max(viol2, 0.0):.3g}"),
            "cost_gap_median": float(f"{g2_med:.3g}"),
            "cost_gap_max": float(f"{g2_max:.3g}"),
        }
        assert conv2 >= 0.99 and viol2 <= 1e-2
        assert g2_med <= 2e-3 and g2_max <= 6e-3, out["sqp_outer_ls"]
    print(json.dumps(out))


if __name__ == "__main__":
    method = sys.argv[1] if len(sys.argv) > 1 else "batch"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    main(batch=batch, method=method)
