"""Certified batched robust SLS-ADMM fleet throughput (BASELINE config #4).

A scenario fleet of chance-constrained robust syntheses: per instance,
the rows of [du | Phi_u] must satisfy |du_r| + psi*sigma*|phi_r| <= bound
(intersection of two SOCs — the reference's robust control-bounds
construction, `SLS_ADMM.ipynb` c10-c12). BASELINE.md: reference ADMM_SLS
solves ONE instance in 207 ms.

Certificates (bench.py-grade, the arm/SLS benches are
co-primary metrics):
- the certified iterate is the EXACT f64 diamond projection of each
  reported U (feasible by construction; benchmarks/_oracles.py);
- converged_frac: per-instance primal residual ||U - z|| at 5e-3;
- f64 convex oracle: the per-instance QP solved with scipy trust-constr
  (4 linear constraints per row encode the diamond) — relative cost gap
  of the feasible iterate gated at 1e-4 (median) / 1e-3 (max);
- `block_until_ready` timing windows, median (`_certify.timed_rate`).

Prints one JSON line.
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
from scipy.stats import norm

from benchmarks._certify import gaps, run_oracle, timed_rate
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.projections import project_set_convex, project_soc_unit
from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

BASELINE_S = 0.207  # reference ADMM_SLS robust control bounds (BASELINE.md)


def main(batch=1024, n_iters=200, oracle_n=8):
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
    sigma = float(np.sqrt(0.01))
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = jnp.asarray(np.concatenate([Au, (-mu / psi_inv)[None]], 0), f32)
    A_lo = jnp.asarray(np.concatenate([Au, (mu / psi_inv)[None]], 0), f32)

    def soc_proj(y, bound):
        b = jnp.concatenate([jnp.zeros(2, f32), (bound / psi_inv)[None]])
        # fixed-count inner projection (SPMD-friendly, threshold=0);
        # 30 iterations puts the inner error well below the outer gates
        return project_set_convex(y, [A_hi, A_lo], [b, b],
                                  [project_soc_unit] * 2, rho=1e1,
                                  max_iter=30, threshold=0.0)

    def proj_u(y, params):
        return jax.vmap(soc_proj)(y, params)

    # rho_u = 1.0: the well-scaled penalty (measured sweep: the old
    # rho_u=1e2 setting produced feasible-looking iterates whose cost sat
    # 2-12x ABOVE the QP optimum at 50-100 iterations — the feasibility
    # margin check alone could not see it; the f64 QP oracle can)
    solve = make_batched_sls_admm(
        A, B, cost, project_u=proj_u, rho_u=1.0, robust_dim=1, n_iters=n_iters
    )
    rng = np.random.default_rng(0)
    # binding scenario bounds: the unconstrained |du| peaks near 4-5, so
    # bounds in [2, 4] keep the chance constraints ACTIVE for every
    # instance (at the old [4, 8] range the projection was a no-op and
    # the benchmark measured an unconstrained solve)
    bounds = jnp.asarray(rng.uniform(2.0, 4.0, batch), f32)  # scenario axis

    du, phi, U = solve(bounds)
    jax.block_until_ready(du)

    # --- certificates ---------------------------------------------------
    # raw-iterate chance margin (reporting; the certified iterate is the
    # f64 diamond projection below, feasible by construction)
    margin = jnp.abs(du) + psi_inv * sigma * jnp.abs(phi[:, :, 0])
    worst_margin = float(jnp.max(margin - bounds[:, None]))
    active_frac = float(jnp.mean(jnp.max(margin, 1) > bounds * 0.98))

    # exact f64 projection of EVERY instance -> fleet-wide converged_frac
    from benchmarks._oracles import _project_diamond

    c_coef = psi_inv * sigma
    U_np = np.asarray(U, np.float64)
    prim_all = np.array([
        np.linalg.norm(U_np[i] - _project_diamond(
            U_np[i], c_coef, float(bounds[i])))
        for i in range(U_np.shape[0])
    ])
    # raw-iterate distance to the feasible set; the certified iterate is
    # the exact projection, whose optimality the QP oracle gates below
    converged_frac = float(np.mean(prim_all < 5e-3))

    orc = run_oracle("sls_qp", {
        "A": np.asarray(A, np.float64), "B": np.asarray(B, np.float64),
        "Q": np.asarray(cost.Q, np.float64),
        "R": np.asarray(cost.R, np.float64),
        "xd": np.asarray(cost.lifted_xd(), np.float64),
        "bounds": np.asarray(bounds[:oracle_n], np.float64),
        "U": U_np[:oracle_n], "c": c_coef,
    })
    gap_med, gap_max = gaps(orc["j_z"], orc["j_star"])

    # --- throughput (median of block_until_ready windows) ---------------
    rate, dt_win = timed_rate(lambda: solve(bounds)[0], batch, K=5, reps=3)

    out = {
        "metric": "robust_sls_syntheses_per_s",
        "value": round(rate, 1),
        "unit": f"robust SLS-ADMM syntheses/s (N=100, {n_iters} iters, batch {batch}, rho=1.0)",
        "vs_baseline": round(rate * BASELINE_S, 1),
        "worst_raw_margin": float(f"{worst_margin:.3g}"),
        "bounds_active_frac": round(active_frac, 3),
        "converged_frac": round(converged_frac, 4),
        "max_violation": 0.0,  # certified iterate = exact projection
        "cost_gap_median": float(f"{gap_med:.3g}"),
        "cost_gap_max": float(f"{gap_max:.3g}"),
        "oracle": f"f64 trust-constr QP, {oracle_n} instances",
    }
    assert converged_frac >= 0.99, f"converged_frac {converged_frac}"
    assert gap_med <= 1e-4, f"median cost gap {gap_med}"
    assert gap_max <= 1e-3, f"max cost gap {gap_max}"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
