"""Scenario fleet of chance-constrained robust syntheses, two ways.

Beyond-reference demo (r5): the chance-constrained control-bound rows
|du_t| + psi*sigma*|phi_t| <= bound form a weighted-l1 "diamond" — the
same set as the reference's intersection-of-two-SOCs construction
(`SLS_ADMM.ipynb` c10-c12) but projectable EXACTLY in closed form
(`projections.project_weighted_l1`). A fleet of robust syntheses that
share dynamics/cost but differ in the per-scenario bound is solved with

1. the reference-style consensus-ADMM SOC intersection projection, and
2. the exact diamond projection,

through the same batched solver (`solvers/batched_sls.py`); both must
agree, and the diamond path needs no inner projection loop at all. On
the GPU the fused kernel (`ops/pallas_sls.py`, z_update='diamond') runs
this fleet (chip_smoke.py P2).

Run: python examples/robust_fleet_diamond.py
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from scipy.stats import norm

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.projections import (
    project_set_convex,
    project_soc_unit,
    project_weighted_l1,
)
from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def main():
    N, batch = 40, 64
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    f32 = jnp.float32
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(f32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(f32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(f32), B.astype(f32)

    # 95% one-sided chance level, disturbance std 0.1 on the phi channel
    psi = float(norm.ppf(0.95))
    c = psi * 0.1

    # reference-style: rows constrained via two SOCs + consensus ADMM
    mu = np.array([1.0, 0.0])
    Au = np.diag([0.0, 0.1])
    A_hi = jnp.asarray(np.concatenate([Au, (-mu / psi)[None]], 0), f32)
    A_lo = jnp.asarray(np.concatenate([Au, (mu / psi)[None]], 0), f32)

    def soc_proj(y, bound):
        b = jnp.concatenate([jnp.zeros(2, f32), (bound / psi)[None]])
        return project_set_convex(y, [A_hi, A_lo], [b, b],
                                  [project_soc_unit] * 2, rho=1e1,
                                  max_iter=30, threshold=0.0)

    solve_soc = make_batched_sls_admm(
        A, B, cost, project_u=lambda y, p: jax.vmap(soc_proj)(y, p),
        rho_u=1.0, robust_dim=1, n_iters=300,
    )

    # exact: one closed-form weighted-l1 projection per row
    def diamond_proj(y, bounds):
        return project_weighted_l1(y, jnp.asarray([1.0, c]), bounds[:, None])

    solve_diamond = make_batched_sls_admm(
        A, B, cost, project_u=diamond_proj,
        rho_u=1.0, robust_dim=1, n_iters=300,
    )

    rng = np.random.default_rng(0)
    bounds = jnp.asarray(rng.uniform(1.5, 3.0, batch), f32)

    du_s, phi_s, _ = solve_soc(bounds)
    du_d, phi_d, _ = solve_diamond(bounds)

    # pointwise agreement is limited by the CONSENSUS path's inner-loop
    # approximation error (~1e-2 on these du magnitudes; its relative
    # COST gap vs the f64 QP oracle is 1.5e-5 — benchmarks/RESULTS.md
    # r5), so the exact path is the tighter of the two
    dev = float(jnp.max(jnp.abs(du_s - du_d)))
    print(f"fleet of {batch} scenarios, N={N}: "
          f"max |du| deviation SOC-consensus vs exact diamond {dev:.2e}")

    margin = jnp.abs(du_d) + c * jnp.abs(phi_d[:, :, 0])
    worst = float(jnp.max(margin - bounds[:, None]))
    active = float(jnp.mean(jnp.max(margin, 1) > bounds * 0.98)) * 100
    print(f"diamond path: worst chance margin {worst:+.5f} "
          f"(<=0 feasible), bounds active for {active:.0f}% of fleet")
    assert dev < 5e-2 and worst < 1e-3
    print("OK")


if __name__ == "__main__":
    main()
