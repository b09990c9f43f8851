"""Robust SLS-ADMM chance-constraint tests with Monte-Carlo validation.

The signature statistical test of the reference (SURVEY §4.4): sample
initial states from the modeled Gaussian, roll out the non-robust DP
controller vs the robust SLS controller, and check the empirical
constraint-satisfaction rate clears the chosen probability level.

Reference golden numbers (state-bounds notebook c19-20, α=0.9,
var_x0=0.02): DP 23.44 % vs SLS 89.59 % over 10,000 rollouts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.stats import norm

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.problem import ADMMConfig
from ilqr_admm_tpu.projections import (
    project_bound,
    project_set_convex,
    project_soc_unit,
)
from ilqr_admm_tpu.solvers.lqt import sls_controller
from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_dp
from ilqr_admm_tpu.solvers.sls_admm import sls_admm
from ilqr_admm_tpu.ops.rollout import rollout_closed_loop, rollout_sls
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


N = 100
LOWER_U, UPPER_U = -3.0, 3.0
X_FINAL = 0.5
VAR_X0 = 0.02
ALPHA = 0.9
THR = 1e-2


def _problem():
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 1.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.zeros((d, d))])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-4, plant.u_dim)
    A, B = plant.AB(N)
    return plant, A, B, cost


def _soc_pair(psi_inv, bound_hi, bound_lo, var):
    """Chance-constraint SOC data for a scalar row phi = [ff, resp].

    P(phi^T [1; x0] <= hi) >= alpha and P(... >= lo) >= alpha, x0~N(0, var):
    SOC: ||diag(sqrt(sigma)) phi|| <= (hi - phi^T mu) / psi_inv
    (state-bounds notebook cell 16 construction).
    """
    mu = np.array([1.0, 0.0])
    sigma = np.array([0.0, var])
    Adiag = np.diag(np.sqrt(sigma))
    A_hi = np.concatenate([Adiag, (-mu / psi_inv)[None]], axis=0)
    b_hi = np.array([0.0, 0.0, bound_hi / psi_inv])
    A_lo = np.concatenate([Adiag, (mu / psi_inv)[None]], axis=0)
    b_lo = np.array([0.0, 0.0, -bound_lo / psi_inv])
    return [jnp.asarray(A_hi), jnp.asarray(A_lo)], [jnp.asarray(b_hi), jnp.asarray(b_lo)]


@pytest.mark.slow
def test_robust_sls_vs_dp_chance_constraints():
    plant, A, B, cost = _problem()
    d = plant.x_dim
    psi_inv = float(norm.ppf(ALPHA))

    # --- non-robust baseline: deterministic-constraint DP-ADMM controller
    def proj_x_det(x):
        x_ = x.reshape(N, d)
        x_ = x_.at[-1, 0].set(jnp.clip(x_[-1, 0], X_FINAL, X_FINAL))
        x_ = x_.at[-1, 1].set(0.0)
        return x_.reshape(-1)

    proj_u_det = lambda u: project_bound(u, LOWER_U, UPPER_U)
    rho_x = np.zeros((N, d, d))
    rho_x[-1] = np.eye(d) * 1e1
    _, _, (K_dp, k_dp), _ = lqt_admm_dp(
        A, B, cost, jnp.zeros(d), project_x=proj_x_det, project_u=proj_u_det,
        rho_x=jnp.asarray(rho_x), rho_u=1e-3,
        cfg=ADMMConfig(max_iter=2000, tol=1e-4),
    )

    # --- robust SLS-ADMM with SOC chance projections
    As_u, bs_u = _soc_pair(psi_inv, UPPER_U, LOWER_U, VAR_X0)
    projs = [project_soc_unit, project_soc_unit]

    def proj_u_rob(y):  # y: (N*u, 2) rows = [du_i, phi_i]
        return project_set_convex(
            y, As_u, bs_u, projs, rho=1e1, max_iter=20, threshold=1e-2
        )

    As_xf, bs_xf = _soc_pair(psi_inv, X_FINAL, X_FINAL, VAR_X0)
    As_vf, bs_vf = _soc_pair(psi_inv, 0.0, 0.0, VAR_X0)

    def proj_x_rob(y):  # y: (N*d, 2); constrain only the two final rows
        pos_row = project_set_convex(
            y[-2:-1], As_xf, bs_xf, projs, rho=1e1, max_iter=20, threshold=1e-2
        )
        vel_row = project_set_convex(
            y[-1:], As_vf, bs_vf, projs, rho=1e1, max_iter=20, threshold=1e-2
        )
        return y.at[-2:-1].set(pos_row).at[-1:].set(vel_row)

    rho_x_r = np.zeros((N, d, d))
    rho_x_r[-1] = np.eye(d) * 1e3
    du, phi_u, info = sls_admm(
        A, B, cost, project_x=proj_x_rob, project_u=proj_u_rob,
        rho_x=jnp.asarray(rho_x_r), rho_u=1e-3, robust_dim=1,
        cfg=ADMMConfig(max_iter=100, tol=1e-5, stall_tol=1e-2),
    )
    K_sls, k_sls = sls_controller(A, B, phi_u, du)

    # --- Monte-Carlo validation (10k samples)
    n_mc = 10_000
    rng = np.random.default_rng(7)
    x0s = np.zeros((n_mc, d))
    x0s[:, 0] = rng.normal(0.0, np.sqrt(VAR_X0), n_mc)
    x0s = jnp.asarray(x0s)

    def lin_f(x, u):
        return plant.A @ x + plant.B @ u

    xs_dp, us_dp = jax.vmap(lambda a: rollout_closed_loop(lin_f, a, K_dp, k_dp))(x0s)
    xs_sls, us_sls = jax.vmap(
        lambda a: rollout_sls(lin_f, a, K_sls, k_sls, d, plant.u_dim)
    )(x0s)

    def success(xs, us):
        xs = np.asarray(xs)
        us = np.asarray(us)
        sx = (X_FINAL - THR <= xs[:, -1, 0]) & (xs[:, -1, 0] <= X_FINAL + THR)
        sdx = np.abs(xs[:, -1, 1]) <= THR
        su = (us >= LOWER_U - 1e-3).all(axis=(1, 2)) & (us <= UPPER_U + 1e-3).all(axis=(1, 2))
        return float((sx & sdx & su).mean())

    rate_dp = success(xs_dp, us_dp)
    rate_sls = success(xs_sls, us_sls)

    # reference: DP 23.44 %, SLS 89.59 % (α = 0.9)
    assert rate_sls > rate_dp, (rate_sls, rate_dp)
    # tightened to within binomial noise of the reference (89.59 % over
    # 10k samples -> sigma ~ 0.3 pp; 0.88 allows solver-level drift only)
    assert rate_sls >= 0.88, rate_sls
    assert rate_dp <= 0.60, rate_dp


@pytest.mark.slow
def test_joint_calibrated_one_call():
    """One-call joint chance calibration: requesting
    joint_alpha=0.95 through `sls_admm(joint_alpha=..., u_bounds=...,
    x0_var=...)` delivers >= 0.93 joint MC success on the state-bounds
    fixture (measured 0.9494 — the chi ball certificate is nearly tight
    here because all rows share one scalar initial-state deviation).

    Note the method matters: a Sidak per-row correction over the 200
    one-sided rows demands psi=3.47 and pushes this problem (whose
    deterministic feedforward already brushes the control bound) into
    infeasibility — joint MC collapses. The default chi certificate
    (psi=1.96 at p=1) is both sound and feasible.
    """
    from ilqr_admm_tpu.chance import make_state_box_chance_projection

    plant, A, B, cost = _problem()
    d = plant.x_dim

    # terminal pin through the library's state-chance helper (equality
    # rows degenerate to [target | 0] regardless of the level)
    proj_x_rob, _ = make_state_box_chance_projection(
        VAR_X0, 1, N, d,
        {(N - 1, 0): (X_FINAL, X_FINAL), (N - 1, 1): (0.0, 0.0)},
        joint_alpha=0.95,
    )

    rho_x_r = np.zeros((N, d, d))
    rho_x_r[-1] = np.eye(d) * 1e3
    du, phi_u, info = sls_admm(
        A, B, cost, project_x=proj_x_rob,
        joint_alpha=0.95, u_bounds=(LOWER_U, UPPER_U), x0_var=VAR_X0,
        rho_x=jnp.asarray(rho_x_r), rho_u=1e-3, robust_dim=1,
        cfg=ADMMConfig(max_iter=100, tol=1e-5, stall_tol=1e-6),
    )
    K_sls, k_sls = sls_controller(A, B, phi_u, du)

    n_mc = 10_000
    rng = np.random.default_rng(7)
    x0s = np.zeros((n_mc, d))
    x0s[:, 0] = rng.normal(0.0, np.sqrt(VAR_X0), n_mc)
    x0s = jnp.asarray(x0s)
    lin_f = lambda x, u: plant.A @ x + plant.B @ u
    xs, us = jax.vmap(
        lambda a: rollout_sls(lin_f, a, K_sls, k_sls, d, plant.u_dim)
    )(x0s)
    xs = np.asarray(xs)
    us = np.asarray(us)
    sx = (X_FINAL - THR <= xs[:, -1, 0]) & (xs[:, -1, 0] <= X_FINAL + THR)
    sdx = np.abs(xs[:, -1, 1]) <= THR
    su = (us >= LOWER_U - 1e-3).all(axis=(1, 2)) & (us <= UPPER_U + 1e-3).all(axis=(1, 2))
    joint = float((sx & sdx & su).mean())
    # requested 0.95; binomial noise over 10k + ADMM slack -> assert 0.93
    assert joint >= 0.93, (joint, sx.mean(), sdx.mean(), su.mean())
    # the terminal task still succeeds (deterministic blocks intact)
    assert sx.mean() >= 0.99 and sdx.mean() >= 0.99


def test_sls_admm_control_bounds_unweighted_feasibility():
    """Robust control bounds only (control-bounds notebook c15-16)."""
    plant = DoubleIntegrator(1, 2, dt=0.01)
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e6])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, plant.u_dim)
    A, B = plant.AB(N)

    psi_inv = float(norm.ppf(0.95))
    As_u, bs_u = _soc_pair(psi_inv, 5.0, -5.0, 0.01)

    def proj_u(y):
        return project_set_convex(
            y, As_u, bs_u, [project_soc_unit] * 2, rho=1e1, max_iter=100, threshold=1e-3
        )

    du, phi_u, info = sls_admm(
        A, B, cost, project_u=proj_u, rho_u=1e2, robust_dim=1,
        cfg=ADMMConfig(max_iter=50, tol=1e-3, stall_tol=1e-2),
    )
    # chance-constraint margin on the feedforward: |du| + psi_inv*sqrt(var)*|phi| <= 5
    margin = np.abs(np.asarray(du)) + psi_inv * np.sqrt(0.01) * np.abs(
        np.asarray(phi_u[:, 0])
    )
    assert margin.max() <= 5.0 + 5e-2, margin.max()


def test_sls_admm_adaptive_rho_matches_fixed():
    """Adaptive-rho robust-SLS x-update (previously
    errored) — recovers the fixed-rho robust solution from a 100x-off
    penalty."""
    plant = DoubleIntegrator(1, 2, dt=0.01)
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e6])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, plant.u_dim)
    A, B = plant.AB(N)

    psi_inv = float(norm.ppf(0.95))
    As_u, bs_u = _soc_pair(psi_inv, 5.0, -5.0, 0.01)

    def proj_u(y):
        return project_set_convex(
            y, As_u, bs_u, [project_soc_unit] * 2, rho=1e1, max_iter=100,
            threshold=1e-3,
        )

    du_f, phi_f, _ = sls_admm(
        A, B, cost, project_u=proj_u, rho_u=1e2, robust_dim=1,
        cfg=ADMMConfig(max_iter=50, tol=1e-3, stall_tol=1e-2),
    )
    # adaptive from a 100x-too-small penalty reaches the same margins
    du_a, phi_a, info = sls_admm(
        A, B, cost, project_u=proj_u, rho_u=1e0, robust_dim=1,
        cfg=ADMMConfig(max_iter=100, tol=1e-3, stall_tol=1e-4,
                       adaptive_rho=True),
    )
    m_f = np.abs(np.asarray(du_f)) + psi_inv * 0.1 * np.abs(np.asarray(phi_f[:, 0]))
    m_a = np.abs(np.asarray(du_a)) + psi_inv * 0.1 * np.abs(np.asarray(phi_a[:, 0]))
    assert m_a.max() <= 5.0 + 5e-2, m_a.max()
    np.testing.assert_allclose(m_a.max(), m_f.max(), atol=0.1)
