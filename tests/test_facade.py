"""Facade parity tests: reference-style workflows through SLS / iSLS.

Exercises the classes exactly as the reference notebooks do (SURVEY §2
component #13): 2-D A/B assignment, via-point costs, solve dispatch,
ADMM methods with lambda projections, Monte-Carlo rollout simulators,
and the notebook-era API aliases (`set_cost_variables`, `solve_ilqr`).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu import SLS, iSLS, get_double_integrator_AB
from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.projections import project_bound


def test_sls_notebook_workflow():
    """Double integrator control-bounds notebook, end to end."""
    N, d, u_dim = 100, 2, 1
    A, B = get_double_integrator_AB(1, nb_deriv=2, dt=1.0 / N)

    sls = SLS(d, u_dim, N)
    sls.AB = [A, B]  # 2-D matrices broadcast over the horizon

    zs = np.stack([np.zeros(d), np.array([1.0, 0.0])])
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * 1e6])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, 1e-2)

    x0 = np.zeros(d)
    x_opt, u_opt = sls.solve(x0, method="batch")
    assert abs(float(x_opt[-1, 0]) - 1.0) < 1e-3

    K, k = sls.solve(method="dp")
    xs_dp, us_dp = sls.get_trajectory_dp(x0, K, k)
    np.testing.assert_allclose(np.asarray(xs_dp), np.asarray(x_opt), atol=1e-6)

    # lifted operators exposed like the reference (`sls.Sw`, `sls.Su`)
    x_lift = np.asarray(sls.Sw)[:, :d] @ x0 + np.asarray(sls.Su) @ np.asarray(
        u_opt
    ).reshape(-1)
    np.testing.assert_allclose(x_lift.reshape(N, d), np.asarray(x_opt), atol=1e-8)

    # constrained solve with a notebook-style lambda projection
    x_c, u_c, log = sls.ADMM_LQT_Batch(
        x0, project_u=lambda u: project_bound(u, -5.0, 5.0),
        max_iter=100, rho_u=1e-2, tol=1e-4, verbose=False, log=True,
    )
    assert float(np.max(u_c)) <= 5.0 + 1e-2
    assert log.shape[1] == 2 and log.shape[0] >= 1
    c_con = float(sls.compute_cost(x_c, u_c))
    c_unc = float(sls.compute_cost(x_opt, u_opt))
    assert c_con >= c_unc
    assert abs(c_con - 12.50) < 0.15

    # anderson_m passthrough: same constrained optimum, fewer iterations
    x_aa, u_aa, log_aa = sls.ADMM_LQT_Batch(
        x0, project_u=lambda u: project_bound(u, -5.0, 5.0),
        max_iter=100, rho_u=1e-2, tol=1e-4, log=True, anderson_m=5,
    )
    np.testing.assert_allclose(np.asarray(u_aa), np.asarray(u_c), atol=1e-3)
    assert log_aa.shape[0] < log.shape[0]

    # DP variant returns gains usable for MC rollouts
    x_c2, u_c2, K2, k2 = sls.ADMM_LQT_DP(
        x0, project_u=lambda u: project_bound(u, -5.0, 5.0),
        max_iter=500, rho_u=1e-1, tol=1e-4,
    )
    x0s = np.zeros((64, d))
    x0s[:, 0] = np.random.default_rng(0).normal(0, 0.1, 64)
    xs_mc, us_mc = sls.get_trajectory_dp(x0s, K2, k2)
    assert xs_mc.shape == (64, N, d)

    # SLS synthesis + controller + history-feedback rollout
    PHI_U, du = sls.solve(method="sls")
    K_sls, k_sls = sls.controller(PHI_U, du)
    xs_sls, us_sls = sls.get_trajectory_sls(x0s, K_sls, k_sls)
    assert xs_sls.shape == (64, N, d)

    # replanning
    sls.initialize_replanning_procedure(K_sls)
    zs2 = zs.copy()
    zs2[1, 0] = 0.7
    xd_new = jnp.asarray(zs2)[jnp.asarray(seq)].reshape(-1)
    k_new = sls.replan_feedforward(k_sls, xd_new)
    assert k_new.shape == k_sls.shape


def test_isls_tutorial_workflow():
    """Tutorial.ipynb car workflow through the iSLS facade."""
    N = 200
    car = CarFrontWheel(dt=0.03)  # reference discretization; shorter horizon
    cost = CarParkingCost()

    sls = iSLS(x_dim=4, u_dim=2, N=N)
    sls.forward_model = car.step
    sls.cost_function = cost  # single-trajectory callable

    rng = np.random.default_rng(5)
    u0 = rng.normal(size=(N, 2)) * 0.1
    x0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])

    x_nom, u_nom = sls.get_trajectory_batch(x0, u0)
    sls.reset()
    sls.nominal_values = x_nom, u_nom
    assert isinstance(sls.cost, float)
    assert len(sls.cost_log) == 1

    sls.solve(car.get_AB, cost.get_Cs, max_iter=25, max_line_search_iter=25,
              method="dp", verbose=False)
    assert sls.cost < sls.cost_log[0]
    assert len(sls.cost_log) > 1

    # notebook-era alias
    sls.reset()
    sls.nominal_values = x_nom, u_nom
    sls.solve_ilqr(car.get_AB, get_Cs=cost.get_Cs, max_ilqr_iter=5, dp=True)
    assert len(sls.cost_log) >= 2

    # constrained: ilqr_admm with control bounds (notebook cells 25-27)
    sls.reset()
    sls.nominal_values = x_nom, u_nom

    def project_u(u):
        u_ = u.reshape(N, 2)
        u_ = u_.at[:, 0].set(jnp.clip(u_[:, 0], -0.5, 0.5))
        u_ = u_.at[:, 1].set(jnp.clip(u_[:, 1], -2.0, 2.0))
        return u_.reshape(-1)

    log = sls.ilqr_admm(
        get_AB=car.get_AB, get_Cs=cost.get_Cs, project_u=project_u,
        max_iter=20, max_admm_iter=5, max_line_search_iter=25,
        rho_u=np.diag([1e-1, 1e-2]), tol=1e-3, log=True,
    )
    us = np.asarray(sls.u_nom)
    assert np.abs(us[:, 0]).max() <= 0.5 + 5e-2
    assert np.abs(us[:, 1]).max() <= 2.0 + 5e-2


def test_isls_quadratic_cost_and_aliases():
    """set_cost_variables + quadratic-cost iLQR path (Car notebooks)."""
    from ilqr_admm_tpu.models.car import CarSimple

    N = 80
    car = CarSimple(dt=15.0 / 500)
    sls = iSLS(4, 2, N)
    sls.forward_model = car.step

    x_std = 1e2
    zs = np.stack([np.zeros(4), np.array([-1.0, -1.0, np.pi / 4, 0.0])])
    Qs = np.stack([np.zeros((4, 4)), np.eye(4) * x_std])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_cost_variables(zs, Qs, seq, 1e-2)  # notebook-era alias

    x0 = np.array([0.0, -2.0, np.pi / 2, 0.0])
    x_nom, u_nom = sls.rollout_batch(x0[None], np.zeros((1, N, 2)))
    sls.reset()
    sls.nominal_values = x_nom[0], u_nom[0]

    c0 = sls.cost
    sls.solve(car.get_AB, method="dp", max_iter=30, max_line_search_iter=30)
    assert sls.cost < c0
    xf = np.asarray(sls.x_nom[-1])
    assert np.linalg.norm(xf[:2] - np.array([-1.0, -1.0])) < 0.3


def test_facade_solve_dp_ff():
    """Reference `solve_dp_ff` API: cached-blocks ff re-sweep."""
    N = 50
    A, B = get_double_integrator_AB(1, 2, dt=1.0 / N)
    sls = SLS(2, 1, N)
    sls.AB = [A, B]
    zs = np.stack([np.zeros(2), np.array([1.0, 0.0])])
    Qs = np.stack([np.zeros((2, 2)), np.eye(2) * 1e4])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, 1e-2)

    K, k, Quu, Quu_inv, Qux = sls.solve_dp(return_Qs=True)
    k2 = sls.solve_dp_ff(K, Quu, Qux, Quu_inv)
    np.testing.assert_allclose(np.asarray(k2), np.asarray(k), atol=1e-10)


def test_facade_solve_dp_time_parallel():
    """facade solve_dp(time_parallel=...) matches the sequential scan."""
    N = 50
    A, B = get_double_integrator_AB(1, 2, dt=1.0 / N)
    sls = SLS(2, 1, N)
    sls.AB = [A, B]
    zs = np.stack([np.zeros(2), np.array([1.0, 0.0])])
    Qs = np.stack([np.zeros((2, 2)), np.eye(2) * 1e4])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, 1e-2)

    K_s, k_s = sls.solve_dp()
    for tp in ("flat", 16):
        K_p, k_p = sls.solve_dp(time_parallel=tp)
        np.testing.assert_allclose(np.asarray(K_p), np.asarray(K_s), atol=1e-8)
        np.testing.assert_allclose(np.asarray(k_p), np.asarray(k_s), atol=1e-8)


def test_isls_solve_stores_final_linearization():
    """After solve/ilqr_admm the facade holds the linearization at the
    solution (reference `isls.py:93-100` side effect) so Su/Sw/controller
    work instead of crashing on A=None (review finding)."""
    N = 40
    car = CarFrontWheel(dt=0.05)
    cost = CarParkingCost()
    sls = iSLS(x_dim=4, u_dim=2, N=N)
    sls.forward_model = car.step
    sls.cost_function = cost
    rng = np.random.default_rng(0)
    u0 = rng.normal(size=(N, 2)) * 0.1
    x0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])
    x_nom, u_nom = sls.get_trajectory_batch(x0, u0)
    sls.nominal_values = x_nom, u_nom
    assert sls.A is None  # nothing stored before solve
    sls.solve(car.get_AB, cost.get_Cs, max_iter=3, method="dp")
    assert sls.A is not None and sls.A.shape == (N, 4, 4)
    # stored linearization == linearization at the solved nominal
    A_now, B_now = car.get_AB(sls.x_nom, sls.u_nom)
    np.testing.assert_allclose(np.asarray(sls.A), np.asarray(A_now), atol=1e-12)
    assert sls.Su.shape == (N * 4, N * 2)  # lifted operators build


def test_compute_cost_shape_dispatch():
    """compute_cost accepts stacked/lifted, batched or not — including
    the N=1 ambiguity where N*dim == dim (the old
    last-dim heuristic dropped the batch axis there)."""
    rng = np.random.default_rng(0)

    for N in (5, 1):
        d, m = 2, 1
        A, B = get_double_integrator_AB(1, nb_deriv=2, dt=0.1)
        sls = SLS(d, m, N)
        sls.AB = [A, B]
        zs = np.stack([np.zeros(d), np.array([1.0, 0.0])])
        Qs = np.stack([np.zeros((d, d)), np.eye(d) * 10.0])
        seq = np.zeros(N, dtype=np.int32)
        seq[-1] = 1
        sls.set_quadratic_cost(zs, Qs, seq, 1e-2)

        xs = rng.normal(size=(N, d))
        us = rng.normal(size=(N, m))
        c_ref = float(sls.compute_cost(xs, us))

        # lifted single
        assert abs(float(sls.compute_cost(xs.reshape(-1), us.reshape(-1))) - c_ref) < 1e-12
        # batched stacked and batched lifted give per-instance costs
        xb = np.stack([xs, 2 * xs])
        ub = np.stack([us, 2 * us])
        cb = np.asarray(sls.compute_cost(xb, ub))
        assert cb.shape == (2,)
        assert abs(cb[0] - c_ref) < 1e-12
        cbl = np.asarray(
            sls.compute_cost(xb.reshape(2, -1), ub.reshape(2, -1))
        )
        np.testing.assert_allclose(cbl, cb, atol=1e-12)

    # malformed shapes error clearly instead of silently reshaping
    sls = SLS(2, 1, 5)
    with pytest.raises(ValueError, match="stacked"):
        sls.compute_cost(np.zeros((3, 7)))


def test_u_optimal_x_optimal_against_lifted_definition():
    """Facade `u_optimal`/`x_optimal` (`sls_base.py:56-60`): response-map
    evaluation must reproduce the batch optimum through the lifted
    operators u = PHI_U[:, :d] x0 + du, x = (Sw + Su PHI_U) x0 + Su du."""
    N, d, u_dim = 40, 2, 1
    A, B = get_double_integrator_AB(1, nb_deriv=2, dt=1.0 / N)
    sls = SLS(d, u_dim, N)
    sls.AB = [A, B]
    zs = np.stack([np.zeros(d), np.array([1.0, 0.0])])
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * 1e6])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, 1e-2)

    x0 = np.array([0.3, -0.2])
    x_b, u_b = sls.solve(x0, method="batch")
    PHI_U, du = sls.solve(method="sls")

    # u_optimal == batch optimum (final control unused => dropped)
    u_sls = np.asarray(sls.u_optimal(jnp.asarray(x0), PHI_U, du))
    assert u_sls.shape == (N - 1, u_dim)
    np.testing.assert_allclose(u_sls, np.asarray(u_b)[:-1], atol=1e-6)

    # x_optimal with PHI_X = Sw + Su PHI_U, dx = Su du == batch optimum
    Sw, Su = np.asarray(sls.Sw), np.asarray(sls.Su)
    PHI_X = Sw + Su @ np.asarray(PHI_U)
    dx = Su @ np.asarray(du).reshape(-1)
    x_sls = np.asarray(sls.x_optimal(jnp.asarray(x0), jnp.asarray(PHI_X), jnp.asarray(dx)))
    assert x_sls.shape == (N, d)
    np.testing.assert_allclose(x_sls, np.asarray(x_b), atol=1e-6)

    # shape/meaning parity for a batch of zeros: from the origin the
    # response maps produce exactly the feedforward trajectories
    np.testing.assert_allclose(
        np.asarray(sls.u_optimal(jnp.zeros(d), PHI_U, du)),
        np.asarray(du).reshape(N, u_dim)[:-1], atol=0,
    )
