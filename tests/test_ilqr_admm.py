"""Constrained iLQR-ADMM tests (car control bounds, arm state+control bounds).

Golden targets (BASELINE.md):
- car + control bounds: reference final cost 1.903 (DDP-replicate c21);
  bound satisfaction |u1| <= 0.5, |u2| <= 2.0.
- 3DoF arm + state & control bounds: reference final cost 0.1996
  (3DoF bounds c24); velocity bounds |q_dot| <= 1.5, |u| <= 6, final ee-x
  in [0.5, 1.0].
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.arm import PlanarArm
from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


@pytest.mark.slow
def test_car_control_bounds():
    N = 500
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost()
    rng = np.random.default_rng(3)
    u0 = jnp.asarray(rng.normal(size=(N, 2)) * 0.1)
    x0 = jnp.asarray([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
    x_nom0 = rollout_nonlinear(car.step, x0, u0)

    lo = jnp.asarray([-0.5, -2.0])
    hi = jnp.asarray([0.5, 2.0])

    def proj_u(u):
        return jnp.clip(u.reshape(N, 2), lo, hi).reshape(-1)

    res = ilqr_admm(
        car.step, car.get_AB, cost, x_nom0, u0,
        get_Cs=cost.get_Cs, project_u=proj_u,
        rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3])),
        max_iter=60, max_admm_iter=8,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50)[:40],
        tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
    )
    us = np.asarray(res.u_nom)
    # bound satisfaction (constraint oracle, ADMM-tolerance slack)
    assert us[:, 0].max() <= 0.5 + 1e-3 and us[:, 0].min() >= -0.5 - 1e-3
    assert us[:, 1].max() <= 2.0 + 1e-3 and us[:, 1].min() >= -2.0 - 1e-3
    # reference final cost 1.903 (DDP-replicate c21); measured 1.9054
    assert float(res.cost) < 1.92, float(res.cost)
    # constrained cost must exceed the unconstrained optimum (~0.93)
    assert float(res.cost) > 0.9

    # SQP outer line search on the same problem: the HEADTOHEAD config
    # (bench_outer_ls.py variant D) — tighter golden AND tighter
    # feasibility than the inner mode (measured CPU f64: cost 1.9056,
    # max violation 6e-6)
    res_o = ilqr_admm(
        car.step, car.get_AB, cost, x_nom0, u0,
        get_Cs=cost.get_Cs, project_u=proj_u, line_search="outer",
        rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3])),
        max_iter=120, max_admm_iter=30,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50)[:20],
        tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
    )
    # converged or detected-oscillating (not forward-pass failure): this
    # init needs ~84 of the 120 outer steps, so small numeric drift can
    # land on MAX_ITER; the cost/violation bounds below are the real
    # oracle (don't pin the exact status)
    from ilqr_admm_tpu.problem import SolveStatus
    assert int(res_o.status) in (
        int(SolveStatus.CONVERGED),
        int(SolveStatus.OSCILLATING),
        int(SolveStatus.MAX_ITER),
    ), int(res_o.status)
    us_o = np.asarray(res_o.u_nom)
    assert us_o[:, 0].max() <= 0.5 + 3e-4 and us_o[:, 0].min() >= -0.5 - 3e-4
    assert us_o[:, 1].max() <= 2.0 + 3e-4 and us_o[:, 1].min() >= -2.0 - 3e-4
    assert float(res_o.cost) < 1.907, float(res_o.cost)
    assert float(res_o.cost) > 0.9


def test_arm_state_control_bounds():
    N = 100
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e6, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = jnp.ones((N, m))
    x_nom0 = rollout_nonlinear(arm.step, x0, u0)

    lower_u, upper_u = -6.0, 6.0
    lower_xf, upper_xf = 0.5, 1.0
    lower_dq, upper_dq = -1.5, 1.5

    def proj_u(u):
        return jnp.clip(u, lower_u, upper_u)

    def proj_x(x):
        x_ = x.reshape(N, d)
        x_ = x_.at[-1, 2 * n].set(jnp.clip(x_[-1, 2 * n], lower_xf, upper_xf))
        x_ = x_.at[:, n : 2 * n].set(jnp.clip(x_[:, n : 2 * n], lower_dq, upper_dq))
        return x_.reshape(-1)

    rho_x = np.zeros((N, d, d))
    rho_x[-1, 2 * n, 2 * n] = 1e1
    for t in range(N):
        rho_x[t, n : 2 * n, n : 2 * n] = np.eye(n) * 1e-2

    res = ilqr_admm(
        arm.step, arm.get_AB, quad, x_nom0, u0,
        quad_cost=quad, project_x=proj_x, project_u=proj_u,
        rho_x=jnp.asarray(rho_x), rho_u=1e-3,
        max_iter=20, max_admm_iter=10,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50)[:5],
        tol=1e-4,
    )
    xs = np.asarray(res.x_nom)
    us = np.asarray(res.u_nom)
    # constraint oracles
    assert np.abs(us).max() <= upper_u + 0.1, np.abs(us).max()
    assert xs[:, n : 2 * n].max() <= upper_dq + 0.1
    assert xs[:, n : 2 * n].min() >= lower_dq - 0.1
    assert lower_xf - 0.05 <= xs[-1, 2 * n] <= upper_xf + 0.05, xs[-1, 2 * n]
    # reference final cost 0.1996 (c24); ours should be in the same regime
    assert float(res.cost) < 0.35, float(res.cost)
    # constrained >= unconstrained optimum (~0.047 here)
    assert float(res.cost) > 0.04


def test_dp_method_matches_batch_method():
    """DP x-update iLQR-ADMM (the reference's TODO) agrees with batch."""
    from ilqr_admm_tpu.models.arm import PlanarArm

    N = 60
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e4, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = jnp.ones((N, m))
    x_nom0 = rollout_nonlinear(arm.step, x0, u0)

    def proj_u(u):
        return jnp.clip(u, -6.0, 6.0)

    kw = dict(
        quad_cost=quad, project_u=proj_u, rho_u=1e-3,
        max_iter=10, max_admm_iter=8,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50)[:8], tol=1e-4,
    )
    res_b = ilqr_admm(arm.step, arm.get_AB, quad, x_nom0, u0, method="batch", **kw)
    res_d = ilqr_admm(arm.step, arm.get_AB, quad, x_nom0, u0, method="dp", **kw)

    cb, cd = float(res_b.cost), float(res_d.cost)
    assert abs(cb - cd) < 0.1 * max(abs(cb), 1e-9), (cb, cd)
    # both satisfy the bound
    assert float(jnp.max(jnp.abs(res_d.u_nom))) <= 6.0 + 0.1


def test_continuation_matches_fine_rho_solution():
    """Penalty-continuation (coarse rho -> fine rho with scaled-dual
    transport) lands on the same constrained optimum as a long fine-rho
    solve, in fewer total inner iterations."""
    from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm_continuation

    N = 60
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e4, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = jnp.ones((N, m))
    x_nom0 = rollout_nonlinear(arm.step, x0, u0)

    def proj_u(u):
        return jnp.clip(u, -6.0, 6.0)

    shared = dict(
        quad_cost=quad, project_u=proj_u,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50)[:8], tol=1e-4,
    )
    res_fine = ilqr_admm(
        arm.step, arm.get_AB, quad, x_nom0, u0,
        rho_u=1e-3, max_iter=16, max_admm_iter=8, **shared,
    )
    res_cont = ilqr_admm_continuation(
        arm.step, arm.get_AB, quad, x_nom0, u0,
        phases=[
            dict(rho_u=1e-1, max_iter=5, max_admm_iter=5),
            dict(rho_u=1e-3, max_iter=8, max_admm_iter=8),
        ],
        **shared,
    )
    cf, cc = float(res_fine.cost), float(res_cont.cost)
    assert abs(cf - cc) < 0.05 * max(abs(cf), 1e-9), (cf, cc)
    assert float(jnp.max(jnp.abs(res_cont.u_nom))) <= 6.0 + 0.05


def test_outer_line_search_matches_inner():
    """SQP-style line_search='outer' (linear-model inner ADMM + one
    nonlinear line search per outer step — 1 rollout batch instead of
    max_admm_iter of them) reaches the same constrained optimum as the
    reference-semantics inner mode."""
    N = 60
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e4, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = jnp.ones((N, m))
    x_nom0 = rollout_nonlinear(arm.step, x0, u0)

    def proj_u(u):
        return jnp.clip(u, -6.0, 6.0)

    kw = dict(
        quad_cost=quad, project_u=proj_u, rho_u=1e-3,
        max_iter=14, max_admm_iter=8,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50)[:8], tol=1e-4,
    )
    res_i = ilqr_admm(arm.step, arm.get_AB, quad, x_nom0, u0,
                      line_search="inner", **kw)
    res_o = ilqr_admm(arm.step, arm.get_AB, quad, x_nom0, u0,
                      line_search="outer", **kw)
    ci, co = float(res_i.cost), float(res_o.cost)
    assert abs(ci - co) < 0.05 * max(abs(ci), 1e-9), (ci, co)
    assert float(jnp.max(jnp.abs(res_o.u_nom))) <= 6.0 + 0.05

    with pytest.raises(ValueError, match="line_search"):
        ilqr_admm(arm.step, arm.get_AB, quad, x_nom0, u0,
                  line_search="bogus", **kw)
