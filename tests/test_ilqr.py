"""iLQR tests: car parking (control-limited DDP benchmark) and 3DoF arm.

Golden targets (BASELINE.md):
- car parking iLQR (DP): final cost ≈ 0.93 after ≤100 iterations
  (`Car/Replicate of control-limited ddp car example.ipynb` c15);
- 3DoF arm iLQR (DP): converges in ~4-6 iterations to cost ≈ 0.118
  (`3DoF robot/State and control bound constraints.ipynb` c18);
- derivative-correctness: analytic vs autodiff Jacobians agree on the
  simple car (two independent derivative paths, SURVEY §4.6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.arm import PlanarArm
from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost, CarSimple
from ilqr_admm_tpu.ops.riccati import quad_cost_model
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def test_car_jacobians_two_paths(rng):
    car = CarSimple(dt=0.03)
    xs = jnp.asarray(rng.normal(size=(10, 4)))
    us = jnp.asarray(rng.normal(size=(10, 2)))
    A1, B1 = car.get_AB(xs, us)
    A2, B2 = car.get_AB_autodiff(xs, us)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(B1), np.asarray(B2), atol=1e-12)


def test_arm_jacobians_two_paths(rng):
    arm = PlanarArm((1.0, 1.0, 1.0), dt=0.01)
    # autodiff of the full step vs the hand-assembled linearization: the q
    # and q_dot rows must agree exactly; the ee rows agree since fk is exact.
    xs = jnp.asarray(rng.normal(size=(5, arm.x_dim)))
    us = jnp.asarray(rng.normal(size=(5, arm.u_dim)))
    A1, B1 = arm.get_AB(xs, us)
    A2, B2 = arm.get_AB_autodiff(xs, us)
    np.testing.assert_allclose(np.asarray(A1), np.asarray(A2), atol=1e-10)
    np.testing.assert_allclose(np.asarray(B1), np.asarray(B2), atol=1e-10)


def test_arm_fk_matches_geometry():
    arm = PlanarArm((1.0, 1.0, 1.0))
    q = jnp.asarray([np.pi / 2, 0.0, 0.0])
    p = np.asarray(arm.fk(q))
    np.testing.assert_allclose(p, [0.0, 3.0, 0.0], atol=1e-12)
    q = jnp.asarray([0.0, np.pi / 2, -np.pi / 2])
    p = np.asarray(arm.fk(q))
    np.testing.assert_allclose(p, [2.0, 1.0, 0.0], atol=1e-12)


@pytest.mark.slow
def test_car_parking_ilqr_dp():
    N = 500
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost()

    rng = np.random.default_rng(42)
    u0 = jnp.asarray(rng.normal(size=(N, 2)) * 0.1)
    x0 = jnp.asarray([1.0, 1.0, 3.0 * np.pi / 2, 0.0])

    def get_AB(xs, us):
        return car.get_AB(xs, us)

    def get_Cs(xs, us):
        return cost.get_Cs(xs, us)

    state0 = ilqr_init(car.step, cost, x0, u0)
    cfg = ILQRConfig(max_iter=100, max_line_search_iter=40, tol_fun=1e-5)
    out = ilqr_solve(car.step, get_AB, get_Cs, cost, state0, cfg, method="dp")

    # reference final cost ≈ 0.9283 (DDP-replicate c15); allow slack for the
    # different random init
    assert float(out.cost) < 1.1, float(out.cost)
    # parked near the origin with ~zero heading/velocity
    xf = np.asarray(out.x_nom[-1])
    assert np.linalg.norm(xf[:2]) < 0.3, xf
    assert abs(xf[3]) < 0.2, xf


def test_arm_ilqr_dp_quadratic_cost():
    N = 100
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim

    # notebook cell 12: final cost on [q_dot (1e6 each) , x_ee x (1e6), y free?]
    # weights: diag([0]*3 + [x_std]*3 + [0, x_std, 0]) with x_std=1e6,
    # final_pos = [1.5, 1.0, 0]
    x_std, u_std = 1e6, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    q0 = jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4])
    x0 = arm.initial_state(q0)
    u0 = jnp.ones((N, m))

    def cost_fn(xs, us):
        return quad(xs, us)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    state0 = ilqr_init(arm.step, cost_fn, x0, u0)
    cfg = ILQRConfig(max_iter=30, max_line_search_iter=20)
    out = ilqr_solve(arm.step, arm.get_AB, get_Cs, cost_fn, state0, cfg, method="dp")

    # reference: converges in 4-6 iterations to cost ≈ 0.1181 (c18); this
    # implementation reaches a better optimum (≈0.047) — pin "at least as
    # good as the reference" plus the physical oracles below.
    assert int(out.iteration) <= 12, int(out.iteration)
    assert 0.0 < float(out.cost) < 0.13, float(out.cost)
    # final-state oracle: ee y reaches the goal line, joint velocities ~ 0
    xf = np.asarray(out.x_nom[-1])
    assert abs(xf[2 * n + 1] - 1.0) < 5e-2  # ee y ≈ 1.0
    assert np.abs(xf[n : 2 * n]).max() < 5e-2  # q_dot ≈ 0


def test_ilqr_batch_matches_dp_on_arm():
    """Cross-solver oracle: batch LS and DP iLQR reach the same cost."""
    N = 60
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e3, 1e-3
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [x_std, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = jnp.zeros((N, m))

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    state0 = ilqr_init(arm.step, quad, x0, u0)
    cfg = ILQRConfig(max_iter=40, max_line_search_iter=25)
    out_dp = ilqr_solve(arm.step, arm.get_AB, get_Cs, quad, state0, cfg, "dp")
    out_b = ilqr_solve(arm.step, arm.get_AB, get_Cs, quad, state0, cfg, "batch")
    c_dp, c_b = float(out_dp.cost), float(out_b.cost)
    assert abs(c_dp - c_b) < 0.05 * max(abs(c_dp), 1e-6), (c_dp, c_b)


@pytest.mark.slow
def test_sqrt_riccati_solves_stiff_arm_in_f32():
    """Array-form (square-root) Riccati keeps the 1e10-weight-ratio arm
    benchmark solvable in f32; the Cholesky form cannot take a step
    (chol stuck at the initial cost; f64 truth 0.0468). f32 arrays stay
    f32 under the x64 test config."""
    from ilqr_admm_tpu.ops.sqrt_riccati import ilqr_backward_sqrt
    from ilqr_admm_tpu.ops.riccati import ilqr_backward

    N = 100
    f32 = jnp.float32
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N, dtype=f32)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0], f32)
    w = jnp.asarray([0.0] * n + [1e6] * n + [0.0, 1e6, 0.0], f32)
    zs = jnp.stack([jnp.zeros(d, f32), target])
    Qs = jnp.stack([jnp.zeros((d, d), f32), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-4, m)
    assert quad.Q.dtype == f32

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4], f32))
    u0 = jnp.ones((N, m), f32)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    cfg = ILQRConfig(max_iter=30, max_line_search_iter=20)
    s0 = ilqr_init(arm.step, quad, x0, u0)
    out_sqrt = ilqr_solve(arm.step, arm.get_AB, get_Cs, quad, s0, cfg, "dp",
                          riccati="sqrt")
    assert out_sqrt.cost.dtype == f32
    assert float(out_sqrt.cost) < 0.1, float(out_sqrt.cost)  # f64 truth 0.047

    # equivalence of the two forms at full precision
    arm64 = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N, dtype=jnp.float64)
    quad64 = viapoint_cost(zs.astype(jnp.float64), Qs.astype(jnp.float64), seq,
                           1e-4, m)
    cts, Cts = quad_cost_model(quad64.Q, quad64.xd, quad64.R,
                               s0.x_nom.astype(jnp.float64),
                               u0.astype(jnp.float64))
    A64, B64 = arm64.get_AB(s0.x_nom.astype(jnp.float64), u0.astype(jnp.float64))
    K1, k1 = ilqr_backward(A64, B64, Cts, cts)
    K2, k2 = ilqr_backward_sqrt(A64, B64, Cts, cts)
    scale = float(jnp.max(jnp.abs(K1))) + 1e-30
    assert float(jnp.max(jnp.abs(K1 - K2))) / scale < 1e-8


@pytest.mark.slow
def test_ilqr_sls_one_step_exact_on_lq():
    """On a linear-quadratic problem, one method='sls' iteration lands on
    the LQT optimum (cross-solver oracle vs lqt_solve_batch). Completes
    the method triple the reference leaves unimplemented
    (`isls.py:121-122`)."""
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.solvers.ilqr import ilqr_iterate_sls
    from ilqr_admm_tpu.solvers.lqt import lqt_solve_batch
    from ilqr_admm_tpu.problem import line_search_alphas

    N, nb_dim = 40, 2
    di = DoubleIntegrator(nb_dim=nb_dim, nb_deriv=2, dt=0.05)
    d, m = di.x_dim, di.u_dim
    target = jnp.asarray([1.0, 0.5, 0.0, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)

    x0 = jnp.zeros(d)
    u0 = jnp.zeros((N, m))

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def get_AB(xs, us):
        return di.AB(N)

    state0 = ilqr_init(di.step, quad, x0, u0)
    cfg = ILQRConfig(max_iter=5, max_line_search_iter=25)
    alphas = line_search_alphas(cfg, x0.dtype)
    state1, accept, (K, k) = ilqr_iterate_sls(
        di.step, get_AB, get_Cs, quad, state0, alphas
    )
    assert bool(accept)

    A, B = di.AB(N)
    xs_b, us_b = lqt_solve_batch(A, B, quad, x0)
    c_star = float(quad(xs_b, us_b))
    assert abs(float(state1.cost) - c_star) < 1e-6 * max(abs(c_star), 1.0), (
        float(state1.cost), c_star)

    # lifted feedback gains are causal: K[t-block, s-block] = 0 for s > t
    K4 = np.asarray(K).reshape(N, m, N, d)
    for t in range(0, N, 7):
        assert np.abs(K4[t, :, t + 1:]).max() < 1e-8


def test_ilqr_sls_method_matches_dp_on_arm():
    """Nonlinear cross-solver oracle: method='sls' reaches the DP cost."""
    N = 60
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e3, 1e-3
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [x_std, x_std, 0.0])
    zs = jnp.stack([jnp.zeros(d), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = arm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = jnp.zeros((N, m))

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    state0 = ilqr_init(arm.step, quad, x0, u0)
    cfg = ILQRConfig(max_iter=40, max_line_search_iter=25)
    out_dp = ilqr_solve(arm.step, arm.get_AB, get_Cs, quad, state0, cfg, "dp")
    out_sls = ilqr_solve(arm.step, arm.get_AB, get_Cs, quad, state0, cfg, "sls")
    c_dp, c_sls = float(out_dp.cost), float(out_sls.cost)
    assert abs(c_dp - c_sls) < 0.05 * max(abs(c_dp), 1e-6), (c_dp, c_sls)


def test_sqrt_riccati_with_cross_terms():
    """sqrt Riccati now supports Cux != 0 via completion of squares —
    must match the plain backward pass exactly in f64 on random PSD
    Hessians with cross terms."""
    from ilqr_admm_tpu.ops.riccati import ilqr_backward
    from ilqr_admm_tpu.ops.sqrt_riccati import ilqr_backward_sqrt

    rng = np.random.default_rng(3)
    N, d, m = 15, 4, 2
    A = jnp.asarray(rng.normal(size=(N, d, d)) * 0.3 + np.eye(d))
    B = jnp.asarray(rng.normal(size=(N, d, m)) * 0.2)
    # random PSD joint Hessians with genuine cross blocks
    Ls = rng.normal(size=(N, d + m, d + m))
    Cts = jnp.asarray(np.einsum("tij,tkj->tik", Ls, Ls) + np.eye(d + m) * 1e-2)
    cts = jnp.asarray(rng.normal(size=(N, d + m)))
    assert float(jnp.abs(Cts[:, d:, :d]).max()) > 0.1  # cross terms present

    K1, k1 = ilqr_backward(A, B, Cts, cts)
    K2, k2 = ilqr_backward_sqrt(A, B, Cts, cts)
    scale = float(jnp.max(jnp.abs(K1))) + 1e-30
    assert float(jnp.max(jnp.abs(K1 - K2))) / scale < 1e-9
    assert float(jnp.max(jnp.abs(k1 - k2))) / (float(jnp.max(jnp.abs(k1))) + 1e-30) < 1e-9
