"""Constrained LQT-ADMM tests against the reference's golden numbers.

Oracles (SURVEY §4, BASELINE.md):
- control-bounds double integrator (deterministic setup): constrained
  cost ≈ 1.250e1 vs unconstrained ≈ 1.237e1; max |u| ≈ bound 5.0.
- state+control bounds: batch and DP paths agree (reference: identical
  cost 3.09e-2), constraint-satisfaction oracle max violation ≤ tol.
- cost ordering: constrained cost ≥ unconstrained cost.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.problem import ADMMConfig, QuadCost, SolveStatus
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.lqt import lqt_solve_batch
from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_batch, lqt_admm_dp
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def control_bounds_problem(N=100):
    """Double integrator / control-bounds notebook setup (cells 3-6)."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e6])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, plant.u_dim)
    A, B = plant.AB(N)
    return plant, A, B, cost


def state_bounds_problem(N=100):
    """State-bounds notebook setup (cells 3-6): zero tracking cost."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 1.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.zeros((d, d))])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-4, plant.u_dim)
    A, B = plant.AB(N)
    return plant, A, B, cost


def test_control_bounds_batch_golden():
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    xs_unc, us_unc = lqt_solve_batch(A, B, cost, x0)
    cost_unc = float(cost(xs_unc, us_unc))

    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=100, tol=1e-4, log=True)
    x, u, info = lqt_admm_batch(A, B, cost, x0, project_u=proj_u, rho_u=1e-2, cfg=cfg)

    xs = x.reshape(100, -1)
    us = u.reshape(100, -1)
    cost_con = float(cost(xs, us))

    # golden numbers from the reference notebook (cell 11 output)
    assert abs(cost_unc - 12.37) < 0.15, cost_unc
    assert abs(cost_con - 12.50) < 0.15, cost_con
    assert cost_con >= cost_unc
    # constraint-satisfaction oracle: violation within ADMM tolerance scale
    assert float(jnp.max(u)) <= 5.0 + 1e-2
    assert float(jnp.min(u)) >= -5.0 - 1e-2
    # control actually hits the bound (active constraint)
    assert float(jnp.max(jnp.abs(u))) > 4.99


def test_control_bounds_dp_matches_batch():
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    xb, ub, _ = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=200, tol=1e-5),
    )
    xd, ud, (K, k), _ = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-1,
        cfg=ADMMConfig(max_iter=500, tol=1e-4),
    )
    cb = float(cost(xb.reshape(100, -1), ub.reshape(100, -1)))
    cd = float(cost(xd.reshape(100, -1), ud.reshape(100, -1)))
    assert abs(cb - cd) < 0.02 * abs(cb), (cb, cd)
    assert K.shape == (100, plant.u_dim, plant.x_dim)


def test_state_and_control_bounds_both_paths():
    """State-bounds notebook cells 12-14: final-state pin via projection."""
    plant, A, B, cost = state_bounds_problem()
    N, d = 100, plant.x_dim
    x0 = jnp.zeros(d)

    def proj_x(x):
        x_ = x.reshape(N, d)
        x_ = x_.at[-1, 0].set(jnp.clip(x_[-1, 0], 0.5, 0.5))
        x_ = x_.at[-1, 1].set(0.0)
        return x_.reshape(-1)

    proj_u = lambda u: project_bound(u, -3.0, 3.0)

    rho_x = np.zeros((N, d, d))
    rho_x[-1, 0, 0] = 1e1
    rho_x[-1, 1, 1] = 1e1

    xb, ub, _ = lqt_admm_batch(
        A, B, cost, x0, project_x=proj_x, project_u=proj_u,
        rho_x=jnp.asarray(rho_x), rho_u=1e-3,
        cfg=ADMMConfig(max_iter=500, tol=1e-3),
    )
    xd_, ud_, _, _ = lqt_admm_dp(
        A, B, cost, x0, project_x=proj_x, project_u=proj_u,
        rho_x=jnp.asarray(rho_x), rho_u=1e-3,
        cfg=ADMMConfig(max_iter=5000, tol=1e-4),
    )
    cb = float(cost(xb.reshape(N, d), ub.reshape(N, -1)))
    cd = float(cost(xd_.reshape(N, d), ud_.reshape(N, -1)))

    # reference golden: both paths 3.09e-2 (cells 13/14)
    assert abs(cb - 3.09e-2) < 5e-3, cb
    assert abs(cd - 3.09e-2) < 5e-3, cd

    # constraint oracles: final position ~0.5, final velocity ~0, u in bounds
    for xf, uf in [(xb, ub), (xd_, ud_)]:
        xs = np.asarray(xf).reshape(N, d)
        us = np.asarray(uf).reshape(N, -1)
        assert abs(xs[-1, 0] - 0.5) < 2e-2
        assert abs(xs[-1, 1]) < 2e-2
        assert np.abs(us).max() <= 3.0 + 1e-2


def test_qr_sqrt_admm_matches_cholesky_in_f64():
    """QR (square-root) x-update == normal-equation path at full precision,
    and stays accurate in f32 where the normal equations lose 40x (measured
    max|u| 5.039 vs 5.0002 at x_std=1e6 in f32)."""
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=100, tol=1e-4)

    x_c, u_c, _ = lqt_admm_batch(A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
                                 cfg=cfg)
    x_q, u_q, _ = lqt_admm_batch(A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
                                 cfg=cfg, use_qr=True)
    np.testing.assert_allclose(np.asarray(u_q), np.asarray(u_c), atol=1e-6)
    np.testing.assert_allclose(np.asarray(x_q), np.asarray(x_c), atol=1e-6)


def test_dp_operator_form_matches_scan_form():
    """Operator-form DP-ADMM (precomputed affine sweep) == scan form."""
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=200, tol=1e-4)

    x_s, u_s, (K_s, k_s), _ = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-1, cfg=cfg,
        operator_form=False,
    )
    x_o, u_o, (K_o, k_o), _ = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-1, cfg=cfg,
        operator_form=True,
    )
    np.testing.assert_allclose(np.asarray(u_o), np.asarray(u_s), atol=1e-8)
    np.testing.assert_allclose(np.asarray(x_o), np.asarray(x_s), atol=1e-8)
    np.testing.assert_allclose(np.asarray(k_o), np.asarray(k_s), atol=1e-8)


@pytest.mark.slow
def test_admm_against_scipy_qp_oracle(rng):
    """Independent oracle: control-bounded LQT is a bounded least-squares
    problem; scipy.optimize.lsq_linear solves it exactly. Our ADMM (tight
    tolerance) must match the oracle's optimum."""
    from scipy.optimize import lsq_linear
    from ilqr_admm_tpu.ops.lifted import build_Su, sw_x0
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked

    N, d, m = 30, 2, 1
    for trial in range(3):
        A_np = np.eye(d) + rng.normal(size=(d, d)) * 0.05
        B_np = rng.normal(size=(d, m)) * 0.1
        A = jnp.broadcast_to(jnp.asarray(A_np), (N, d, d))
        B = jnp.broadcast_to(jnp.asarray(B_np), (N, d, m))
        Qd = rng.uniform(0.1, 10.0, size=(N, d))
        Q = jnp.asarray(np.stack([np.diag(q) for q in Qd]))
        xd = jnp.asarray(rng.normal(size=(N, d)))
        R = jnp.broadcast_to(jnp.eye(m) * 1e-2, (N, m, m))
        cost = QuadCost(Q=Q, xd=xd, R=R)
        x0 = jnp.asarray(rng.normal(size=d) * 0.3)
        lo, hi = -0.8, 0.8

        # scipy oracle: min ||sqrtQ (Su u - (xd - free))||^2 + ||sqrtR u||^2
        Su = np.asarray(build_Su(A, B))
        free = np.asarray(sw_x0(A, x0)).reshape(-1)
        sqQ = np.sqrt(np.asarray(block_diag_stacked(Q)))
        sqR = np.sqrt(np.asarray(block_diag_stacked(R)))
        G = np.concatenate([sqQ @ Su, sqR], axis=0)
        c = np.concatenate([sqQ @ (np.asarray(cost.lifted_xd()) - free),
                            np.zeros(N * m)])
        oracle = lsq_linear(G, c, bounds=(lo, hi), tol=1e-14)
        u_star = oracle.x

        proj = lambda u: project_bound(u, lo, hi)
        _, u_admm, info = lqt_admm_batch(
            A, B, cost, x0, project_u=proj, rho_u=1e-1,
            cfg=ADMMConfig(max_iter=3000, tol=1e-9, stall_tol=1e-12),
        )
        u_admm = np.clip(np.asarray(u_admm), lo, hi)  # feasible iterate
        # optimality oracle: relative objective gap vs the exact QP optimum
        def obj(u):
            r = G @ u - c
            return float(r @ r)

        gap = (obj(u_admm) - obj(u_star)) / max(obj(u_star), 1e-12)
        assert gap < 1e-5, (trial, gap)
        # iterate distance (loose — ADMM convergence rate is rho-dependent)
        assert float(np.max(np.abs(u_admm - u_star))) < 1e-2, trial


def test_adaptive_rho_converges_faster_from_bad_rho():
    """Residual-balancing penalties (ADMMConfig.adaptive_rho): from a
    deliberately mis-scaled rho_u, the adaptive run must reach the same
    solution and converge in no more iterations than the fixed-rho run.
    (Not in the reference — fixed rho throughout, `admm.py:6-106`.)"""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    bad_rho = 1e-5  # 1000x too small for this problem
    fixed = ADMMConfig(max_iter=400, tol=1e-4)
    adapt = ADMMConfig(max_iter=400, tol=1e-4, adaptive_rho=True,
                       rho_scale_max=1e8)

    xf, uf, info_f = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=bad_rho, cfg=fixed)
    xa, ua, info_a = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=bad_rho, cfg=adapt)

    us_f = np.asarray(uf).reshape(N, -1)
    us_a = np.asarray(ua).reshape(N, -1)
    cost_a = float(cost(xa.reshape(N, -1), ua.reshape(N, -1)))

    # adaptive run satisfies the bound and hits the golden cost
    assert np.abs(us_a).max() <= 5.0 + 1e-2
    assert abs(cost_a - 1.250e1) < 2e-1, cost_a

    # fixed-rho from the bad start cannot enforce the bound (measured:
    # max|u| ~ 5.88, primal residual ~ 2.3 when it stalls); balancing
    # recovers a ~100x smaller violation and residual
    viol_f = max(np.abs(us_f).max() - 5.0, 0.0)
    viol_a = max(np.abs(us_a).max() - 5.0, 0.0)
    assert viol_f > 0.5, viol_f
    assert viol_a < 0.02 * viol_f, (viol_a, viol_f)
    assert float(info_a.prim_res) < 0.05 * float(info_f.prim_res)


def test_adaptive_rho_matches_fixed_solution():
    """Adaptive and fixed rho reach the same constrained optimum."""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    _, uf, _ = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-5))
    _, ua, _ = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-5, adaptive_rho=True))
    np.testing.assert_allclose(np.asarray(ua), np.asarray(uf), atol=5e-3)


def test_accel_matches_plain_solution():
    """Nesterov-accelerated ADMM (ADMMConfig.accel, Goldstein et al. 2014
    Alg. 8) reaches the same constrained optimum as plain ADMM, in no
    more iterations. (Not in the reference — plain ADMM throughout,
    `admm.py:6-106`.)"""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    _, up, info_p = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-6, stall_tol=1e-15))
    _, ua, info_a = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-6, stall_tol=1e-15, accel=True))
    np.testing.assert_allclose(np.asarray(ua), np.asarray(up), atol=1e-4)
    assert int(info_a.iters) <= int(info_p.iters)
    assert float(jnp.max(jnp.abs(ua))) <= 5.0 + 1e-4


def test_accel_converges_faster_from_bad_rho():
    """From a 1000x-too-small rho (where plain ADMM needs >>10k
    iterations: its linear rate degrades with the penalty mis-scaling),
    momentum + restart converges to the golden solution in a few hundred
    (measured: 654 at the default accel_eta=1.02 vs 20,000+ plain)."""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    cfg = ADMMConfig(max_iter=1000, tol=1e-4, stall_tol=1e-15, accel=True)
    xa, ua, info_a = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-5, cfg=cfg)
    assert int(info_a.status) == SolveStatus.CONVERGED
    assert int(info_a.iters) < 700, int(info_a.iters)
    cost_a = float(cost(xa.reshape(N, -1), ua.reshape(N, -1)))
    assert abs(cost_a - 1.250e1) < 2e-1, cost_a
    assert float(jnp.max(jnp.abs(ua))) <= 5.0 + 1e-2

    # plain ADMM is nowhere near converged within the same budget
    _, _, info_p = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-5,
        cfg=ADMMConfig(max_iter=1000, tol=1e-4, stall_tol=1e-15))
    assert int(info_p.status) != SolveStatus.CONVERGED


def test_anderson_matches_plain_solution():
    """Safeguarded type-II Anderson acceleration (ADMMConfig.anderson_m,
    Walker & Ni 2011) reaches the same constrained optimum as plain ADMM
    in strictly fewer iterations on the control-bounds LQT (measured:
    8 vs 24 at m=5). Returned iterates come from a plain evaluation, so
    the projected z is exactly feasible."""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    _, up, info_p = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-6, stall_tol=1e-15))
    xa, ua, info_a = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-6, stall_tol=1e-15,
                       anderson_m=5))
    np.testing.assert_allclose(np.asarray(ua), np.asarray(up), atol=1e-4)
    assert int(info_a.status) == SolveStatus.CONVERGED
    assert int(info_a.iters) < int(info_p.iters)
    assert float(jnp.max(jnp.abs(ua))) <= 5.0 + 1e-6


def test_anderson_converges_from_bad_rho():
    """From a 1000x-too-small rho, Anderson (m=5) converges in a few
    dozen iterations (measured: 21) where plain ADMM needs >20,000 and
    Nesterov momentum ~650 — the extrapolation solves out the slow
    linear consensus tail instead of merely damping it."""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    xa, ua, info_a = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-5,
        cfg=ADMMConfig(max_iter=500, tol=1e-6, stall_tol=1e-15,
                       anderson_m=5))
    assert int(info_a.status) == SolveStatus.CONVERGED
    assert int(info_a.iters) < 60, int(info_a.iters)
    cost_a = float(cost(xa.reshape(N, -1), ua.reshape(N, -1)))
    assert abs(cost_a - 1.250e1) < 2e-1, cost_a
    assert float(jnp.max(jnp.abs(ua))) <= 5.0 + 1e-6

    # plain ADMM is nowhere near converged within the same budget
    _, _, info_p = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-5,
        cfg=ADMMConfig(max_iter=500, tol=1e-6, stall_tol=1e-15))
    assert int(info_p.status) != SolveStatus.CONVERGED


def test_anderson_agrees_across_saturation_regimes():
    """Anderson and plain ADMM reach the same fixed point across bound
    regimes — inactive (projection is the identity at the optimum),
    moderately active, and heavily saturated — over random targets.
    Guards the extrapolation against regime-dependent corner cases
    (e.g. zero residual from iteration 1 when nothing binds)."""
    plant, A, B, _ = control_bounds_problem()
    N = 100
    d, m = plant.x_dim, plant.u_dim
    rng_ = np.random.default_rng(42)
    for bound in (1e3, 5.0, 1.5):  # inactive / moderate / heavy
        for trial in range(2):
            target = jnp.asarray(rng_.normal(0, 1.0, d))
            zs = jnp.stack([jnp.zeros(d), target])
            Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
            seq = np.zeros(N, dtype=np.int32)
            seq[-1] = 1
            cost_t = viapoint_cost(zs, Qs, seq, 1e-2, m)
            proj = lambda u, b=bound: project_bound(u, -b, b)
            x0 = jnp.asarray(rng_.normal(0, 0.2, d))
            _, up, ip = lqt_admm_batch(
                A, B, cost_t, x0, project_u=proj, rho_u=1e-2,
                cfg=ADMMConfig(max_iter=2000, tol=1e-8, stall_tol=1e-15))
            _, ua, ia = lqt_admm_batch(
                A, B, cost_t, x0, project_u=proj, rho_u=1e-2,
                cfg=ADMMConfig(max_iter=2000, tol=1e-8, stall_tol=1e-15,
                               anderson_m=5))
            assert int(ia.status) == SolveStatus.CONVERGED, (bound, trial)
            assert int(ia.iters) <= int(ip.iters), (bound, trial)
            np.testing.assert_allclose(
                np.asarray(ua), np.asarray(up), atol=1e-6,
                err_msg=f"bound={bound} trial={trial}")


def test_anderson_returns_best_plain_iterate():
    """With an INEXACT projection (deliberate deterministic wobble — the
    stand-in for nested inner-ADMM z-updates solved to loose tolerance),
    Anderson extrapolation can wander; the driver must return the
    best-scoring plain iterate of the run, never an arbitrary late one
    (measured on robust sls_admm before this guarantee: m=5 handed back
    a primal residual of 1.4 where plain sat at 1e-5)."""
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)

    def proj_u_noisy(u):
        base = project_bound(u, -5.0, 5.0)
        return base + 2e-3 * jnp.sin(
            37.0 * jnp.arange(base.shape[0]) + 50.0 * jnp.sum(base)
        )

    _, _, info = lqt_admm_batch(
        A, B, cost, x0, project_u=proj_u_noisy, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=80, tol=1e-12, stall_tol=1e-15,
                       anderson_m=5, log=True))
    iters = int(info.iters)
    scores = np.asarray(info.logs[:iters]).sum(axis=1)
    returned = float(info.prim_res) + float(info.dual_res)
    assert returned <= scores.min() + 1e-12, (returned, scores.min())


def test_anderson_vmaps_over_instances():
    """The Anderson path must vmap like the plain driver (fleet solvers
    and the batched arm bench vmap the whole solve): batched solves
    equal per-instance solves."""
    plant, A, B, cost = control_bounds_problem()
    N = 100
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=200, tol=1e-6, stall_tol=1e-15, anderson_m=5)

    x0s = jnp.asarray(
        np.random.default_rng(0).normal(0, 0.2, (6, plant.x_dim)))
    solve = jax.vmap(
        lambda x0: lqt_admm_batch(
            A, B, cost, x0, project_u=proj_u, rho_u=1e-2, cfg=cfg)[1]
    )
    us_b = np.asarray(solve(x0s))
    for i in range(x0s.shape[0]):
        _, u_i, _ = lqt_admm_batch(
            A, B, cost, x0s[i], project_u=proj_u, rho_u=1e-2, cfg=cfg)
        np.testing.assert_allclose(us_b[i], np.asarray(u_i), atol=1e-8)


def test_anderson_rejects_accel_and_adaptive():
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    for bad in (dict(accel=True), dict(adaptive_rho=True)):
        with pytest.raises(ValueError, match="anderson"):
            lqt_admm_batch(
                A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
                cfg=ADMMConfig(max_iter=10, anderson_m=5, **bad))


def test_accel_rejects_adaptive_rho():
    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    with pytest.raises(ValueError, match="accel"):
        lqt_admm_batch(
            A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
            cfg=ADMMConfig(max_iter=10, accel=True, adaptive_rho=True))


def test_l1_sparse_control_matches_oracle(rng):
    """l1-regularized (sparse) control via prox-ADMM (PAPERS.md: "An ADMM
    Algorithm for Solving l1 Regularized MPC" — beyond the reference,
    whose z-updates are all set projections). Oracle: the same problem as
    a smooth QP over the split u = p - n, p,n >= 0 (L-BFGS-B)."""
    from scipy.optimize import minimize
    from ilqr_admm_tpu.ops.lifted import build_Su, sw_x0
    from ilqr_admm_tpu.projections import prox_l1
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked

    N, d, m = 30, 2, 1
    A_np = np.eye(d) + rng.normal(size=(d, d)) * 0.05
    B_np = rng.normal(size=(d, m)) * 0.1
    A = jnp.broadcast_to(jnp.asarray(A_np), (N, d, d))
    B = jnp.broadcast_to(jnp.asarray(B_np), (N, d, m))
    Qd = rng.uniform(0.1, 10.0, size=(N, d))
    Q = jnp.asarray(np.stack([np.diag(q) for q in Qd]))
    xd = jnp.asarray(rng.normal(size=(N, d)))
    R = jnp.broadcast_to(jnp.eye(m) * 1e-2, (N, m, m))
    cost = QuadCost(Q=Q, xd=xd, R=R)
    x0 = jnp.asarray(rng.normal(size=d) * 0.3)

    Su = np.asarray(build_Su(A, B))
    free = np.asarray(sw_x0(A, x0)).reshape(-1)
    sqQ = np.sqrt(np.asarray(block_diag_stacked(Q)))
    sqR = np.sqrt(np.asarray(block_diag_stacked(R)))
    G = np.concatenate([sqQ @ Su, sqR], axis=0)
    c = np.concatenate([sqQ @ (np.asarray(cost.lifted_xd()) - free),
                        np.zeros(N * m)])
    gamma = 1.0

    def full_obj(u):
        r = G @ u - c
        return float(r @ r) + gamma * float(np.sum(np.abs(u)))

    # oracle: u = p - n with p, n >= 0 makes the objective smooth
    GtG, Gtc = G.T @ G, G.T @ c

    def split_obj(w):
        p, n = w[: N * m], w[N * m:]
        u = p - n
        grad_u = 2.0 * (GtG @ u - Gtc)
        val = float(u @ GtG @ u - 2.0 * Gtc @ u + c @ c) + gamma * float(
            np.sum(p) + np.sum(n)
        )
        return val, np.concatenate([grad_u + gamma, -grad_u + gamma])

    w0 = np.zeros(2 * N * m)
    res = minimize(split_obj, w0, jac=True, method="L-BFGS-B",
                   bounds=[(0, None)] * (2 * N * m),
                   options=dict(maxiter=5000, ftol=1e-15, gtol=1e-12))
    u_star = res.x[: N * m] - res.x[N * m:]

    rho = 1e-1
    # no-1/2 penalty convention: z-update min γ||z||_1 + ρ||x̂ - z + λ||²
    proj = lambda u: prox_l1(u, gamma / (2.0 * rho))
    _, u_admm, info = lqt_admm_batch(
        A, B, cost, x0, project_u=proj, rho_u=rho,
        cfg=ADMMConfig(max_iter=4000, tol=1e-10, stall_tol=1e-13),
    )
    u_admm = np.asarray(u_admm)

    gap = (full_obj(u_admm) - full_obj(u_star)) / max(abs(full_obj(u_star)), 1e-12)
    assert gap < 1e-5, gap
    # the l1 term must actually induce sparsity in the optimum, and the
    # ADMM x-iterate must track the oracle everywhere, including its
    # (near-)zero support
    scale = np.max(np.abs(u_star))
    assert np.sum(np.abs(u_star) < 1e-8 * scale) > 0, "gamma too small for the test"
    assert np.max(np.abs(u_admm - u_star)) < 1e-3 * scale
    assert np.all(np.abs(u_admm)[np.abs(u_star) < 1e-8 * scale] < 1e-4 * scale)


def test_prox_l1_properties(rng):
    from ilqr_admm_tpu.projections import prox_l1, prox_l1_box

    v = jnp.asarray(rng.normal(size=64) * 2.0)
    t = 0.7
    p = prox_l1(v, t)
    # Moreau identity: v - prox_{t||.||_1}(v) = clip(v, -t, t)
    np.testing.assert_allclose(np.asarray(v - p), np.clip(np.asarray(v), -t, t),
                               atol=1e-12)
    # exact zeros inside the threshold band
    assert np.all(np.asarray(p)[np.abs(np.asarray(v)) <= t] == 0.0)
    # box composition == brute-force scalar minimization
    lo, hi = -0.5, 1.2
    pb = np.asarray(prox_l1_box(v, t, lo, hi))
    zs = np.linspace(lo, hi, 20001)
    for i in range(0, 64, 7):
        # prox convention: argmin 0.5 (z - v)^2 + t |z| over the box
        vals = 0.5 * (zs - float(v[i])) ** 2 + t * np.abs(zs)
        z_best = zs[np.argmin(vals)]
        assert abs(pb[i] - z_best) < 1e-3, (i, pb[i], z_best)


def test_constraint_block_pairing_validated():
    """A projection without its rho (or vice versa) is a loud error, not
    a silent unconstrained/biased solve (code-review finding: the
    reference crashes with an opaque TypeError in the same situations)."""
    plant, A, B, cost = control_bounds_problem(N=20)
    x0 = jnp.zeros(plant.x_dim)
    proj = lambda u: project_bound(u, -5.0, 5.0)
    with pytest.raises(ValueError, match="rho_u"):
        lqt_admm_batch(A, B, cost, x0, project_u=proj)  # no rho_u
    with pytest.raises(ValueError, match="rho_x"):
        lqt_admm_batch(A, B, cost, x0, project_u=proj, rho_u=1e-2, rho_x=1.0)
    from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_dp
    with pytest.raises(ValueError, match="rho_u"):
        lqt_admm_dp(A, B, cost, x0, project_u=proj)
    from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
    with pytest.raises(ValueError, match="rho_u"):
        make_batched_lqt_admm(A, B, cost, project_u=lambda u: u)


def test_adaptive_rho_unsupported_xupdate_clear_error():
    """adaptive_rho with an x-update that does not take a rho scale gives
    a clear error at the boundary, not a TypeError from tracing."""
    plant, A, B, cost = control_bounds_problem(N=20)
    x0 = jnp.zeros(plant.x_dim)
    proj = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=5, adaptive_rho=True)
    with pytest.raises(ValueError, match="adaptive_rho"):
        lqt_admm_batch(A, B, cost, x0, project_u=proj, rho_u=1e-2,
                       cfg=cfg, use_qr=True)


def test_ilqr_unknown_method_raises():
    from ilqr_admm_tpu.models.car import CarSimple
    from ilqr_admm_tpu.ops.riccati import quad_cost_model
    from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
    from ilqr_admm_tpu.problem import ILQRConfig
    from ilqr_admm_tpu.solvers.ilqr import ilqr_init, ilqr_solve
    from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    H = 10
    car = CarSimple(dt=0.1)
    target = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    zs = jnp.stack([target, target])
    Qs = jnp.stack([jnp.eye(4), jnp.eye(4)])
    seq = np.zeros(H, dtype=np.int32); seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, 2)
    get_Cs = lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)
    x0 = jnp.zeros(4)
    u0 = jnp.zeros((H, 2))
    s0 = ilqr_init(car.step, quad, x0, u0)
    with pytest.raises(ValueError, match="method"):
        ilqr_solve(car.step, car.get_AB, get_Cs, quad, s0,
                   ILQRConfig(max_iter=2), method="DP")
    xs = rollout_nonlinear(car.step, x0, u0)
    with pytest.raises(ValueError, match="method"):
        ilqr_admm(car.step, car.get_AB, quad, xs, u0, get_Cs=get_Cs,
                  project_u=lambda u: u, rho_u=1e-1, method="sls")


def test_adaptive_rho_dp_matches_fixed_solution():
    """Adaptive-rho DP x-update (previously errored) —
    reaches the fixed-rho constrained optimum."""
    from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_dp

    plant, A, B, cost = control_bounds_problem()
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    _, uf, _, _ = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-5))
    _, ua, _, info = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-2,
        cfg=ADMMConfig(max_iter=300, tol=1e-5, adaptive_rho=True))
    np.testing.assert_allclose(np.asarray(ua), np.asarray(uf), atol=5e-3)


def test_adaptive_rho_dp_recovers_from_bad_rho():
    """From a 1000x-too-small rho, residual balancing converges where the
    fixed penalty is nowhere near within the same budget."""
    from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_dp

    plant, A, B, cost = control_bounds_problem()
    N = 100
    x0 = jnp.zeros(plant.x_dim)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)

    xa, ua, _, info_a = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-5,
        cfg=ADMMConfig(max_iter=400, tol=1e-4, stall_tol=1e-15,
                       adaptive_rho=True))
    assert int(info_a.status) == SolveStatus.CONVERGED, int(info_a.status)
    cost_a = float(cost(xa.reshape(N, -1), ua.reshape(N, -1)))
    assert abs(cost_a - 1.250e1) < 2e-1, cost_a
    assert float(jnp.max(jnp.abs(ua))) <= 5.0 + 1e-2

    _, _, _, info_f = lqt_admm_dp(
        A, B, cost, x0, project_u=proj_u, rho_u=1e-5,
        cfg=ADMMConfig(max_iter=400, tol=1e-4, stall_tol=1e-15))
    assert int(info_f.status) != SolveStatus.CONVERGED
