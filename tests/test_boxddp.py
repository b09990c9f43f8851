"""First-class constrained DP: boxQP / boxDDP / barrier-iLQR tests.

Oracles:
- boxqp vs. scipy L-BFGS-B on random strictly convex QPs;
- boxDDP with inactive bounds == unconstrained iLQR;
- boxDDP on the LQ double integrator with |u| <= 5 matches the lifted
  ADMM solution (reference golden: ADMM cost 1.250e1, control-bounds
  notebook c11) — two completely independent constrained solvers;
- barrier iLQR with a per-stage SOC ||u_t|| <= s matches ADMM with the
  exact ball projection, and iterates are strictly feasible.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.boxqp import boxqp
from ilqr_admm_tpu.ops.riccati import quad_cost_model
from ilqr_admm_tpu.problem import ADMMConfig, ILQRConfig
from ilqr_admm_tpu.solvers.barrier_ilqr import barrier_ilqr_solve, make_barrier
from ilqr_admm_tpu.solvers.boxddp import boxddp_init, boxddp_solve
from ilqr_admm_tpu.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def _lq_setup(nb_deriv=2, m=1, N=100, u_std=1e-2):
    plant = DoubleIntegrator(m, nb_deriv, dt=1.0 / N)
    plant.get_AB = lambda xs, us: plant.AB(xs.shape[0])
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.ones(d).at[d // 2 :].set(0.0)])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(jnp.asarray(zs), jnp.asarray(Qs), seq, u_std, plant.u_dim)
    return plant, cost


class TestBoxQP:
    @pytest.mark.slow
    def test_matches_lbfgsb(self, rng):
        from scipy.optimize import minimize

        for _ in range(20):
            m = 4
            M = rng.normal(size=(m, m))
            H = M @ M.T + 0.5 * np.eye(m)
            g = rng.normal(size=m) * 3.0
            lb, ub = -np.abs(rng.normal(size=m)), np.abs(rng.normal(size=m))
            u, free = boxqp(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub))
            ref = minimize(
                lambda z: 0.5 * z @ H @ z + g @ z,
                np.clip(np.zeros(m), lb, ub),
                jac=lambda z: H @ z + g,
                bounds=list(zip(lb, ub)),
                method="L-BFGS-B",
                options={"ftol": 1e-14, "gtol": 1e-12},
            )
            np.testing.assert_allclose(np.asarray(u), ref.x, atol=1e-6)
            # free mask consistency: clamped dims sit exactly at a bound
            ufree = np.asarray(free)
            at_bound = (np.asarray(u) <= lb + 1e-8) | (np.asarray(u) >= ub - 1e-8)
            assert np.all(at_bound[~ufree])

    def test_unconstrained_interior(self, rng):
        H = jnp.eye(3) * 2.0
        g = jnp.asarray([0.1, -0.2, 0.05])
        u, free = boxqp(H, g, -10.0, 10.0)
        np.testing.assert_allclose(np.asarray(u), np.asarray(-g / 2.0), atol=1e-10)
        assert bool(jnp.all(free))


class TestBoxDDP:
    def test_inactive_bounds_match_unconstrained(self):
        plant, cost = _lq_setup()
        N = 100
        x0 = jnp.zeros(plant.x_dim)
        u0 = jnp.zeros((N, plant.u_dim))
        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)

        st_u = ilqr_solve(
            plant.step, plant.get_AB, get_Cs, cost, ilqr_init(plant.step, cost, x0, u0),
            cfg=ILQRConfig(max_iter=30),
        )
        st_b = boxddp_solve(
            plant.step, plant.get_AB, get_Cs, cost,
            boxddp_init(plant.step, cost, x0, u0, -1e6, 1e6),
            u_lower=-1e6, u_upper=1e6, cfg=ILQRConfig(max_iter=30),
        )
        assert abs(float(st_b.cost) - float(st_u.cost)) < 1e-6 * max(1.0, float(st_u.cost))

    def test_control_bounds_match_admm_golden(self):
        # reference golden (control-bounds c11): constrained cost 1.250e1,
        # unconstrained 1.237e1, max |u| hugs the bound 5.
        from ilqr_admm_tpu.projections import project_bound
        from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_batch

        plant, cost = _lq_setup(nb_deriv=2, m=1, N=100)
        N = 100
        A, B = plant.AB(N)
        x0 = jnp.zeros(plant.x_dim)
        xf, uf, _ = lqt_admm_batch(
            A, B, cost, x0,
            project_u=lambda u: project_bound(u, -5.0, 5.0),
            rho_u=1e-2, cfg=ADMMConfig(max_iter=300, tol=1e-6),
        )
        u_admm = uf.reshape(N, plant.u_dim)
        c_admm = float(cost(xf.reshape(N, -1), u_admm))

        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
        st = boxddp_solve(
            plant.step, plant.get_AB, get_Cs, cost,
            boxddp_init(plant.step, cost, x0, jnp.zeros((N, 1)), -5.0, 5.0),
            u_lower=-5.0, u_upper=5.0, cfg=ILQRConfig(max_iter=60, tol_fun=1e-10),
        )
        assert float(jnp.max(jnp.abs(st.u_nom))) <= 5.0 + 1e-9  # exact feasibility
        # two independent constrained solvers agree on the optimum
        assert abs(float(st.cost) - c_admm) < 2e-3 * max(1.0, abs(c_admm)), (
            float(st.cost), c_admm,
        )
        # bound is active at the optimum
        assert float(jnp.max(jnp.abs(st.u_nom))) > 4.99

    def test_vmaps_over_instances(self):
        plant, cost = _lq_setup()
        N = 100
        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)

        def solve_one(x0):
            st0 = boxddp_init(plant.step, cost, x0, jnp.zeros((N, plant.u_dim)), -5.0, 5.0)
            return boxddp_solve(
                plant.step, plant.get_AB, get_Cs, cost, st0,
                u_lower=-5.0, u_upper=5.0, cfg=ILQRConfig(max_iter=20),
            ).cost

        x0s = jnp.asarray(np.random.default_rng(1).normal(0, 0.1, size=(4, plant.x_dim)))
        costs = jax.jit(jax.vmap(solve_one))(x0s)
        assert costs.shape == (4,) and bool(jnp.all(jnp.isfinite(costs)))


class TestBarrierILQR:
    def test_soc_matches_admm_ball_projection(self):
        # per-stage ball ||u_t|| <= s on a 2-input double integrator
        from ilqr_admm_tpu.projections import project_quadratic
        from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_batch

        plant, cost = _lq_setup(nb_deriv=2, m=2, N=60)
        N = 60
        s = 3.0
        A, B = plant.AB(N)
        x0 = jnp.zeros(plant.x_dim)

        def proj_u(u):
            # ball of radius s: 0.5 ||v||^2 <= 0.5 s^2
            return jax.vmap(lambda v: project_quadratic(v, 0.0, 0.5 * s * s))(
                u.reshape(N, 2)
            ).reshape(-1)

        # converged oracle (also cross-checked against scipy SLSQP at
        # 394.17634 during development): slack rho under-converges here
        xf, uf, _ = lqt_admm_batch(
            A, B, cost, x0, project_u=proj_u, rho_u=1e-1,
            cfg=ADMMConfig(max_iter=4000, tol=1e-10),
        )
        c_admm = float(cost(xf.reshape(N, -1), uf.reshape(N, 2)))

        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
        barrier = make_barrier(soc=lambda x, u: [(jnp.asarray(s, u.dtype), u)])
        st = barrier_ilqr_solve(
            plant.step, plant.get_AB, get_Cs, cost,
            x0, jnp.zeros((N, 2)), barrier,
            cfg=ILQRConfig(max_iter=40, tol_fun=1e-10),
            mu0=1.0, mu_factor=8.0, n_barrier=7,
        )
        norms = jnp.linalg.norm(st.u_nom, axis=-1)
        assert float(norms.max()) <= s + 1e-9  # strictly feasible
        assert abs(float(st.cost) - c_admm) < 5e-3 * max(1.0, abs(c_admm)), (
            float(st.cost), c_admm,
        )
        # the cone is active at the optimum (else the test proves nothing)
        assert float(norms.max()) > 0.95 * s

    def test_elementwise_barrier_matches_boxddp(self):
        plant, cost = _lq_setup(nb_deriv=2, m=1, N=80)
        N = 80
        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
        x0 = jnp.zeros(plant.x_dim)

        st_box = boxddp_solve(
            plant.step, plant.get_AB, get_Cs, cost,
            boxddp_init(plant.step, cost, x0, jnp.zeros((N, 1)), -5.0, 5.0),
            u_lower=-5.0, u_upper=5.0, cfg=ILQRConfig(max_iter=60, tol_fun=1e-10),
        )
        barrier = make_barrier(
            ineq=lambda x, u: jnp.concatenate([u + 5.0, 5.0 - u])
        )
        st_bar = barrier_ilqr_solve(
            plant.step, plant.get_AB, get_Cs, cost,
            x0, jnp.zeros((N, 1)), barrier,
            cfg=ILQRConfig(max_iter=40, tol_fun=1e-10),
            mu0=1.0, mu_factor=8.0, n_barrier=7,
        )
        assert float(jnp.max(jnp.abs(st_bar.u_nom))) <= 5.0
        assert abs(float(st_bar.cost) - float(st_box.cost)) < 5e-3 * max(
            1.0, abs(float(st_box.cost))
        )

    def test_infeasible_init_fails_cleanly(self):
        plant, cost = _lq_setup(nb_deriv=2, m=1, N=20)
        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
        barrier = make_barrier(ineq=lambda x, u: jnp.concatenate([u + 0.1, 0.1 - u]))
        st = barrier_ilqr_solve(
            plant.step, plant.get_AB, get_Cs, cost,
            jnp.zeros(plant.x_dim), jnp.ones((20, 1)),  # |u|=1 > 0.1: infeasible
            barrier, cfg=ILQRConfig(max_iter=5), n_barrier=2,
        )
        assert not bool(jnp.isfinite(cost(st.x_nom, st.u_nom)) & (jnp.max(jnp.abs(st.u_nom)) <= 0.1))


class TestFacade:
    def test_facade_boxddp_and_barrier(self):
        from ilqr_admm_tpu import iSLS

        plant, cost = _lq_setup(nb_deriv=2, m=1, N=60)
        N = 60
        s = iSLS(x_dim=plant.x_dim, u_dim=plant.u_dim, N=N)
        s.forward_model = plant.step
        s.cost_function = cost
        x0 = jnp.zeros(plant.x_dim)
        get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
        s.nominal_values = s.get_trajectory_batch(x0, jnp.zeros((N, 1)))
        out = s.solve_boxddp(plant.get_AB, -5.0, 5.0, get_Cs=get_Cs)
        assert float(jnp.max(jnp.abs(out.u_nom))) <= 5.0 + 1e-12
        assert s.cost_log and s.cost_log[-1] == float(out.cost)

        # riccati='parallel' through the facade reaches the same optimum
        sp = iSLS(x_dim=plant.x_dim, u_dim=plant.u_dim, N=N)
        sp.forward_model = plant.step
        sp.cost_function = cost
        sp.nominal_values = sp.get_trajectory_batch(x0, jnp.zeros((N, 1)))
        out_p = sp.solve_boxddp(plant.get_AB, -5.0, 5.0, get_Cs=get_Cs,
                                riccati="parallel")
        np.testing.assert_allclose(float(out_p.cost), float(out.cost), rtol=1e-6)

        s2 = iSLS(x_dim=plant.x_dim, u_dim=plant.u_dim, N=N)
        s2.forward_model = plant.step
        s2.cost_function = cost
        s2.nominal_values = s2.get_trajectory_batch(x0, jnp.zeros((N, 1)))
        barrier = make_barrier(ineq=lambda x, u: jnp.concatenate([u + 5.0, 5.0 - u]))
        out2 = s2.solve_barrier(plant.get_AB, barrier, get_Cs=get_Cs,
                                n_barrier=6, mu_factor=8.0)
        assert float(jnp.max(jnp.abs(out2.u_nom))) <= 5.0
        # facade paths agree with each other
        assert abs(float(out2.cost) - float(out.cost)) < 1e-2 * max(1.0, float(out.cost))


class TestBoxQPEnum:
    def test_enum_matches_projected_newton_and_oracle(self, rng):
        """boxqp_enum (exact 3^m KKT enumeration) vs projected Newton vs
        scipy L-BFGS-B on random strictly convex problems, m in {1,2,3}."""
        from scipy.optimize import minimize

        from ilqr_admm_tpu.ops.boxqp import boxqp, boxqp_enum

        # jit once per m — eager per-trial dispatch made this the slowest
        # test in the fast suite (30 s -> ~3 s)
        enum_j = jax.jit(boxqp_enum)
        newton_j = jax.jit(boxqp)

        for m in (1, 2, 3):
            for trial in range(25):
                Q = rng.normal(size=(m, m))
                H = Q @ Q.T + np.eye(m) * 0.1
                g = rng.normal(size=m) * 2.0
                lb = -np.abs(rng.normal(size=m)) - 0.05
                ub = np.abs(rng.normal(size=m)) + 0.05

                u_e, free_e = enum_j(
                    jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub)
                )
                u_n, _ = newton_j(
                    jnp.asarray(H), jnp.asarray(g), jnp.asarray(lb), jnp.asarray(ub)
                )
                obj = lambda u: 0.5 * u @ H @ u + g @ u
                res = minimize(
                    obj, np.clip(np.zeros(m), lb, ub), jac=lambda u: H @ u + g,
                    method="L-BFGS-B", bounds=list(zip(lb, ub)),
                    options={"ftol": 1e-15, "gtol": 1e-12},
                )
                u_e = np.asarray(u_e)
                # feasible
                assert (u_e >= lb - 1e-9).all() and (u_e <= ub + 1e-9).all()
                # exact optimum: matches (or beats) both references
                assert obj(u_e) <= res.fun + 1e-8, (m, trial, obj(u_e), res.fun)
                assert obj(u_e) <= obj(np.asarray(u_n)) + 1e-8
                assert np.allclose(u_e, res.x, atol=1e-6), (m, trial, u_e, res.x)
                # free mask consistent with the solution's active set
                at_bound = (u_e <= lb + 1e-7) | (u_e >= ub - 1e-7)
                assert not np.any(np.asarray(free_e) & at_bound & (np.abs(H @ u_e + g) > 1e-6))

    def test_enum_f32_ill_scaled(self, rng):
        """boxqp_enum in f32 at realistic (ill-scaled) Quu magnitudes.

        An absolute eps=1e-7 KKT tolerance in f32 can reject
        every combo on large-magnitude Quu/gradients (arm-benchmark
        scales, x_std up to 1e6 weights), silently falling back to the
        all-free combo. The tolerance is now scale-relative; this pins
        that the f32 result stays feasible and within f32-roundoff
        objective distance of the f64 oracle across 4 decades of scale.
        """
        from ilqr_admm_tpu.ops.boxqp import boxqp_enum

        enum_j = jax.jit(boxqp_enum)  # once per (m, dtype); eager was 19 s

        for scale in (1.0, 1e2, 1e4, 1e6):
            for m in (1, 2, 3):
                for trial in range(10):
                    Q = rng.normal(size=(m, m))
                    H64 = (Q @ Q.T + np.eye(m) * 0.1) * scale
                    g64 = rng.normal(size=m) * 2.0 * scale
                    lb = -np.abs(rng.normal(size=m)) - 0.05
                    ub = np.abs(rng.normal(size=m)) + 0.05

                    u32, free32 = enum_j(
                        jnp.asarray(H64, jnp.float32), jnp.asarray(g64, jnp.float32),
                        jnp.asarray(lb, jnp.float32), jnp.asarray(ub, jnp.float32),
                    )
                    u64, _ = enum_j(
                        jnp.asarray(H64), jnp.asarray(g64),
                        jnp.asarray(lb), jnp.asarray(ub),
                    )
                    u32 = np.asarray(u32, np.float64)
                    obj = lambda u: 0.5 * u @ H64 @ u + g64 @ u
                    # feasible (clipped by construction)
                    assert (u32 >= lb - 1e-6).all() and (u32 <= ub + 1e-6).all()
                    # objective within f32-roundoff of the f64 optimum
                    ref = obj(np.asarray(u64))
                    tol = 1e-4 * (abs(ref) + scale)
                    assert obj(u32) <= ref + tol, (scale, m, trial, obj(u32), ref)

    def test_backward_box_parallel_inactive_matches_unconstrained(self, rng):
        """With bounds far away (nothing clamps), the active-set-frozen
        parallel pass must equal the plain parallel iLQR backward."""
        from ilqr_admm_tpu.ops.constrained_riccati import (
            ilqr_backward_box_parallel,
        )
        from ilqr_admm_tpu.ops.parallel_riccati import ilqr_backward_parallel

        N, d, m = 16, 3, 2
        A = jnp.asarray(np.eye(d) + rng.normal(size=(N, d, d)) * 0.03)
        B = jnp.asarray(rng.normal(size=(N, d, m)) * 0.2)
        Cts = np.zeros((N, d + m, d + m))
        for t in range(N):
            Qx = rng.normal(size=(d, d)) * 0.1
            Cts[t, :d, :d] = Qx @ Qx.T + np.eye(d) * 0.5
            Cts[t, d:, d:] = np.eye(m) * 0.2
        cts = jnp.asarray(rng.normal(size=(N, d + m)))
        u_nom = jnp.asarray(rng.normal(size=(N, m)) * 0.1)
        K_b, k_b = ilqr_backward_box_parallel(
            A, B, jnp.asarray(Cts), cts, u_nom, -1e3, 1e3
        )
        K_u, k_u = ilqr_backward_parallel(A, B, jnp.asarray(Cts), cts)
        np.testing.assert_allclose(np.asarray(K_b), np.asarray(K_u), atol=1e-8)
        np.testing.assert_allclose(np.asarray(k_b), np.asarray(k_u), atol=1e-8)

    def test_boxddp_parallel_riccati_matches_sequential(self, rng):
        """boxDDP with the time-parallel active-set backward on the
        control-limited car converges to the SAME optimum as the exact
        sequential pass (r4: warm-started offset-freezing active-set
        exchange replaced the r3 approximation that plateaued ~1.4x
        above), and the accepted solution satisfies the sequential
        backward's KKT conditions to 1e-6 (`box_kkt_residual`)."""
        from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
        from ilqr_admm_tpu.ops.constrained_riccati import box_kkt_residual
        from ilqr_admm_tpu.problem import ILQRConfig
        from ilqr_admm_tpu.solvers.boxddp import boxddp_init, boxddp_solve

        N = 100
        car = CarFrontWheel(dt=15.0 / N)
        cost = CarParkingCost()
        u0 = jnp.asarray(rng.normal(size=(N, 2)) * 0.1)
        x0 = jnp.asarray([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
        lo = jnp.asarray([-0.5, -2.0])
        hi = jnp.asarray([0.5, 2.0])
        st0 = boxddp_init(car.step, cost, x0, u0, lo, hi)
        cfg = ILQRConfig(max_iter=500, tol_fun=1e-12)
        st_s = boxddp_solve(car.step, car.get_AB, cost.get_Cs, cost, st0,
                            lo, hi, cfg=cfg)
        st_p = boxddp_solve(car.step, car.get_AB, cost.get_Cs, cost, st0,
                            lo, hi, cfg=cfg, riccati="parallel")
        us = np.asarray(st_p.u_nom)
        assert np.abs(us / np.asarray([0.5, 2.0])).max() <= 1.0 + 1e-9
        c_s, c_p = float(st_s.cost), float(st_p.cost)
        np.testing.assert_allclose(c_p, c_s, rtol=1e-7)
        # exactness certificate: sequential-backward KKT residual of the
        # parallel-accepted nominal
        A, B = car.get_AB(st_p.x_nom, st_p.u_nom)
        cts, Cts = cost.get_Cs(st_p.x_nom, st_p.u_nom)
        r = float(box_kkt_residual(A, B, Cts, cts, st_p.u_nom, lo, hi))
        assert r <= 1e-6, r
        # the sequential solution certifies too (sanity of the oracle)
        A, B = car.get_AB(st_s.x_nom, st_s.u_nom)
        cts, Cts = cost.get_Cs(st_s.x_nom, st_s.u_nom)
        assert float(box_kkt_residual(A, B, Cts, cts, st_s.u_nom, lo, hi)) <= 1e-6

    def test_backward_box_parallel_fixed_point_given_set(self, rng):
        """With a warm-started clamp set, the masked+drift parallel pass
        reproduces a frozen-set sequential oracle exactly (the model
        equivalence claim in `ilqr_backward_box_parallel`'s docstring),
        including nonzero offsets for strictly-inside clamped dims."""
        from ilqr_admm_tpu.ops.constrained_riccati import (
            ilqr_backward_box_parallel,
        )

        N, d, m = 12, 3, 2
        A = jnp.asarray(np.eye(d) + 0.05 * rng.normal(size=(N, d, d)))
        B = jnp.asarray(0.3 * rng.normal(size=(N, d, m)))
        M = rng.normal(size=(N, d + m, d + m))
        Cts = jnp.asarray(M @ M.transpose(0, 2, 1) + 0.5 * np.eye(d + m))
        cts = jnp.asarray(rng.normal(size=(N, d + m)))
        u_nom = jnp.asarray(0.3 * rng.normal(size=(N, m)))
        lo, hi = jnp.asarray([-0.4, -0.4]), jnp.asarray([0.4, 0.4])
        clamp_lo = jnp.asarray(rng.random((N, m)) < 0.25).at[-1].set(False)
        clamp_hi = (jnp.asarray(rng.random((N, m)) < 0.25) & ~clamp_lo).at[-1].set(False)
        dlo, dhi = lo[None] - u_nom, hi[None] - u_nom
        c = jnp.where(clamp_lo, dlo, jnp.where(clamp_hi, dhi, 0.0))
        clamp = np.asarray(clamp_lo | clamp_hi)

        K_p, k_p = ilqr_backward_box_parallel(
            A, B, Cts, cts, u_nom, lo, hi, mask_iters=1,
            clamp0=(clamp_lo, clamp_hi),
        )

        # sequential frozen-set oracle (clamped dims fixed at offset c)
        V = Cts[-1][:d, :d]
        v = cts[-1][:d]
        Ks, ks = [], []
        I_m = jnp.eye(m)
        for t in range(N - 2, -1, -1):
            At, Bt, Ct, ct = A[t], B[t], Cts[t], cts[t]
            Cuu, Cux = Ct[d:, d:], Ct[d:, :d]
            qx = ct[:d] + At.T @ v
            qu = ct[d:] + Bt.T @ v
            Qxx = Ct[:d, :d] + At.T @ V @ At
            Qux = Cux + Bt.T @ V @ At
            Quu = Cuu + Bt.T @ V @ Bt
            F = (~clamp[t]).astype(A.dtype)
            Quu_ff = Quu * F[:, None] * F[None, :] + I_m * (1 - F)
            kt = -jnp.linalg.solve(Quu_ff, (qu + Quu @ c[t]) * F) * F + c[t]
            Kt = -jnp.linalg.solve(Quu_ff, Qux * F[:, None]) * F[:, None]
            V = Qxx + Qux.T @ Kt + Kt.T @ Qux + Kt.T @ Quu @ Kt
            V = 0.5 * (V + V.T)
            v = qx + Qux.T @ kt + Kt.T @ (qu + Quu @ kt)
            Ks.append(Kt)
            ks.append(kt)
        K_o = jnp.stack(Ks[::-1] + [jnp.zeros((m, d))])
        k_o = jnp.stack(ks[::-1] + [jnp.zeros(m)])
        np.testing.assert_allclose(np.asarray(K_p), np.asarray(K_o), atol=1e-10)
        np.testing.assert_allclose(np.asarray(k_p), np.asarray(k_o), atol=1e-10)

    def test_backward_box_enum_matches_newton(self, rng):
        """ilqr_backward_box gains agree between qp_method='enum' and
        'newton' on a random LQ problem with active bounds."""
        from ilqr_admm_tpu.ops.constrained_riccati import ilqr_backward_box

        N, d, m = 12, 3, 2
        A = jnp.asarray(np.eye(d) + rng.normal(size=(N, d, d)) * 0.03)
        B = jnp.asarray(rng.normal(size=(N, d, m)) * 0.2)
        Cts = np.zeros((N, d + m, d + m))
        for t in range(N):
            Qx = rng.normal(size=(d, d)) * 0.1
            Cts[t, :d, :d] = Qx @ Qx.T + np.eye(d) * 0.5
            Cts[t, d:, d:] = np.eye(m) * 0.2
        cts = rng.normal(size=(N, d + m))
        u_nom = jnp.asarray(rng.normal(size=(N, m)) * 0.5)
        args = (A, B, jnp.asarray(Cts), jnp.asarray(cts), u_nom, -0.4, 0.4)
        K_e, k_e = ilqr_backward_box(*args, qp_method="enum")
        K_n, k_n = ilqr_backward_box(*args, qp_method="newton", qp_iters=40)
        assert np.allclose(np.asarray(k_e), np.asarray(k_n), atol=1e-5), (
            np.abs(np.asarray(k_e) - np.asarray(k_n)).max()
        )
        assert np.allclose(np.asarray(K_e), np.asarray(K_n), atol=1e-4)


def test_backward_box_parallel_cold_start_reaches_sequential(rng):
    """Cold-started multi-exchange converges EXACTLY to the sequential
    box-QP backward on convex LQ problems — including heavily saturated
    (87% clamped) and cross-term (Cux != 0) cases — and the
    best-violation pass selection returns that fixed point unchanged
    (the selection must be bit-identical to free-running iteration on
    convergent exchanges; an early reject-on-increase variant froze
    25/30 of these seeds short of the fixed point)."""
    from ilqr_admm_tpu.ops.constrained_riccati import (
        ilqr_backward_box,
        ilqr_backward_box_parallel,
    )

    def make(seed, N=24, d=3, m=2):
        r = np.random.default_rng(seed)
        A = jnp.asarray(np.eye(d) + r.normal(size=(N, d, d)) * 0.08)
        B = jnp.asarray(r.normal(size=(N, d, m)) * 0.6)
        Cts = np.zeros((N, d + m, d + m))
        for t in range(N):
            Qx = r.normal(size=(d, d)) * 0.2
            Cts[t, :d, :d] = Qx @ Qx.T + np.eye(d) * 0.3
            Cts[t, d:, d:] = np.eye(m) * 0.05
            Cux = r.normal(size=(m, d)) * 0.05
            Cts[t, d:, :d] = Cux
            Cts[t, :d, d:] = Cux.T
        cts = jnp.asarray(r.normal(size=(N, d + m)) * 2.0)
        u_nom = jnp.asarray(r.normal(size=(N, m)) * 0.1)
        return A, B, jnp.asarray(Cts), cts, u_nom

    for seed in (0, 8, 17, 26):  # the worst offenders of the frozen variant
        A, B, Cts, cts, u_nom = make(seed)
        K_s, k_s = ilqr_backward_box(
            A, B, Cts, cts, u_nom, -0.25, 0.25, qp_iters=40, qp_method="enum"
        )
        K_p, k_p = ilqr_backward_box_parallel(
            A, B, Cts, cts, u_nom, -0.25, 0.25, mask_iters=20
        )
        np.testing.assert_allclose(np.asarray(K_p), np.asarray(K_s), atol=1e-8)
        np.testing.assert_allclose(np.asarray(k_p), np.asarray(k_s), atol=1e-8)


def test_backward_box_parallel_overactuated(rng):
    """m > 4 must not crash the parallel backward (r4 review finding:
    the adjugate fast path checked only the state dim; inv_small on the
    (m, m) gain blocks raised at trace time for m >= 5)."""
    from ilqr_admm_tpu.ops.constrained_riccati import (
        ilqr_backward_box,
        ilqr_backward_box_parallel,
    )

    N, d, m = 10, 3, 5
    A = jnp.asarray(np.eye(d) + 0.05 * rng.normal(size=(N, d, d)))
    B = jnp.asarray(0.3 * rng.normal(size=(N, d, m)))
    M = rng.normal(size=(N, d + m, d + m))
    Cts = jnp.asarray(M @ M.transpose(0, 2, 1) + 0.5 * np.eye(d + m))
    cts = jnp.asarray(rng.normal(size=(N, d + m)))
    u_nom = jnp.asarray(0.2 * rng.normal(size=(N, m)))
    K_p, k_p = ilqr_backward_box_parallel(
        A, B, Cts, cts, u_nom, -0.3, 0.3, mask_iters=6
    )
    assert np.isfinite(np.asarray(K_p)).all()
    # loose-bounds sanity: matches the exact sequential pass when no
    # bound binds
    K_s, k_s = ilqr_backward_box(A, B, Cts, cts, u_nom, -1e3, 1e3,
                                 qp_method="newton")
    K_w, k_w = ilqr_backward_box_parallel(A, B, Cts, cts, u_nom, -1e3, 1e3)
    np.testing.assert_allclose(np.asarray(K_w), np.asarray(K_s), atol=1e-7)
    np.testing.assert_allclose(np.asarray(k_w), np.asarray(k_s), atol=1e-7)
