"""Receding-horizon MPC driver on the simple car."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.car import CarSimple
from ilqr_admm_tpu.ops.riccati import quad_cost_model
from ilqr_admm_tpu.solvers.mpc import make_mpc_step, mpc_init, run_mpc
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def test_mpc_tracks_target_under_disturbance():
    H = 40  # MPC horizon
    car = CarSimple(dt=0.1)
    d, m = 4, 2
    target = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    zs = jnp.stack([target, target])
    Qs = jnp.stack([jnp.diag(jnp.asarray([1.0, 1.0, 0.0, 0.1])),
                    jnp.diag(jnp.asarray([20.0, 20.0, 0.0, 1.0]))])
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def get_AB(xs, us):
        return CarSimple(dt=0.1).get_AB(xs, us)

    step = make_mpc_step(car.step, get_AB, get_Cs, quad, n_ilqr_iters=2)

    x0 = jnp.asarray([0.0, 0.0, 0.5, 0.0])
    state = mpc_init(car.step, x0, jnp.zeros((H, m)))

    rng = np.random.default_rng(0)
    n_steps = 60
    ws = jnp.asarray(rng.normal(0, 1e-3, size=(n_steps, d)))
    xs, us, _ = run_mpc(car.step, step, state, x0, n_steps, ws=ws)

    # the car reaches the target position despite process noise
    final = np.asarray(xs[-1])
    assert np.linalg.norm(final[:2] - np.array([1.0, 1.0])) < 0.2, final

    # batched MPC: vmap the step over a fleet of controllers
    x0s = jnp.asarray(rng.normal(0, 0.1, size=(4, d)))
    states = jax.vmap(lambda a: mpc_init(car.step, a, jnp.zeros((H, m))))(x0s)
    us_b, states_b = jax.vmap(step)(states, x0s)
    assert us_b.shape == (4, m)


def test_constrained_mpc_respects_control_bounds():
    """Constrained MPC: bounded-iteration iLQR-ADMM per tick with duals
    warm-started across ticks (not in the reference — its replanning is
    linear/unconstrained only, `sls.py:244-248`). Oracles: every applied
    control within bounds; target still reached; warm-started duals are
    actually carried (state changes across ticks)."""
    from ilqr_admm_tpu.projections import project_bound
    from ilqr_admm_tpu.solvers.mpc import (
        MPCConstrainedState, make_mpc_step_constrained, mpc_constrained_init,
    )

    H = 30
    car = CarSimple(dt=0.1)
    d, m = 4, 2
    target = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    zs = jnp.stack([target, target])
    Qs = jnp.stack([jnp.diag(jnp.asarray([1.0, 1.0, 0.0, 0.1])),
                    jnp.diag(jnp.asarray([20.0, 20.0, 0.0, 1.0]))])
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def get_AB(xs, us):
        return CarSimple(dt=0.1).get_AB(xs, us)

    u_max = 0.6
    proj_u = lambda u: project_bound(u, -u_max, u_max)

    step = make_mpc_step_constrained(
        car.step, get_AB, quad, get_Cs=get_Cs,
        project_u=proj_u, rho_u=1.0,
        n_outer_iters=2, n_admm_iters=5, method="dp",
    )

    x0 = jnp.asarray([0.0, 0.0, 0.5, 0.0])
    state = mpc_constrained_init(car.step, x0, jnp.zeros((H, m)))

    n_steps = 50
    x = x0
    us_applied = []
    z_u_first = None
    for t in range(n_steps):
        u, state = step(state, x)
        if t == 0:
            z_u_first = np.asarray(state.z_u).copy()
        us_applied.append(np.asarray(u))
        x = car.step(x, u)

    us_applied = np.stack(us_applied)
    # constraint oracle on every applied control
    assert np.abs(us_applied).max() <= u_max + 1e-3, np.abs(us_applied).max()
    # the unconstrained controller would exceed the bound early on —
    # check the constraint actually binds at some tick
    assert np.abs(us_applied).max() > 0.9 * u_max
    # tracking oracle
    final = np.asarray(x)
    assert np.linalg.norm(final[:2] - np.array([1.0, 1.0])) < 0.25, final
    # duals are carried across ticks (not reset to the first tick's)
    assert not np.allclose(np.asarray(state.z_u), z_u_first)


def test_boxddp_mpc_tracks_and_respects_bounds():
    """boxDDP-tick MPC: closed loop converges to target, controls exactly
    in the box at every tick, and tracks comparably to the ADMM tick."""
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.solvers.mpc import make_mpc_step_boxddp

    N, H = 50, 200
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    get_AB = lambda xs, us: (A, B)
    get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
    f = lambda x, u: plant.A @ x + plant.B @ u

    step = make_mpc_step_boxddp(
        f, get_AB, cost, get_Cs, u_lower=-3.0, u_upper=3.0, n_iters=3,
    )
    x0 = jnp.zeros(d)
    st = mpc_init(f, x0, jnp.zeros((N, m)))
    xs, us, _ = run_mpc(f, step, st, x0, H)
    us = np.asarray(us)
    assert np.abs(us).max() <= 3.0 + 1e-12  # exact feasibility every tick
    # closed loop reaches the target position
    assert abs(float(xs[-1, 0]) - 1.0) < 0.05, float(xs[-1, 0])
    # and stays there (no limit cycle)
    assert np.abs(np.asarray(xs[-20:, 0]) - 1.0).max() < 0.08
    # the bound binds early in the transient (the task needs it)
    assert np.abs(us).max() > 2.99


def test_boxddp_mpc_parallel_backward_matches_seq():
    """boxDDP-tick MPC with riccati='parallel' tracks like the
    sequential tick: exact feasibility and same closed-loop target."""
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.solvers.mpc import make_mpc_step_boxddp

    N, H = 50, 150
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    get_AB = lambda xs, us: (A, B)
    get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
    f = lambda x, u: plant.A @ x + plant.B @ u

    step = make_mpc_step_boxddp(
        f, get_AB, cost, get_Cs, u_lower=-3.0, u_upper=3.0, n_iters=3,
        riccati="parallel",
    )
    x0 = jnp.zeros(d)
    st = mpc_init(f, x0, jnp.zeros((N, m)))
    xs, us, _ = run_mpc(f, step, st, x0, H)
    us = np.asarray(us)
    assert np.abs(us).max() <= 3.0 + 1e-12
    assert abs(float(xs[-1, 0]) - 1.0) < 0.05, float(xs[-1, 0])


def test_constrained_mpc_sqp_tick_tracks_like_default():
    """line_search='outer' (SQP serving tick: rollout-free inner ADMM +
    one line search per outer step) must track the target with exactly
    feasible applied controls, like the default dp tick, at identical
    tracking error (its speed: bench_mpc.py)."""
    from ilqr_admm_tpu.projections import project_bound
    from ilqr_admm_tpu.solvers.mpc import (
        make_mpc_step_constrained, mpc_constrained_init,
    )

    H = 30
    car = CarSimple(dt=0.1)
    d, m = 4, 2
    target = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    zs = jnp.stack([target, target])
    Qs = jnp.stack([jnp.diag(jnp.asarray([1.0, 1.0, 0.0, 0.1])),
                    jnp.diag(jnp.asarray([20.0, 20.0, 0.0, 1.0]))])
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    u_max = 0.6
    step = make_mpc_step_constrained(
        car.step, car.get_AB, quad, get_Cs=get_Cs,
        project_u=lambda u: project_bound(u, -u_max, u_max), rho_u=1.0,
        n_outer_iters=2, n_admm_iters=5,
        method="batch", line_search="outer",
    )

    x0 = jnp.asarray([0.0, 0.0, 0.5, 0.0])
    state = mpc_constrained_init(car.step, x0, jnp.zeros((H, m)))
    x = x0
    us_applied = []
    for _ in range(50):
        u, state = step(state, x)
        us_applied.append(np.asarray(u))
        x = car.step(x, u)
    us_applied = np.stack(us_applied)
    assert np.abs(us_applied).max() <= u_max + 1e-3
    assert np.abs(us_applied).max() > 0.9 * u_max  # constraint binds
    final = np.asarray(x)
    assert np.linalg.norm(final[:2] - np.array([1.0, 1.0])) < 0.05, final
