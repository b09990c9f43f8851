"""Mesh-sharded instance-parallel solves on the 8-device virtual CPU mesh.

Validates the multi-device code path without accelerator hardware
(SURVEY §4): the
same batched solve run (a) unsharded and (b) shard_map'ed over ('data',)
must agree exactly, and psum MC reductions must equal host-side means.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.parallel import (
    batched_ilqr_solve,
    batched_lqt_admm_dp,
    instance_sharding,
    make_mesh,
    mc_success_rate,
    sharded_instance_solve,
)
from ilqr_admm_tpu.problem import ADMMConfig, ILQRConfig
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.ops.riccati import quad_cost_model
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


N = 50


def _problem():
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d = plant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e4])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, plant.u_dim)
    A, B = plant.AB(N)
    return plant, A, B, cost


def test_sharded_matches_unsharded():
    plant, A, B, cost = _problem()
    d = plant.x_dim
    mesh = make_mesh()
    assert mesh.devices.size == 8

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(0, 0.1, size=(24, d)))
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=50, tol=1e-4)

    def solve_batch(x0s_):
        return batched_lqt_admm_dp(A, B, cost, x0s_, project_u=proj_u, rho_u=1e-2, cfg=cfg)

    x_ref, u_ref, it_ref = solve_batch(x0s)
    x_sh, u_sh, it_sh = sharded_instance_solve(solve_batch, mesh, x0s)

    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref), atol=1e-10)
    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref), atol=1e-10)


def test_batched_ilqr_multistart_sharded():
    plant, A, B, cost = _problem()
    d, m = plant.x_dim, plant.u_dim
    mesh = make_mesh()

    def lin_f(x, u):
        return plant.A @ x + plant.B @ u

    def get_AB(xs, us):
        return A, B

    def get_Cs(xs, us):
        return quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)

    rng = np.random.default_rng(1)
    n_inst = 32
    x0s = jnp.asarray(rng.normal(0, 0.2, size=(n_inst, d)))
    u0s = jnp.zeros((n_inst, N, m))
    cfg = ILQRConfig(max_iter=10, max_line_search_iter=10)

    def solve_batch(x0s_, u0s_):
        return batched_ilqr_solve(lin_f, get_AB, get_Cs, cost, x0s_, u0s_, cfg)

    out_ref = solve_batch(x0s, u0s)
    out_sh = sharded_instance_solve(solve_batch, mesh, x0s, u0s)
    np.testing.assert_allclose(
        np.asarray(out_sh.cost), np.asarray(out_ref.cost), rtol=1e-10
    )


def test_mc_success_rate_psum():
    mesh = make_mesh()
    rng = np.random.default_rng(2)
    vals = jnp.asarray(rng.normal(size=(800, 4)))

    def success(v):
        return (jnp.abs(v).max(axis=-1) < 1.5).astype(jnp.float32)

    rate = mc_success_rate(success, mesh, vals)
    rate_host = float(np.mean(np.abs(np.asarray(vals)).max(-1) < 1.5))
    assert abs(float(rate) - rate_host) < 1e-6


def test_boxddp_fleet_sharded():
    """boxDDP fleet sharded over the 8-device mesh == unsharded."""
    from ilqr_admm_tpu.parallel.batch import batched_boxddp_solve
    from ilqr_admm_tpu.parallel.batch import sharded_instance_solve
    from ilqr_admm_tpu.parallel.mesh import make_mesh
    from ilqr_admm_tpu.ops.riccati import quad_cost_model
    from ilqr_admm_tpu.problem import ILQRConfig

    plant, A, B, cost = _problem()
    d, m = plant.x_dim, plant.u_dim
    N = cost.N
    mesh = make_mesh()
    get_AB = lambda xs, us: (A, B)
    get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
    f = lambda x, u: plant.A @ x + plant.B @ u

    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(0, 0.1, size=(16, d)))
    u0s = jnp.zeros((16, N, m))
    cfg = ILQRConfig(max_iter=15)

    def solve_batch(x0s_, u0s_):
        st = batched_boxddp_solve(
            f, get_AB, get_Cs, cost, x0s_, u0s_, -5.0, 5.0, cfg=cfg
        )
        return st.cost, st.u_nom

    c_ref, u_ref = solve_batch(x0s, u0s)
    c_sh, u_sh = sharded_instance_solve(solve_batch, mesh, x0s, u0s)
    np.testing.assert_allclose(np.asarray(c_sh), np.asarray(c_ref), atol=1e-10)
    assert float(jnp.max(jnp.abs(u_sh))) <= 5.0 + 1e-12


@pytest.mark.slow
def test_al_fleet_sharded():
    """AL-iLQR fleet sharded over the mesh == unsharded, all feasible."""
    from ilqr_admm_tpu.parallel.batch import batched_al_solve
    from ilqr_admm_tpu.parallel.batch import sharded_instance_solve
    from ilqr_admm_tpu.parallel.mesh import make_mesh
    from ilqr_admm_tpu.ops.riccati import quad_cost_model
    from ilqr_admm_tpu.problem import ILQRConfig

    plant, A, B, cost = _problem()
    d, m = plant.x_dim, plant.u_dim
    N = cost.N
    mesh = make_mesh()
    get_AB = lambda xs, us: (A, B)
    get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
    f = lambda x, u: plant.A @ x + plant.B @ u

    rng = np.random.default_rng(1)
    x0s = jnp.asarray(rng.normal(0, 0.1, size=(16, d)))
    u0s = jnp.zeros((16, N, m))

    def solve_batch(x0s_, u0s_):
        res = batched_al_solve(
            f, get_AB, get_Cs, cost, x0s_, u0s_,
            ineq=lambda x, u: jnp.concatenate([u - 5.0, -u - 5.0]),
            cfg=ILQRConfig(max_iter=30), n_al=10, tol_con=1e-8,
        )
        return res.cost, res.max_violation

    c_ref, v_ref = solve_batch(x0s, u0s)
    c_sh, v_sh = sharded_instance_solve(solve_batch, mesh, x0s, u0s)
    np.testing.assert_allclose(np.asarray(c_sh), np.asarray(c_ref), atol=1e-10)
    assert float(jnp.max(v_sh)) < 1e-6
