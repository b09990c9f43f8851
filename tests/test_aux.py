"""Aux subsystems: TrajOpt spline basis, URDF loader, checkpoint, metrics."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.arm import PlanarArm, load_planar_arm_urdf
from ilqr_admm_tpu.utils.checkpoint import restore_state, save_state
from ilqr_admm_tpu.utils.metrics import PhaseTimer, admm_info_dict
from ilqr_admm_tpu.utils.trajopt import TrajOpt

ASSET = os.path.join(
    os.path.dirname(__file__), "..", "ilqr_admm_tpu", "assets", "planar_3dof.urdf"
)


def test_trajopt_interpolates_nodes():
    ndof = 2
    topt = TrajOpt(ndof)
    h = [0.5, 0.3, 0.7]
    topt.setup_task(h)
    rng = np.random.default_rng(0)
    y_nodes = rng.normal(size=(4, ndof))
    dy0 = np.array([0.2, -0.1])
    dyT = np.array([-0.3, 0.4])

    # node interpolation
    ts = np.concatenate([[0.0], np.cumsum(h)])
    for i, t in enumerate(ts):
        y = topt.get_y(t, y_nodes, dy0, dyT)
        np.testing.assert_allclose(y, y_nodes[i], atol=1e-10)

    # boundary velocities are clamped
    np.testing.assert_allclose(topt.get_dy(0.0, y_nodes, dy0, dyT), dy0, atol=1e-10)
    np.testing.assert_allclose(topt.get_dy(ts[-1], y_nodes, dy0, dyT), dyT, atol=1e-10)

    # C1 continuity at an interior node
    eps = 1e-6
    d_before = topt.get_dy(ts[1] - eps, y_nodes, dy0, dyT)
    d_after = topt.get_dy(ts[1] + eps, y_nodes, dy0, dyT)
    np.testing.assert_allclose(d_before, d_after, atol=1e-4)

    # basis consistency: get_y == Phi @ w
    w = np.concatenate([y_nodes.reshape(-1), dy0, dyT])
    t_probe = 0.63
    np.testing.assert_allclose(
        topt.get_Phi(t_probe) @ w, topt.get_y(t_probe, y_nodes, dy0, dyT), atol=1e-12
    )
    np.testing.assert_allclose(
        topt.get_ddPhi(t_probe) @ w, topt.get_ddy(t_probe, y_nodes, dy0, dyT),
        atol=1e-9,
    )


def test_trajopt_matches_reference_basis_golden():
    """Pin the repo basis to the reference M/P/L construction.

    Golden `Phi/dPhi/ddPhi` matrices were produced by executing the
    reference `TrajOpt` (`/root/reference/isls/utils.py:188-245`) once on
    a non-uniform 3-segment task (h=[0.5,0.3,0.7], ndof=1) at six probe
    times including both endpoints and a knot — stored in
    tests/data/trajopt_golden.npz. The repo's clamped-Hermite +
    tridiagonal-continuity derivation must agree with the reference's
    minimum-acceleration M/P/L_w construction to machine precision
    (the same C2 clamped cubic spline, derived differently).
    """
    g = np.load(os.path.join(os.path.dirname(__file__), "data", "trajopt_golden.npz"))
    topt = TrajOpt(1)
    topt.setup_task(list(g["h"]))
    ts = g["ts"]
    np.testing.assert_allclose(topt.get_Phi(ts), g["Phi"], atol=1e-8)
    np.testing.assert_allclose(topt.get_dPhi(ts), g["dPhi"], atol=1e-8)
    np.testing.assert_allclose(topt.get_ddPhi(ts), g["ddPhi"], atol=1e-7)

    # the ndof>1 basis is the kron lift of the scalar basis (reference
    # utils.py:224: np.kron(base_, np.eye(ndof)))
    topt2 = TrajOpt(3)
    topt2.setup_task(list(g["h"]))
    np.testing.assert_allclose(
        topt2.get_Phi(ts), np.kron(g["Phi"], np.eye(3)), atol=1e-8
    )


def test_urdf_loader_matches_analytic():
    arm_file = load_planar_arm_urdf(ASSET, dt=0.01)
    arm_ref = PlanarArm((1.0, 1.0, 1.0), dt=0.01)
    assert arm_file.q_dim == 3
    q = jnp.asarray([0.3, -0.5, 0.9])
    np.testing.assert_allclose(
        np.asarray(arm_file.fk(q)), np.asarray(arm_ref.fk(q)), atol=1e-12
    )


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "x_nom": jnp.arange(12.0).reshape(3, 4),
        "duals": (jnp.ones(5), jnp.zeros(2)),
    }
    path = str(tmp_path / "ckpt")
    saved = save_state(path, state)
    restored = restore_state(saved, state)
    np.testing.assert_allclose(np.asarray(restored["x_nom"]), np.asarray(state["x_nom"]))
    np.testing.assert_allclose(np.asarray(restored["duals"][0]), 1.0)


def test_metrics_helpers():
    from ilqr_admm_tpu.solvers.admm import ADMMInfo

    info = ADMMInfo(
        iters=jnp.int32(3), prim_res=jnp.float64(1e-5), dual_res=jnp.float64(2e-5),
        status=jnp.int32(1), logs=jnp.zeros((10, 2)),
    )
    d = admm_info_dict(info)
    assert d["status"] == "CONVERGED" and d["iters"] == 3
    assert len(d["residual_history"]) == 3

    timer = PhaseTimer()
    with timer.phase("backward"):
        pass
    with timer.phase("backward"):
        pass
    s = timer.summary()
    assert s["backward"]["count"] == 2


def test_debug_guards():
    import jax.numpy as jnp
    from ilqr_admm_tpu.utils.debug import assert_finite, checked

    assert_finite({"a": jnp.ones(3)}, "state")
    with pytest.raises(FloatingPointError):
        assert_finite({"a": jnp.asarray([1.0, jnp.nan])}, "state")

    def bad(x):
        return jnp.log(x)  # nan for negative input

    f = checked(bad)
    np.testing.assert_allclose(np.asarray(f(jnp.asarray(2.0))), np.log(2.0))
    with pytest.raises(Exception):
        f(jnp.asarray(-1.0))


def test_distributed_helpers_single_host():
    from ilqr_admm_tpu.parallel import distributed

    assert distributed.initialize() is False  # single host: no-op
    arr = np.arange(16).reshape(16, 1)
    shard = distributed.host_shard(arr)
    assert shard.shape[0] == 16  # one process owns everything


def test_checkpoint_resume_admm(tmp_path):
    """Checkpoint ADMM duals mid-solve and resume to the same fixed point."""
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.problem import ADMMConfig
    from ilqr_admm_tpu.projections import project_bound
    from ilqr_admm_tpu.solvers.admm import admm_solve
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
    from ilqr_admm_tpu.ops.lifted import build_Su, sw_x0
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
    from jax.scipy.linalg import cho_factor, cho_solve

    N = 50
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e4])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)

    Su = build_Su(A, B)
    SuTQ = Su.T @ cost.lifted_Q()
    l_side = SuTQ @ Su + cost.lifted_R()
    Rr = block_diag_stacked(broadcast_rho(1e-2, m, N))
    cf = cho_factor(l_side + Rr)
    free = sw_x0(A, jnp.zeros(d)).reshape(-1)
    r_side = SuTQ @ (cost.lifted_xd() - free)

    def f_argmin(x, u):
        r = r_side + (Rr @ u if u is not None else 0.0)
        u_hat = cho_solve(cf, r)
        return free + Su @ u_hat, u_hat

    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    run = lambda iters, **kw: admm_solve(
        f_argmin, None, proj_u, (N * d,), (N * m,),
        ADMMConfig(max_iter=iters, tol=0.0, stall_tol=0.0), dtype=jnp.float64, **kw,
    )

    # 60 straight iterations
    out_full = run(60)
    u_full = out_full[1]

    # 30 iterations, checkpoint duals/slacks, restore, 30 more
    out_half = run(30)
    state = {"z_u": out_half[6], "lmb_u": out_half[4]}
    from ilqr_admm_tpu.utils.checkpoint import restore_state, save_state

    path = save_state(str(tmp_path / "admm_state"), state)
    restored = restore_state(path, state)
    out_resumed = run(30, z_u_init=restored["z_u"], lmb_u_init=restored["lmb_u"])

    np.testing.assert_allclose(
        np.asarray(out_resumed[1]), np.asarray(u_full), atol=1e-12
    )
