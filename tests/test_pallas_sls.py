"""Fused Pallas robust SLS-ADMM kernel vs the XLA GEMM path.

Same math, same iteration counts: solutions must agree closely, and
chance-constraint margins must hold (SURVEY §3.3 SOC construction).
Interpret mode on CPU at "ieee" products; the GPU run is benchmarked in
benchmarks/bench_pallas_sls.py and chip_smoke.py (P2).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.stats import norm

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.pallas_admm import NUM_WARPS
from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm
from ilqr_admm_tpu.projections import project_set_convex, project_soc_unit
from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

# the Pallas interpreter at IEEE f32 products (XLA:CPU has no TF32)
CPU = dict(interpret=True, precision="ieee")


def _setup(N=20):
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    f32 = jnp.float32
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(f32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(f32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    return A.astype(f32), B.astype(f32), cost, d, m


@pytest.mark.slow
def test_pallas_sls_matches_xla_path():
    N = 20
    A, B, cost, d, m = _setup(N)
    f32 = jnp.float32

    psi_inv = float(norm.ppf(0.95))
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = np.concatenate([Au, (-mu / psi_inv)[None]], 0)
    A_lo = np.concatenate([Au, (mu / psi_inv)[None]], 0)
    b_fixed = np.zeros(3)
    b_bound = np.array([0.0, 0.0, 1.0 / psi_inv])

    n_iters, n_cons, cons_rho, rho_u = 40, 20, 10.0, 1e2

    # XLA reference path with identical fixed iteration counts
    A_hi_j, A_lo_j = jnp.asarray(A_hi, f32), jnp.asarray(A_lo, f32)

    def soc_proj(y, bound):
        b = jnp.asarray(b_fixed, f32) + bound * jnp.asarray(b_bound, f32)
        return project_set_convex(
            y, [A_hi_j, A_lo_j], [b, b], [project_soc_unit] * 2,
            rho=cons_rho, max_iter=n_cons, threshold=0.0, stall_tol=0.0,
        )

    solve_xla = make_batched_sls_admm(
        A, B, cost, project_u=lambda y, p: jax.vmap(soc_proj)(y, p),
        rho_u=rho_u, robust_dim=1, n_iters=n_iters,
    )
    solve_pl = make_pallas_sls_admm(
        A, B, cost, [A_hi, A_lo], [b_fixed, b_fixed], [b_bound, b_bound],
        rho_u=rho_u, robust_dim=1, n_iters=n_iters, n_cons_iters=n_cons,
        cons_rho=cons_rho, batch_tile=16, **CPU,
    )

    bounds = jnp.asarray(np.random.default_rng(0).uniform(4.0, 8.0, 8), f32)
    du_x, phi_x, U_x = solve_xla(bounds)
    du_p, phi_p, U_p = solve_pl(bounds)

    scale = float(jnp.max(jnp.abs(du_x))) + 1e-12
    err_du = float(jnp.max(jnp.abs(du_x - du_p))) / scale
    assert err_du < 2e-2, err_du
    err_U = float(jnp.max(jnp.abs(U_x - U_p))) / (float(jnp.max(jnp.abs(U_x))) + 1e-12)
    assert err_U < 2e-2, err_U

    # chance-constraint margin oracle on the Pallas solution
    margin = jnp.abs(du_p) + psi_inv * np.sqrt(0.01) * jnp.abs(U_p[:, :, 1])
    viol = jnp.maximum(margin - bounds[:, None], 0.0)
    assert float(jnp.max(viol)) < 0.05 * float(jnp.max(bounds)), float(jnp.max(viol))


@pytest.mark.parametrize("n_cons", [1, 10])
def test_pallas_sls_consensus_matches_xla_iterate_for_iterate(n_cons):
    """The consensus z-update runs `n_cons_iters` iterations of
    `project_set_convex` and returns the last iteration's x-update, as
    the XLA reference does: the inner loop is not converged at these
    counts, so returning one more x-update would be a different
    projection (a 3e-2 difference at n_cons = 30, N = 20)."""
    N = 20
    A, B, cost, d, m = _setup(N)
    f32 = jnp.float32
    psi_inv = float(norm.ppf(0.95))
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = np.concatenate([Au, (-mu / psi_inv)[None]], 0)
    A_lo = np.concatenate([Au, (mu / psi_inv)[None]], 0)
    b_fixed = np.zeros(3)
    b_bound = np.array([0.0, 0.0, 1.0 / psi_inv])
    n_iters, cons_rho = 30, 10.0
    A_hi_j, A_lo_j = jnp.asarray(A_hi, f32), jnp.asarray(A_lo, f32)

    def soc_proj(y, bound):
        b = jnp.asarray(b_fixed, f32) + bound * jnp.asarray(b_bound, f32)
        return project_set_convex(
            y, [A_hi_j, A_lo_j], [b, b], [project_soc_unit] * 2,
            rho=cons_rho, max_iter=n_cons, threshold=0.0, stall_tol=0.0,
        )

    solve_xla = make_batched_sls_admm(
        A, B, cost, project_u=lambda y, p: jax.vmap(soc_proj)(y, p),
        rho_u=1.0, robust_dim=1, n_iters=n_iters,
    )
    solve_pl = make_pallas_sls_admm(
        A, B, cost, [A_hi, A_lo], [b_fixed, b_fixed], [b_bound, b_bound],
        rho_u=1.0, robust_dim=1, n_iters=n_iters, n_cons_iters=n_cons,
        cons_rho=cons_rho, batch_tile=16, **CPU,
    )
    bounds = jnp.asarray(np.random.default_rng(0).uniform(2.0, 4.0, 8), f32)
    U_x = solve_xla(bounds)[2]
    U_p = solve_pl(bounds)[2]
    assert float(jnp.max(jnp.abs(U_p - U_x))) < 1e-3


def test_pallas_sls_rejects_ragged_soc_rows():
    """Constraint sets with differing row counts would have extra rows
    silently dropped by the unrolled kernel (review finding)."""
    import pytest

    A, B, cost, d, m = _setup(16)
    A3 = np.zeros((3, 2))
    A5 = np.zeros((5, 2))
    with pytest.raises(ValueError, match="same number of rows"):
        make_pallas_sls_admm(
            A, B, cost, [A3, A5], [np.zeros(3), np.zeros(5)],
            [np.zeros(3), np.zeros(5)], rho_u=1e2, **CPU,
        )


def test_pallas_sls_early_exit_matches_full_schedule():
    """stop_tol > 0 on an easy fleet: exited tiles' iterates match the
    fixed-schedule run (interpret mode; same design as pallas_admm)."""
    N = 20
    A, B, cost, d, m = _setup(N)
    f32 = jnp.float32
    psi_inv = float(norm.ppf(0.95))
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = np.concatenate([Au, (-mu / psi_inv)[None]], 0)
    A_lo = np.concatenate([Au, (mu / psi_inv)[None]], 0)
    b_fixed = np.zeros(3)
    b_bound = np.array([0.0, 0.0, 1.0 / psi_inv])

    # n_iters = 15 chunks x 8 + the final iteration: a tile that never
    # exits runs exactly the fixed schedule
    kw = dict(rho_u=1e2, robust_dim=1, n_iters=121, n_cons_iters=20,
              cons_rho=10.0, batch_tile=16, **CPU)
    solve_full = make_pallas_sls_admm(
        A, B, cost, [A_hi, A_lo], [b_fixed, b_fixed], [b_bound, b_bound], **kw)
    solve_exit = make_pallas_sls_admm(
        A, B, cost, [A_hi, A_lo], [b_fixed, b_fixed], [b_bound, b_bound],
        stop_tol=1e-5, check_every=8, **kw)

    bounds = jnp.asarray(np.random.default_rng(1).uniform(4.0, 8.0, 8), f32)
    du_f, phi_f, U_f = solve_full(bounds)
    du_e, phi_e, U_e = solve_exit(bounds)
    scale = float(jnp.max(jnp.abs(du_f))) + 1e-12
    assert float(jnp.max(jnp.abs(du_f - du_e))) / scale < 1e-3
    assert float(jnp.max(jnp.abs(U_f - U_e))) / (float(jnp.max(jnp.abs(U_f))) + 1e-12) < 1e-3


@pytest.mark.slow
def test_pallas_sls_diamond_reaches_qp_optimum():
    """z_update='diamond' (exact closed-form row projection): the kernel
    must converge to the f64 QP optimum (scipy trust-constr oracle,
    benchmarks/_oracles.py) and its projected iterate is exactly
    feasible — stronger than the consensus mode, whose inner loop is
    only approximately feasible.."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks._oracles import _project_diamond, sls_qp
    from scipy.stats import norm

    N = 20
    A, B, cost, d, m = _setup(N)
    psi_inv = float(norm.ppf(0.95))
    c_coef = psi_inv * 0.1

    solve = make_pallas_sls_admm(
        A, B, cost, (), (), (),
        rho_u=1.0, robust_dim=1, n_iters=400, batch_tile=16,
        z_update="diamond", diamond_w=(1.0, c_coef), **CPU,
    )
    rng = np.random.default_rng(0)
    bounds = jnp.asarray(rng.uniform(2.0, 4.0, 8), jnp.float32)
    du, phi, U = solve(bounds)
    U_np = np.asarray(U, np.float64)

    # iterate sits essentially on the feasible set
    prim = np.array([
        np.linalg.norm(U_np[i] - _project_diamond(U_np[i], c_coef,
                                                  float(bounds[i])))
        for i in range(8)
    ])
    assert prim.max() < 1e-3, prim

    out = sls_qp({
        "A": np.asarray(A, np.float64), "B": np.asarray(B, np.float64),
        "Q": np.asarray(cost.Q, np.float64),
        "R": np.asarray(cost.R, np.float64),
        "xd": np.asarray(cost.lifted_xd(), np.float64),
        "bounds": np.asarray(bounds, np.float64), "U": U_np, "c": c_coef,
    })
    gaps = (out["j_z"] - out["j_star"]) / np.abs(out["j_star"])
    assert gaps.max() < 1e-4, gaps


def test_pallas_sls_diamond_rejects_bad_config():
    A, B, cost, d, m = _setup(8)
    with pytest.raises(ValueError, match="diamond"):
        make_pallas_sls_admm(A, B, cost, (), (), (), rho_u=1.0,
                             robust_dim=1, n_iters=10, z_update="diamond")
    with pytest.raises(ValueError, match="z_update"):
        make_pallas_sls_admm(A, B, cost, (), (), (), rho_u=1.0,
                             robust_dim=1, n_iters=10, z_update="nope")


def test_pallas_sls_diamond_early_exit_matches_full():
    """stop_tol > 0 with z_update='diamond': per-tile early exit must
    return the same solutions as the fixed-iteration schedule (the
    serving config: exact projection + early exit)."""
    from scipy.stats import norm

    N = 20
    A, B, cost, d, m = _setup(N)
    psi_inv = float(norm.ppf(0.95))
    c_coef = psi_inv * 0.1
    kw = dict(rho_u=1.0, robust_dim=1, n_iters=300, batch_tile=16,
              z_update="diamond", diamond_w=(1.0, c_coef), **CPU)
    solve_full = make_pallas_sls_admm(A, B, cost, (), (), (), **kw)
    solve_exit = make_pallas_sls_admm(A, B, cost, (), (), (),
                                      stop_tol=1e-4, check_every=16, **kw)
    rng = np.random.default_rng(2)
    bounds = jnp.asarray(rng.uniform(2.0, 4.0, 8), jnp.float32)
    du_f, phi_f, U_f = solve_full(bounds)
    du_e, phi_e, U_e = solve_exit(bounds)
    # an exited tile stops once its residual is < stop_tol; the frozen
    # iterate can sit a few x stop_tol from the fully-iterated one
    np.testing.assert_allclose(np.asarray(du_e), np.asarray(du_f), atol=5e-4)
    np.testing.assert_allclose(np.asarray(U_e), np.asarray(U_f), atol=2e-3)


def test_diamond_rejects_nonpositive_weights():
    A, B, cost, d, m = _setup(8)
    with pytest.raises(ValueError, match="positive"):
        make_pallas_sls_admm(A, B, cost, (), (), (), rho_u=1.0,
                             robust_dim=1, n_iters=10,
                             z_update="diamond", diamond_w=(1.0, 0.0))


def _diamond_fleet(N, batch, **kw):
    A, B, cost, d, m = _setup(N)
    c_coef = float(norm.ppf(0.95)) * 0.1
    bounds = jnp.asarray(np.random.default_rng(0).uniform(2.0, 4.0, batch),
                         jnp.float32)
    solve = make_pallas_sls_admm(
        A, B, cost, (), (), (), rho_u=1.0, robust_dim=1, n_iters=100,
        z_update="diamond", diamond_w=(1.0, c_coef), **kw,
    )
    return A, B, cost, c_coef, bounds, solve


def test_pallas_sls_diamond_matches_xla_and_pads():
    """Diamond kernel vs `solvers/batched_sls.py` with the exact
    `project_weighted_l1` z-update: same zero start, same update order,
    so the iterates agree up to f32 rounding. The ragged batch (20 of a
    16-row tile) is padded and N·m = 20 pads to 32; padded columns stay
    exactly zero."""
    from ilqr_admm_tpu.projections import project_weighted_l1

    A, B, cost, c_coef, bounds, solve = _diamond_fleet(20, 20, **CPU)
    w = jnp.asarray([1.0, c_coef], jnp.float32)
    solve_x = make_batched_sls_admm(
        A, B, cost, project_u=lambda y, b: project_weighted_l1(y, w, b[:, None]),
        rho_u=1.0, robust_dim=1, n_iters=100,
    )
    du_p, phi_p, U_p = solve(bounds)
    du_x, phi_x, U_x = solve_x(bounds)
    assert U_p.shape == (20, 20, 2) and phi_p.shape == phi_x.shape
    assert float(jnp.max(jnp.abs(U_p - U_x))) < 1e-3
    assert float(jnp.max(jnp.abs(phi_p - phi_x))) < 1e-3
    U_pad = solve.padded(bounds)
    assert U_pad.shape == (2, 32, 32)
    assert float(jnp.max(jnp.abs(U_pad[:, :, 20:]))) == 0.0


def test_pallas_sls_refuses_compiled_kernel_on_cpu():
    *_, bounds, solve = _diamond_fleet(16, 16)
    with pytest.raises(Exception, match="interpret"):
        solve(bounds)


@pytest.mark.parametrize("variant", ["diamond", "diamond_early_exit", "consensus"])
def test_pallas_sls_lowers_to_triton_for_gpu(variant):
    """Cross-lower the compiled kernel for the "cuda" platform at the
    benchmark width (N·m = 100 -> 128, TF32x3 products)."""
    if variant == "consensus":
        A, B, cost, d, m = _setup(100)
        psi_inv = float(norm.ppf(0.95))
        mu = np.array([1.0, 0.0])
        Au = np.diag(np.sqrt([0.0, 0.01]))
        A_hi = np.concatenate([Au, (-mu / psi_inv)[None]], 0)
        A_lo = np.concatenate([Au, (mu / psi_inv)[None]], 0)
        b_bound = np.array([0.0, 0.0, 1.0 / psi_inv])
        solve = make_pallas_sls_admm(
            A, B, cost, [A_hi, A_lo], [np.zeros(3)] * 2, [b_bound] * 2,
            rho_u=1.0, robust_dim=1, n_iters=50, n_cons_iters=10,
        )
        bounds = jnp.ones(48, jnp.float32)
    else:
        stop = 1e-4 if variant == "diamond_early_exit" else 0.0
        *_, bounds, solve = _diamond_fleet(100, 48, stop_tol=stop)
    text = jax.jit(solve.padded).trace(bounds).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
    assert f"num_warps = {NUM_WARPS} " in text
