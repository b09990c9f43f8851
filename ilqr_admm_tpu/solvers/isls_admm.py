"""Robust iLQR (iSLS-ADMM): nonlinear chance-constrained synthesis.

Functional equivalent of `iSLS.isls_admm` (reference `isls.py:503-712`):
outer relinearization loop; decision variable per inner ADMM is the
matrix [δu_ff | Phi_u[:, :p]] (feedforward delta + response columns
w.r.t. the first p initial-state coordinates, `isls.py:532-538`); the
x-update line-searches the feedforward column only (`isls.py:594-618`);
residual norms are penalty-weighted; projections receive the nominal
trajectory so they can shift deltas into absolute coordinates
(`isls.py:641,649`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_factor, cho_solve

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho


class ISLSResult(NamedTuple):
    du: jax.Array  # (N*m,) feedforward delta (≈0 at convergence)
    phi_u: jax.Array  # (N*m, p) robust response columns
    x_nom: jax.Array
    u_nom: jax.Array
    cost: jax.Array
    outer_iters: jax.Array
    status: jax.Array
    cost_log: jax.Array


def _isls_admm_impl(
    f: Callable,
    get_AB: Callable,
    cost_fn: Callable,
    x_nom0,
    u_nom0,
    robust_dim: int,
    get_Cs: Optional[Callable] = None,
    quad_cost=None,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    k_max: int = 20,
    max_admm_iter: int = 20,
    alphas: Optional[jax.Array] = None,
    alpha: float = 1.0,
    tol: float = 1e-3,
    outer_tol: float = 1e-4,
    osc_tol: float = 1e-3,
    joint_alpha: Optional[float] = None,
    u_bounds=None,
    x0_var=None,
    chance_method: str = "chi",
    feasible_iterate: Optional[bool] = None,
    anderson_m: int = 0,
) -> ISLSResult:
    """Run robust iSLS-ADMM from a nominal trajectory guess.

    project_x / project_u signatures: proj(z_plus_lambda, nominal) where
    z_plus_lambda is ((N*dim), p+1) and nominal is the current (N, dim)
    nominal trajectory (column 0 is the feedforward delta, columns 1..p
    the response map).

    joint_alpha: turnkey *joint* chance-constraint calibration — with
    ``u_bounds=(lower, upper)`` and ``x0_var`` the library derives the
    SOC tightening psi = chi_p^{-1}(joint_alpha) (default method='chi',
    the shared-uncertainty ball certificate — sound for any row count;
    see `ilqr_admm_tpu.chance`) and builds the shifted SOC `project_u`
    internally. The reference exposes only per-row levels (3DoF robust
    c24-26); this is the calibrated one-call path to its joint regime.
    """
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    p = robust_dim
    dtype = x_nom0.dtype

    if joint_alpha is not None:
        if project_u is not None:
            raise ValueError("pass either joint_alpha or project_u, not both")
        if u_bounds is None or x0_var is None:
            raise ValueError("joint_alpha requires u_bounds=(lo, hi) and x0_var")
        from ilqr_admm_tpu.chance import make_box_chance_projection

        project_u, _cal = make_box_chance_projection(
            x0_var, p, u_bounds[0], u_bounds[1],
            joint_alpha=joint_alpha, n_rows=N * m, method=chance_method,
            shifted=True,
        )
    # Mirror sls_admm's default: z-side controller only when no x-block
    # exists — with a state projection, the u-side z-iterate alone is not
    # dynamics-consistent with the x-side constraints.
    if feasible_iterate is None:
        feasible_iterate = joint_alpha is not None and project_x is None
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if alphas is None:
        alphas = 10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=dtype)[:20]

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)
    Qr_l = block_diag_stacked(Qr) if (Qr is not None and project_x is not None) else None
    Rr_l = block_diag_stacked(Rr) if (Rr is not None and project_u is not None) else None

    admm_cfg = ADMMConfig(max_iter=max_admm_iter, alpha=alpha, tol=tol, stall_tol=1e-3,
                          anderson_m=anderson_m)

    def outer_body(carry):
        x_nom, u_nom, cost, it, status, z_x, z_u, _U_last, cost_log = carry
        A, B = get_AB(x_nom, u_nom)
        Su = build_Su(A, B)
        Sx = build_Sx(A, p).reshape(N * d, p)
        x_nom_f = x_nom.reshape(-1)
        u_nom_f = u_nom.reshape(-1)

        if get_Cs is not None:
            cts, Cts = get_Cs(x_nom, u_nom)
            Cxx = block_diag_stacked(Cts[:, :d, :d])
            Cuu = block_diag_stacked(Cts[:, d:, d:])
            cx = cts[:, :d].reshape(-1)
            cu = cts[:, d:].reshape(-1)
            SuTQ = Su.T @ (0.5 * Cxx)
            l_side = SuTQ @ Su + 0.5 * Cuu
            r_side_ff = Su.T @ (-0.5 * cx) - 0.5 * cu
        else:
            Qlift = block_diag_stacked(quad_cost.Q)
            Rlift = block_diag_stacked(quad_cost.R)
            SuTQ = Su.T @ Qlift
            l_side = SuTQ @ Su + Rlift
            r_side_ff = SuTQ @ (quad_cost.lifted_xd() - x_nom_f) + Rlift @ (-u_nom_f)
        r_side_fb = -SuTQ @ Sx

        SuTQr = None
        if Qr_l is not None:
            SuTQr = Su.T @ Qr_l
            l_side = l_side + SuTQr @ Su
            r_side_fb = r_side_fb - SuTQr @ Sx
        if Rr_l is not None:
            l_side = l_side + Rr_l
        cf = cho_factor(l_side)
        r_side = jnp.concatenate([r_side_ff[:, None], r_side_fb], axis=-1)

        def f_argmin(x, u):
            add_r = jnp.zeros_like(r_side)
            if SuTQr is not None and x is not None:
                add_r = add_r + SuTQr @ x
            if Rr_l is not None and u is not None:
                add_r = add_r + Rr_l @ u
            dU = cho_solve(cf, r_side + add_r)  # (N*m, p+1)
            dX = Su @ dU
            dX = dX.at[:, 1:].add(Sx)

            # line search on the feedforward column only (`isls.py:594-618`)
            delta_u = dU[:, 0].reshape(N, m)

            def rollout_alpha(a):
                us = u_nom + a * delta_u
                xs = rollout_nonlinear(f, x_nom[0], us)
                return xs, us

            xs_c, us_c = jax.vmap(rollout_alpha)(alphas)
            costs = jax.vmap(cost_fn)(xs_c, us_c)
            costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
            ind = jnp.argmin(costs)

            dU_opt = dU.at[:, 0].set((us_c[ind] - u_nom).reshape(-1))
            dX_opt = dX.at[:, 0].set((xs_c[ind] - x_nom).reshape(-1))
            return dX_opt, dU_opt

        if project_x is None and project_u is None:
            # Unconstrained robust synthesis: the "ADMM" degenerates to one
            # x-update (reference converges immediately with both blocks
            # disabled — notebook `3DoF robot/...robust...` cell 23).
            x_x, x_u = f_argmin(None, None)
            z_x_n, z_u_n = z_x, z_u
        else:
            px = (lambda y: project_x(y, x_nom)) if project_x is not None else None
            pu = (lambda y: project_u(y, u_nom)) if project_u is not None else None
            weight_x = (lambda r: Qr_l @ r) if Qr_l is not None else None
            weight_u = (lambda r: Rr_l @ r) if Rr_l is not None else None

            x_x, x_u, _, _, _, z_x_n, z_u_n, _info = admm_solve(
                f_argmin, px, pu, (N * d, p + 1), (N * m, p + 1), admm_cfg,
                z_x_init=z_x, z_u_init=z_u,
                weight_x=weight_x, weight_u=weight_u, dtype=dtype,
            )

        u_new = u_nom + x_u[:, 0].reshape(N, m)
        x_new = x_nom + x_x[:, 0].reshape(N, d)
        cost_new = cost_fn(x_new, u_new)
        cost_log = cost_log.at[it].set(cost_new)

        converged = jnp.abs(cost_new - cost) < outer_tol
        recent = lax.dynamic_slice(
            jnp.concatenate([jnp.full((8,), jnp.inf, dtype), cost_log]), (it + 1,), (8,)
        )
        osc = jnp.abs(jnp.mean(recent[4:]) - jnp.mean(recent[:4])) < osc_tol
        status_new = jnp.where(
            converged,
            SolveStatus.CONVERGED,
            jnp.where(osc, SolveStatus.OSCILLATING, SolveStatus.RUNNING),
        ).astype(jnp.int32)
        return (x_new, u_new, cost_new, it + 1, status_new, z_x_n, z_u_n, x_u, cost_log)

    def outer_cond(carry):
        _, _, _, it, status, *_ = carry
        return jnp.logical_and(it < k_max, status == SolveStatus.RUNNING)

    cost0 = cost_fn(x_nom0, u_nom0)
    carry0 = (
        x_nom0, u_nom0, cost0, jnp.int32(0), jnp.int32(SolveStatus.RUNNING),
        jnp.zeros((N * d, p + 1), dtype), jnp.zeros((N * m, p + 1), dtype),
        jnp.zeros((N * m, p + 1), dtype),
        jnp.full((k_max,), jnp.inf, dtype),
    )
    carry = lax.while_loop(outer_cond, outer_body, carry0)
    x_nom, u_nom, cost, it, status, z_x, z_u, U_last, cost_log = carry
    status = jnp.where(status == SolveStatus.RUNNING, SolveStatus.MAX_ITER, status).astype(jnp.int32)

    # Final decision matrix [du | phi_u] from the last x-update (reference
    # `isls.py:710-712`) — or the projected z-iterate when feasibility of
    # the returned controller is required (chance calibration: the
    # z-side lies in the SOC sets by construction; see sls_admm). The
    # z-side feedforward is a delta against the PRE-update nominal, while
    # the returned u_nom includes the final x-step x_u[:,0]; subtracting
    # it keeps the absolute feedforward u_nom + du at the projected
    # (feasible) value.
    if feasible_iterate and project_u is not None:
        du = z_u[:, 0] - U_last[:, 0]
        phi_u = z_u[:, 1:]
    else:
        du = U_last[:, 0]
        phi_u = U_last[:, 1:]
    return ISLSResult(
        du=du, phi_u=phi_u, x_nom=x_nom, u_nom=u_nom, cost=cost,
        outer_iters=it, status=status, cost_log=cost_log,
    )


def isls_admm(*args, **kwargs) -> ISLSResult:
    """See `_isls_admm_impl`. Traced under HIGHEST matmul precision (a
    reduced-precision default f32 matmul, e.g. TF32 on the GPU, breaks
    the ill-conditioned lifted solves)."""
    with jax.default_matmul_precision("highest"):
        return _isls_admm_impl(*args, **kwargs)


isls_admm.__wrapped__ = _isls_admm_impl
