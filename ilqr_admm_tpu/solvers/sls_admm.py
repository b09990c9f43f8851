"""Robust SLS-ADMM: chance-constrained response-map synthesis.

Functional equivalent of `SLS.ADMM_SLS` (`sls.py:319-454`). The decision
variable is the matrix [du | Phi_u[:, :p]] — feedforward plus the
response-map columns w.r.t. the first p initial-state coordinates
(robustness w.r.t. the initial-position block; reference `sls.py:357-358`)
— so the x-update is a single multi-RHS prefactored solve (one matmul).
Residual norms are penalty-weighted (reference `sls.py:411-418`).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.problem import ADMMConfig, QuadCost
from ilqr_admm_tpu.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu.solvers.lqt import lqt_solve_sls


def _sls_admm_impl(
    A,
    B,
    cost: QuadCost,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    robust_dim: Optional[int] = None,
    cfg: ADMMConfig = ADMMConfig(max_iter=5000, stall_tol=1e-2),
    joint_alpha: Optional[float] = None,
    u_bounds=None,
    x0_var=None,
    chance_method: str = "chi",
    feasible_iterate: Optional[bool] = None,
):
    """Solve the robust SLS problem with ADMM.

    robust_dim: number of leading initial-state coordinates the synthesis
    is robust to (reference hardcodes x_dim // 2 — the position block).
    Projections receive (rows, robust_dim + 1) matrices whose rows are
    [du_i, phi_i] points.

    joint_alpha: turnkey *joint* chance-constraint calibration (see
    `ilqr_admm_tpu.chance`): with ``u_bounds=(lower, upper)`` and
    ``x0_var`` (variance of the robust initial-state block), the
    library derives the SOC tightening psi from the requested joint
    level — default method='chi', the shared-uncertainty ball
    certificate psi = chi_p^{-1}(joint_alpha) (sound for any row count;
    'sidak'/'bonferroni' correct per-row levels instead) — and builds
    the SOC `project_u` internally (mutually exclusive with passing
    project_u; the reference has no joint-level API — its 95.8 % joint
    rate is an uncalibrated per-row-0.82 artifact, 3DoF robust c26).

    feasible_iterate: return the z-side (projected) u-block instead of
    the x-update output. The x-iterate is only *asymptotically* feasible
    — at a finite iteration cap its rows can sit well inside the
    constraint-violating region even when the ADMM is near its fixed
    point — while the z-iterate lies in the constraint sets by
    construction (up to the set-intersection projection tolerance), at
    the price of the x/z consensus gap in optimality. Defaults to True
    when joint_alpha calibration is active (a calibrated confidence is
    meaningless on an infeasible iterate), False otherwise (reference
    `sls.py:450` returns the x-side).

    Returns (du (Nm,), phi_u (Nm, Nd), info). phi_u splices the optimized
    robust columns into the unconstrained response map (`sls.py:450`).
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    p = d // 2 if robust_dim is None else robust_dim

    if joint_alpha is not None:
        if project_u is not None:
            raise ValueError("pass either joint_alpha or project_u, not both")
        if u_bounds is None or x0_var is None:
            raise ValueError("joint_alpha requires u_bounds=(lo, hi) and x0_var")
        from ilqr_admm_tpu.chance import make_box_chance_projection

        project_u, _cal = make_box_chance_projection(
            x0_var, p, u_bounds[0], u_bounds[1],
            joint_alpha=joint_alpha, n_rows=N * m, method=chance_method,
        )
    # z-side default only when no x-block exists: with a state projection
    # the u-side z-iterate alone is NOT dynamics-consistent with the
    # x-side constraints (measured: terminal-equality satisfaction
    # collapses if the controller is built from z_u while the terminal
    # rows were enforced through the x block).
    if feasible_iterate is None:
        feasible_iterate = joint_alpha is not None and project_x is None
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)

    # Unconstrained synthesis for the non-robust columns.
    PHI_U_unc, _ = lqt_solve_sls(A, B, cost)

    Su = build_Su(A, B)
    # first p columns of Sw, built directly (O(N d^2 p) vs the
    # dense (Nd)^2 operator)
    Sx = build_Sx(A, p).reshape(-1, p)

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)
    Qr_l = block_diag_stacked(Qr) if Qr is not None else None
    Rr_l = block_diag_stacked(Rr) if Rr is not None else None

    Qlift = block_diag_stacked(cost.Q)
    SuTQ = Su.T @ Qlift
    l_side = SuTQ @ Su + block_diag_stacked(cost.R)
    r_side_ff = SuTQ @ cost.lifted_xd()
    r_side_fb = -SuTQ @ Sx

    SuTQr = None
    reg_mat = jnp.zeros_like(l_side)
    reg_fb = jnp.zeros_like(r_side_fb)
    if Qr_l is not None and project_x is not None:
        SuTQr = Su.T @ Qr_l
        reg_mat = reg_mat + SuTQr @ Su
        reg_fb = -SuTQr @ Sx
    if Rr_l is not None and project_u is not None:
        reg_mat = reg_mat + Rr_l

    weight_x = (lambda r: Qr_l @ r) if Qr_l is not None else None
    weight_u = (lambda r: Rr_l @ r) if Rr_l is not None else None

    if cfg.adaptive_rho:
        # residual-balancing penalties scale the whole regularizer by the
        # driver's rho_scale s: refactor the (Nm, Nm) normal matrix each
        # iteration (the robust-SLS x-update previously
        # errored under adaptive_rho)
        r_side0 = jnp.concatenate([r_side_ff[:, None], r_side_fb], axis=-1)

        def f_argmin(x, u, s):
            r = r_side0.at[:, 1:].add(s * reg_fb)
            if SuTQr is not None and x is not None:
                r = r + s * (SuTQr @ x)
            if Rr_l is not None and u is not None:
                r = r + s * (Rr_l @ u)
            U = cho_solve(cho_factor(l_side + s * reg_mat), r)
            X = Su @ U
            X = X.at[:, 1:].add(Sx)
            return X, U

        x_x, x_u, _, _, _, _, z_u, info = admm_solve(
            f_argmin, project_x, project_u,
            (N * d, p + 1), (N * m, p + 1), cfg,
            weight_x=weight_x, weight_u=weight_u,
            rho_weight_x=weight_x, rho_weight_u=weight_u, dtype=dtype,
        )
        out_u = z_u if (feasible_iterate and project_u is not None) else x_u
        du = out_u[:, 0]
        phi_u = jnp.concatenate([out_u[:, 1 : p + 1], PHI_U_unc[:, p:]], axis=-1)
        return du, phi_u, info

    l_side = l_side + reg_mat
    r_side_fb = r_side_fb + reg_fb
    cf = cho_factor(l_side)
    r_side = jnp.concatenate([r_side_ff[:, None], r_side_fb], axis=-1)  # (Nm, p+1)

    def f_argmin(x, u):
        r = r_side
        if SuTQr is not None and x is not None:
            r = r + SuTQr @ x
        if Rr_l is not None and u is not None:
            r = r + Rr_l @ u
        U = cho_solve(cf, r)  # (Nm, p+1)
        X = Su @ U
        X = X.at[:, 1:].add(Sx)
        return X, U

    x_x, x_u, _, _, _, _, z_u, info = admm_solve(
        f_argmin, project_x, project_u,
        (N * d, p + 1), (N * m, p + 1), cfg,
        weight_x=weight_x, weight_u=weight_u, dtype=dtype,
    )
    out_u = z_u if (feasible_iterate and project_u is not None) else x_u
    du = out_u[:, 0]
    phi_u = jnp.concatenate([out_u[:, 1 : p + 1], PHI_U_unc[:, p:]], axis=-1)
    return du, phi_u, info


def sls_admm(*args, **kwargs):
    """See `_sls_admm_impl` (HIGHEST matmul precision wrapper)."""
    with jax.default_matmul_precision("highest"):
        return _sls_admm_impl(*args, **kwargs)
