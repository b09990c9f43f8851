"""Constrained LQT via ADMM splitting — batch and DP x-updates.

Functional equivalents of `SLS.ADMM_LQT_Batch` (`sls.py:252-293`) and
`SLS.ADMM_LQT_DP` (`sls.py:298-317`). The z-update projections operate on
flattened lifted vectors (N*x_dim,) / (N*u_dim,), matching the reference
notebook projection closures.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from ilqr_admm_tpu.ops.lifted import build_Su, sw_x0
from ilqr_admm_tpu.ops.riccati import lqt_backward, lqt_backward_ff
from ilqr_admm_tpu.problem import ADMMConfig, QuadCost
from ilqr_admm_tpu.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu.solvers.lqt import (
    block_diag_stacked,
    blockdiag_matmul,
    broadcast_rho,
    sqrt_psd_stacked,
)

# back-compat alias (helper moved to solvers/lqt.py, shared with
# lqt_solve_batch's use_qr path)
_sqrt_psd_stacked = sqrt_psd_stacked


def _lqt_admm_batch_impl(
    A,
    B,
    cost: QuadCost,
    x0,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    cfg: ADMMConfig = ADMMConfig(),
    use_qr: bool = False,
):
    """Constrained LQT, lifted least-squares x-update (one matmul per iter).

    Returns (x_flat, u_flat, info) with x_flat (N*x_dim,), u_flat (N*u_dim,).

    use_qr=True replaces the normal-equation Cholesky with a QR
    factorization of the stacked square-root system
    [sqrt(Q) Su; sqrt(R); sqrt(Qr) Su; sqrt(Rr)] — condition number
    cond(G) instead of cond(G)^2, which keeps f32 accuracy at the
    reference's stiff weight ratios (x_std up to 1e6; SURVEY §7 hard
    part). Slightly more setup cost; identical math.
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if use_qr:
        return _lqt_admm_batch_qr(
            A, B, cost, x0, project_x, project_u, rho_x, rho_u, cfg
        )
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)

    Su = build_Su(A, B)
    Qlift = block_diag_stacked(cost.Q)
    Rlift = block_diag_stacked(cost.R)
    SuTQ = Su.T @ Qlift
    l_side = SuTQ @ Su + Rlift
    free = sw_x0(A, x0).reshape(-1)
    r_side = SuTQ @ (cost.lifted_xd() - free)

    # Warm start z from the unconstrained optimum (reference `sls.py:269-271`).
    u_unc = cho_solve(cho_factor(l_side), r_side)
    z_u0 = u_unc
    z_x0 = free + Su @ u_unc

    SuTQr = None
    SuTQr_Su = None
    if Qr is not None:
        SuTQr = Su.T @ block_diag_stacked(Qr)
        SuTQr_Su = SuTQr @ Su
    Rr_l = None
    if Rr is not None:
        Rr_l = block_diag_stacked(Rr)

    if cfg.adaptive_rho:
        # Residual-balancing penalties: the normal matrix depends on the
        # current rho scale, so each x-update refactors
        # l_side + s * reg_mat (one O(M^3/3) Cholesky per iteration —
        # paid back by the 2-5x iteration-count cut on ill-scaled
        # problems).
        reg_mat = jnp.zeros_like(l_side)
        rho_wx = rho_wu = None
        if SuTQr_Su is not None:
            reg_mat = reg_mat + SuTQr_Su
            Qr_l = block_diag_stacked(Qr)
            rho_wx = lambda r: Qr_l @ r
        if Rr_l is not None:
            reg_mat = reg_mat + Rr_l
            rho_wu = lambda r: Rr_l @ r

        def f_argmin(x, u, s):
            r = r_side
            if SuTQr is not None:
                r = r - s * (SuTQr @ free)
                if x is not None:
                    r = r + s * (SuTQr @ x)
            if Rr_l is not None and u is not None:
                r = r + s * (Rr_l @ u)
            u_hat = cho_solve(cho_factor(l_side + s * reg_mat), r)
            x_hat = free + Su @ u_hat
            return x_hat, u_hat

    else:
        rho_wx = rho_wu = None
        if SuTQr_Su is not None:
            l_side = l_side + SuTQr_Su
            r_side = r_side - SuTQr @ free
            if cfg.accel:
                # rho-weight the accel restart monitor per block
                Qr_s = Qr

                def rho_wx(r):
                    return jnp.einsum(
                        "nij,nj->ni", Qr_s, r.reshape(N, d)
                    ).reshape(-1)

        if Rr_l is not None:
            l_side = l_side + Rr_l
            if cfg.accel:
                Rr_s = Rr

                def rho_wu(r):
                    return jnp.einsum(
                        "nij,nj->ni", Rr_s, r.reshape(N, m)
                    ).reshape(-1)

        cf = cho_factor(l_side)

        def f_argmin(x, u):
            r = r_side
            if SuTQr is not None and x is not None:
                r = r + SuTQr @ x
            if Rr_l is not None and u is not None:
                r = r + Rr_l @ u
            u_hat = cho_solve(cf, r)
            x_hat = free + Su @ u_hat
            return x_hat, u_hat

    x_x, x_u, _, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg,
        z_x_init=z_x0, z_u_init=z_u0,
        rho_weight_x=rho_wx, rho_weight_u=rho_wu, dtype=dtype,
    )
    return x_x, x_u, info


def _lqt_admm_batch_qr(
    A, B, cost, x0, project_x, project_u, rho_x, rho_u, cfg,
):
    """QR (square-root) x-update variant of the batch LQT-ADMM."""
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)
    has_x = project_x is not None
    has_u = project_u is not None

    Su = build_Su(A, B)
    free = sw_x0(A, x0).reshape(-1)
    xd = cost.lifted_xd()

    # block square roots kept stacked; blockdiag_matmul applies them
    # blockwise (N x cheaper than dense (Nd,Nd) products)
    sqQ = sqrt_psd_stacked(cost.Q)
    sqR = block_diag_stacked(sqrt_psd_stacked(cost.R))
    rows = [blockdiag_matmul(sqQ, Su), sqR]
    sqQr = sqRr = None
    if Qr is not None and has_x:
        sqQr = sqrt_psd_stacked(Qr)
        rows.append(blockdiag_matmul(sqQr, Su))
    if Rr is not None and has_u:
        sqRr = block_diag_stacked(sqrt_psd_stacked(Rr))
        rows.append(sqRr)
    G = jnp.concatenate(rows, axis=0)  # (n_rows, Nm)
    Qf, Rf = jnp.linalg.qr(G)  # reduced: Qf (n_rows, Nm), Rf (Nm, Nm)

    # stacked rhs c with G^T c = r_side; u = Rf^{-1} Qf^T c
    c0 = blockdiag_matmul(sqQ, xd - free)
    zeros_R = jnp.zeros((N * m,), dtype)

    from jax.scipy.linalg import solve_triangular

    def solve_ls(c_parts):
        c = jnp.concatenate(c_parts, axis=0)
        return solve_triangular(Rf, Qf.T @ c, lower=False)

    # warm start: regularized LS with zero-centered reg targets (a valid
    # init; the reference warm-starts from the unregularized optimum)
    warm_parts = [c0, zeros_R]
    if sqQr is not None:
        warm_parts.append(jnp.zeros((N * d,), dtype))
    if sqRr is not None:
        warm_parts.append(zeros_R)
    u_unc = solve_ls(warm_parts)
    z_u0 = u_unc
    z_x0 = free + Su @ u_unc

    def f_argmin(x, u):
        parts = [c0, zeros_R]
        if sqQr is not None:
            parts.append(blockdiag_matmul(sqQr, (x if x is not None else free) - free))
        if sqRr is not None:
            parts.append(sqRr @ (u if u is not None else jnp.zeros((N * m,), dtype)))
        u_hat = solve_ls(parts)
        x_hat = free + Su @ u_hat
        return x_hat, u_hat

    x_x, x_u, _, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg,
        z_x_init=z_x0, z_u_init=z_u0, dtype=dtype,
    )
    return x_x, x_u, info


def _lqt_admm_dp_impl(
    A,
    B,
    cost: QuadCost,
    x0,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    cfg: ADMMConfig = ADMMConfig(max_iter=2000),
    operator_form: bool = True,
):
    """Constrained LQT, Riccati DP x-update.

    One full Riccati pass up-front caches (K, Quu, Quu_inv, Qux); each
    ADMM iteration is the cheap feedforward re-sweep + closed-loop rollout
    (reference `sls.py:298-317`).

    operator_form=True (default) additionally precomputes the ff-sweep +
    rollout as exact affine operators of the ADMM targets (the composed
    map is linear — one `jacfwd` evaluates it exactly), so each ADMM
    iteration is a few matvecs instead of two O(N) scans: removes the
    scan latency of the per-iteration sweeps with bit-level identical
    iterates. Set False for O(N) memory at very long horizons.

    Returns (x_flat, u_flat, (K, k), info).
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)
    zxr = jnp.zeros((N, d), dtype)
    zur = jnp.zeros((N, m), dtype)

    if cfg.adaptive_rho:
        return _lqt_admm_dp_adaptive(
            A, B, cost, x0, project_x, project_u, Qr, Rr, cfg
        )

    gains = lqt_backward(A, B, cost.Q, cost.xd, cost.R, Qr=Qr, xr=zxr, Rr=Rr, ur=zur)

    def sweep(x_flat, u_flat):
        """(xr, ur) targets -> (x, u, k): affine in its inputs."""
        k = lqt_backward_ff(
            gains, A, B, cost.Q, cost.xd,
            Qr=Qr, xr=x_flat.reshape(N, d), Rr=Rr, ur=u_flat.reshape(N, m),
        )

        def scan_step(xt, inp):
            Kt, kt, At, Bt = inp
            ut = Kt @ xt + kt
            return At @ xt + Bt @ ut, (xt, ut)

        _, (xs, us) = jax.lax.scan(scan_step, x0, (gains.K, k, A, B))
        return xs.reshape(-1), us.reshape(-1), k

    zx_f = jnp.zeros((N * d,), dtype)
    zu_f = jnp.zeros((N * m,), dtype)

    if operator_form:
        with jax.default_matmul_precision("highest"):
            consts = sweep(zx_f, zu_f)
            jac_x = jax.jacfwd(lambda x: sweep(x, zu_f))(zx_f)
            jac_u = jax.jacfwd(lambda u: sweep(zx_f, u))(zu_f)

        def f_argmin(x, u):
            xv = x if x is not None else zx_f
            uv = u if u is not None else zu_f
            out = jax.tree_util.tree_map(
                lambda c, Jx, Ju: c + Jx @ xv + Ju @ uv, consts, jac_x, jac_u
            )
            xs, us, k = out
            return xs, us, (gains.K, k)

    else:

        def f_argmin(x, u):
            xs, us, k = sweep(
                x if x is not None else zx_f, u if u is not None else zu_f
            )
            return xs, us, (gains.K, k)

    x_x, x_u, aux, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg, dtype=dtype
    )
    return x_x, x_u, aux, info


def _lqt_admm_dp_adaptive(
    A, B, cost, x0, project_x, project_u, Qr, Rr, cfg,
):
    """Adaptive-rho DP x-update (beyond the batch path).

    Residual-balancing rescales all penalties by the driver's rho_scale
    s, so the cached-gains/operator-form fast paths (which bake the
    penalty into the Riccati factorization) do not apply: each ADMM
    iteration re-runs the full backward pass with s-scaled Qr/Rr plus
    the closed-loop rollout — O(N d^3) per iteration, paid back by the
    iteration-count cut on ill-scaled penalties.
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    zxr = jnp.zeros((N, d), dtype)
    zur = jnp.zeros((N, m), dtype)

    def f_argmin(x_flat, u_flat, s):
        xr = zxr if x_flat is None else x_flat.reshape(N, d)
        ur = zur if u_flat is None else u_flat.reshape(N, m)
        g = lqt_backward(
            A, B, cost.Q, cost.xd, cost.R,
            Qr=None if Qr is None else s * Qr, xr=xr,
            Rr=None if Rr is None else s * Rr, ur=ur,
        )

        def scan_step(xt, inp):
            Kt, kt, At, Bt = inp
            ut = Kt @ xt + kt
            return At @ xt + Bt @ ut, (xt, ut)

        _, (xs, us) = jax.lax.scan(scan_step, x0, (g.K, g.k, A, B))
        return xs.reshape(-1), us.reshape(-1), (g.K, g.k)

    rho_wx = None
    if Qr is not None and project_x is not None:
        rho_wx = lambda r: jnp.einsum("nij,nj->ni", Qr, r.reshape(N, d)).reshape(-1)
    rho_wu = None
    if Rr is not None and project_u is not None:
        rho_wu = lambda r: jnp.einsum("nij,nj->ni", Rr, r.reshape(N, m)).reshape(-1)

    x_x, x_u, aux, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg,
        rho_weight_x=rho_wx, rho_weight_u=rho_wu, dtype=dtype,
    )
    return x_x, x_u, aux, info


def lqt_admm_batch(*args, **kwargs):
    """See `_lqt_admm_batch_impl` (HIGHEST matmul precision wrapper)."""
    with jax.default_matmul_precision("highest"):
        return _lqt_admm_batch_impl(*args, **kwargs)


def lqt_admm_dp(*args, **kwargs):
    """See `_lqt_admm_dp_impl` (HIGHEST matmul precision wrapper)."""
    with jax.default_matmul_precision("highest"):
        return _lqt_admm_dp_impl(*args, **kwargs)
