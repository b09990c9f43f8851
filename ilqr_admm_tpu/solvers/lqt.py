"""Linear-quadratic tracking solvers: batch least-squares, Riccati DP, SLS.

Functional equivalents of the reference `SLS.solve_{batch,dp,sls}`
(`sls.py:40-233`) and `SLS.controller` (`sls.py:235-242`), jit/vmap-ready.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_factor, cho_solve

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sw, sw_x0
from ilqr_admm_tpu.ops.riccati import DPGains, lqt_backward
from ilqr_admm_tpu.ops.sls_synthesis import sls_synthesize
from ilqr_admm_tpu.problem import QuadCost


from ilqr_admm_tpu.utils.precision import highest_precision

def broadcast_rho(rho, dim: int, N: int, dtype=None):
    """Broadcast an ADMM penalty spec to stacked (N, dim, dim) blocks.

    Accepts: None | scalar | (dim, dim) | (N, dim, dim) — the reference's
    `compute_Rr_Qr` broadcast rules (`base.py:55-79`). Returns None or
    (N, dim, dim).
    """
    if rho is None:
        return None
    rho = jnp.asarray(rho, dtype=dtype)
    if rho.ndim == 0:
        return jnp.broadcast_to(rho * jnp.eye(dim, dtype=rho.dtype), (N, dim, dim))
    if rho.ndim == 2:
        return jnp.broadcast_to(rho, (N, dim, dim))
    return rho


def block_diag_stacked(blocks: jax.Array) -> jax.Array:
    """Dense block-diagonal (N*d, N*d) from stacked (N, d, d) blocks."""
    N, d = blocks.shape[0], blocks.shape[-1]
    out = jnp.zeros((N * d, N * d), blocks.dtype)
    idx = jnp.arange(N)
    return out.at[
        idx[:, None, None] * d + jnp.arange(d)[None, :, None],
        idx[:, None, None] * d + jnp.arange(d)[None, None, :],
    ].set(blocks)


def sqrt_psd_stacked(blocks: jax.Array) -> jax.Array:
    """Symmetric PSD square roots of stacked (N, d, d) blocks (eigh-based)."""
    w, V = jnp.linalg.eigh(blocks)
    w = jnp.sqrt(jnp.maximum(w, 0.0))
    return jnp.einsum("tij,tj,tkj->tik", V, w, V)


def blockdiag_matmul(blocks: jax.Array, M: jax.Array) -> jax.Array:
    """block_diag(blocks) @ M without the dense (N·d, N·d) operator.

    blocks: (N, d, d); M: (N·d,) or (N·d, k). N times cheaper than
    materializing the block-diagonal and doing a dense matmul.
    """
    N, d = blocks.shape[0], blocks.shape[-1]
    if M.ndim == 1:
        return jnp.einsum("tij,tj->ti", blocks, M.reshape(N, d)).reshape(-1)
    return jnp.einsum("tij,tjk->tik", blocks, M.reshape(N, d, M.shape[-1])).reshape(
        N * d, M.shape[-1]
    )


@highest_precision
def lifted_normal_eqs(A, B, cost: QuadCost, Qr=None, Rr=None):
    """Assemble the dense lifted pieces used by batch / SLS paths.

    Returns dict with Su (Nd, Nm), Sw (Nd, Nd), SuTQ (Nm, Nd),
    l_side = Su^T (Q + Qr) Su + R + Rr, SuTQr (Nm, Nd) or None.
    """
    Su = build_Su(A, B)
    Sw = build_Sw(A)
    Qlift = block_diag_stacked(cost.Q)
    Rlift = block_diag_stacked(cost.R)
    SuTQ = Su.T @ Qlift
    l_side = SuTQ @ Su + Rlift
    SuTQr = None
    if Qr is not None:
        SuTQr = Su.T @ block_diag_stacked(Qr)
        l_side = l_side + SuTQr @ Su
    Rr_lift = None
    if Rr is not None:
        Rr_lift = block_diag_stacked(Rr)
        l_side = l_side + Rr_lift
    return dict(Su=Su, Sw=Sw, SuTQ=SuTQ, l_side=l_side, SuTQr=SuTQr, Rr=Rr_lift)


@highest_precision
def lqt_solve_batch(A, B, cost: QuadCost, x0, use_qr: bool = False):
    """Open-loop optimum via lifted least squares (reference `sls.py:62-83`).

    use_qr=True solves the square-root system instead of the normal
    equations: QR-factor G = [sqrt(Q) Su; sqrt(R)] and back-substitute —
    accuracy degrades with cond(G) rather than cond(G)^2 = cond(SuᵀQSu+R),
    which keeps stiff via-point weights (x_std/u_std ratios ≳ 1e4)
    accurate in f32 (same trick as the ADMM x-update's `use_qr`,
    `lqt_admm.py`).

    Returns (xs (N, d), us (N, m)).
    """
    N, m = A.shape[0], B.shape[-1]
    Su = build_Su(A, B)
    free = sw_x0(A, x0).reshape(-1)
    if use_qr:
        from jax.scipy.linalg import solve_triangular

        sqQ = sqrt_psd_stacked(cost.Q)  # (N, d, d) blocks
        sqR = block_diag_stacked(sqrt_psd_stacked(cost.R))
        G = jnp.concatenate([blockdiag_matmul(sqQ, Su), sqR], axis=0)
        c = jnp.concatenate(
            [blockdiag_matmul(sqQ, cost.lifted_xd() - free), jnp.zeros((N * m,), A.dtype)]
        )
        Qf, Rf = jnp.linalg.qr(G)
        u_opt = solve_triangular(Rf, Qf.T @ c, lower=False)
    else:
        Qlift = block_diag_stacked(cost.Q)
        Rlift = block_diag_stacked(cost.R)
        SuTQ = Su.T @ Qlift
        l_side = SuTQ @ Su + Rlift
        r_side = SuTQ @ (cost.lifted_xd() - free)
        u_opt = cho_solve(cho_factor(l_side), r_side)
    x_opt = free + Su @ u_opt
    return x_opt.reshape(N, -1), u_opt.reshape(N, m)


@highest_precision
def lqt_solve_dp(
    A, B, cost: QuadCost,
    Qr=None, xr=None, Rr=None, ur=None,
    time_parallel=None,
    fast_inverse: bool = False,
) -> DPGains:
    """LQT Riccati DP (reference `sls.py:85-166`): returns DPGains.

    The feedback law is u_t = K_t x_t + k_t.

    time_parallel: None = sequential scan; 'flat' = associative scan
    (O(log N) depth, best N ≲ 2k); an int L = two-level blocked scan
    with block size L (O(N) combines, best at long horizons — see
    `ops/parallel_riccati.py` and benchmarks/RESULTS.md).
    fast_inverse (time-parallel paths only): closed-form adjugate
    combine inverses (state dim <= 4) — faster, adjugate accuracy
    envelope.
    """
    if time_parallel is not None:
        from ilqr_admm_tpu.ops.parallel_riccati import lqt_backward_parallel

        if time_parallel == "flat":
            bs = None
        elif isinstance(time_parallel, bool) or (
            not isinstance(time_parallel, int) or time_parallel < 2
        ):
            # True would silently mean block_size=1 (N sequential
            # combines — strictly worse than the sequential scan)
            raise ValueError(
                "time_parallel must be None, 'flat', or an int block "
                f"size >= 2, got {time_parallel!r}"
            )
        else:
            bs = time_parallel
        return lqt_backward_parallel(
            A, B, cost.Q, cost.xd, cost.R,
            Qr=Qr, xr=xr, Rr=Rr, ur=ur, block_size=bs,
            fast_inverse=fast_inverse,
        )
    return lqt_backward(A, B, cost.Q, cost.xd, cost.R, Qr=Qr, xr=xr, Rr=Rr, ur=ur)


@highest_precision
def lqt_solve_sls(A, B, cost: QuadCost):
    """SLS synthesis: causal feedback map Phi_u + feedforward du.

    Reference `sls.py:205-233`, with the Woodbury cascade replaced by the
    reversed-Cholesky batched solve (`ops/sls_synthesis.py`).
    Returns (PHI_U (Nm, Nd), du (Nm,)).
    """
    x_dim, u_dim = A.shape[-1], B.shape[-1]
    eqs = lifted_normal_eqs(A, B, cost)
    r_ff = eqs["SuTQ"] @ cost.lifted_xd()
    r_fb = -eqs["SuTQ"] @ eqs["Sw"]
    return sls_synthesize(eqs["l_side"], r_ff, r_fb, u_dim, x_dim)


@highest_precision
def lqt_solve_batch_full(A, B, Q_full, xd_full, R_full, x0):
    """Batch LQT with a *dense lifted* cost (cross-timestep correlations).

    Q_full: (N*d, N*d); xd_full: (N*d,); R_full: (N*m, N*m). The batch
    and SLS methods support costs correlating different timesteps
    (reference `sls.py:14-16` capability; per-step `QuadCost` is the
    block-diagonal special case). Returns (xs (N,d), us (N,m)).
    """
    N, m = A.shape[0], B.shape[-1]
    Su = build_Su(A, B)
    SuTQ = Su.T @ Q_full
    l_side = SuTQ @ Su + R_full
    free = sw_x0(A, x0).reshape(-1)
    r_side = SuTQ @ (xd_full - free)
    u_opt = cho_solve(cho_factor(l_side), r_side)
    x_opt = free + Su @ u_opt
    return x_opt.reshape(N, -1), u_opt.reshape(N, m)


@highest_precision
def lqt_solve_sls_full(A, B, Q_full, xd_full, R_full):
    """SLS synthesis with a dense lifted cost. Returns (PHI_U, du)."""
    from ilqr_admm_tpu.ops.sls_synthesis import sls_synthesize as _synth

    x_dim, u_dim = A.shape[-1], B.shape[-1]
    Su = build_Su(A, B)
    Sw = build_Sw(A)
    SuTQ = Su.T @ Q_full
    l_side = SuTQ @ Su + R_full
    r_ff = SuTQ @ xd_full
    r_fb = -SuTQ @ Sw
    return _synth(l_side, r_ff, r_fb, u_dim, x_dim)


@highest_precision
def sls_controller(A, B, PHI_U, du):
    """Recover time-domain gains (K, k) from the response map.

    K = Phi_u Phi_x^{-1}; k = (I - K Su) du (reference `sls.py:235-242`).
    """
    Su = build_Su(A, B)
    Sw = build_Sw(A)
    PHI_X = Sw + Su @ PHI_U
    K = jnp.linalg.solve(PHI_X.T, PHI_U.T).T
    k = (jnp.eye(Su.shape[-1], dtype=Su.dtype) - K @ Su) @ du
    return K, k


@highest_precision
def replanning_matrix(A, B, cost: QuadCost, K):
    """Receding-horizon feedforward replanning operator.

    reference `sls.py:244-248`: M = (I - K Su)(Su^T Q Su + R)^{-1} Su^T Q;
    `k_new = k + M (xd_new - xd_old)`.
    """
    eqs = lifted_normal_eqs(A, B, cost)
    Su = eqs["Su"]
    rhs = jnp.linalg.solve(eqs["l_side"], eqs["SuTQ"])
    return (jnp.eye(Su.shape[-1], dtype=Su.dtype) - K @ Su) @ rhs


def replan_feedforward(k, replan_matrix, xd_new, xd_old):
    return k + replan_matrix @ (xd_new - xd_old)
