"""Batched robust SLS-ADMM with shared operators — scenario fleets.

For fleets of robust-synthesis problems that share dynamics and cost but
differ per instance (chance-constraint levels, bounds, uncertainty
scales — the scenario axis of BASELINE config #4), the x-update operators
(l_inv, Su, Sx) are instance-invariant: every ADMM iteration over the
whole fleet is a single einsum GEMM

    U = (r + W_x X_reg + W_u U_reg) @ l_inv^T     (batch, Nm, p+1)

plus the batched projection z-update. Differs from `vmap(sls_admm)` in
that the operators are built once (not per instance under vmap) and the
iteration count is fixed (SPMD-friendly), matching
`solvers/batched.py`'s design for the LQT case.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.problem import QuadCost
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu.solvers.lqt import lqt_solve_sls
from ilqr_admm_tpu.solvers.admm import validate_constraint_blocks

_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def make_batched_sls_admm(
    A,
    B,
    cost: QuadCost,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    robust_dim: Optional[int] = None,
    n_iters: int = 100,
    alpha: float = 1.0,
    tol: float = 0.0,
):
    """Build a jitted batched robust SLS-ADMM solver.

    tol = 0 runs exactly n_iters (deterministic count, the benchmark
    mode). tol > 0 adds per-instance early stopping (the SPMD analogue
    of the reference's per-problem residual loop, mirroring
    `solvers/batched.py::make_batched_lqt_admm`): an instance freezes
    once its Frobenius primal residual ||x_iter - z|| AND dual residual
    ||z - z_prev|| (summed over enabled blocks) drop below tol; the
    while_loop exits when every instance is frozen or n_iters is hit.

    project_x / project_u map (batch, N*dim, p+1) arrays (plus a
    per-instance `params` pytree broadcast from the solver input) to the
    constraint sets:  proj(y, params) -> y_projected.

    Returns solve(params) -> (du (batch, Nm), phi_u (batch, Nm, Nd),
    U (batch, Nm, p+1)) where `params` is any pytree with leading batch
    axis consumed by the projections (e.g. per-instance bounds).
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    p = d // 2 if robust_dim is None else robust_dim
    has_x = project_x is not None
    has_u = project_u is not None
    if not (has_x or has_u):
        raise ValueError("at least one projection required")

    # One-time operator SETUP must run at HIGHEST precision too: at
    # reduced matmul precision the built l_inv/SuTQ describe a PERTURBED
    # problem — the ADMM then converges tightly to the wrong optimum (a
    # cost gap vs the f64 QP oracle that stays flat in iteration count;
    # its size under the GPU's TF32 default is not measured). Same
    # lesson as solvers/batched.py setup.
    with jax.default_matmul_precision("highest"):
        PHI_unc, _ = lqt_solve_sls(A, B, cost)

        Su = build_Su(A, B)
        # first p columns of Sw, built directly (O(N d^2 p) vs the
        # dense (Nd)^2 operator)
        Sx = build_Sx(A, p).reshape(-1, p)

        Qr = broadcast_rho(rho_x, d, N, dtype)
        Rr = broadcast_rho(rho_u, m, N, dtype)
        Qr_l = block_diag_stacked(Qr) if (Qr is not None and has_x) else None
        Rr_l = block_diag_stacked(Rr) if (Rr is not None and has_u) else None

        Qlift = block_diag_stacked(cost.Q)
        SuTQ = Su.T @ Qlift
        l_side = SuTQ @ Su + block_diag_stacked(cost.R)
        r_fb = -SuTQ @ Sx
        SuTQr = None
        if Qr_l is not None:
            SuTQr = Su.T @ Qr_l
            l_side = l_side + SuTQr @ Su
            r_fb = r_fb - SuTQr @ Sx
        if Rr_l is not None:
            l_side = l_side + Rr_l
        l_inv = jnp.linalg.inv(l_side)
        r_ff = SuTQ @ cost.lifted_xd()
        r_base = jnp.concatenate([r_ff[:, None], r_fb], axis=-1)  # (Nm, p+1)

    l_invT = l_inv.T
    SuT = Su.T

    @jax.jit
    def solve(params):
        batch = jax.tree_util.tree_leaves(params)[0].shape[0]
        z_x = jnp.zeros((batch, N * d, p + 1), dtype)
        z_u = jnp.zeros((batch, N * m, p + 1), dtype)
        l_x = jnp.zeros_like(z_x)
        l_u = jnp.zeros_like(z_u)

        def x_update(z_x, z_u, l_x, l_u):
            r = jnp.broadcast_to(r_base, (batch,) + r_base.shape)
            if SuTQr is not None:
                r = r + jnp.einsum("ij,bjk->bik", SuTQr, z_x - l_x, precision=_PREC)
            if Rr_l is not None:
                r = r + jnp.einsum("ij,bjk->bik", Rr_l, z_u - l_u, precision=_PREC)
            U = jnp.einsum("ij,bjk->bik", l_inv, r, precision=_PREC)
            X = jnp.einsum("ij,bjk->bik", Su, U, precision=_PREC)
            X = X.at[:, :, 1:].add(Sx)
            return X, U

        def iteration(z_x, z_u, l_x, l_u):
            X, U = x_update(z_x, z_u, l_x, l_u)
            prim = jnp.zeros((batch,), dtype)
            dual = jnp.zeros((batch,), dtype)
            if has_x:
                z_rel = alpha * X + (1.0 - alpha) * z_x
                z_new = project_x(z_rel + l_x, params)
                l_x = l_x + X - z_new
                prim = prim + jnp.linalg.norm(
                    (X - z_new).reshape(batch, -1), axis=-1)
                dual = dual + jnp.linalg.norm(
                    (z_new - z_x).reshape(batch, -1), axis=-1)
                z_x = z_new
            if has_u:
                z_rel = alpha * U + (1.0 - alpha) * z_u
                z_new = project_u(z_rel + l_u, params)
                l_u = l_u + U - z_new
                prim = prim + jnp.linalg.norm(
                    (U - z_new).reshape(batch, -1), axis=-1)
                dual = dual + jnp.linalg.norm(
                    (z_new - z_u).reshape(batch, -1), axis=-1)
                z_u = z_new
            return z_x, z_u, l_x, l_u, X, U, prim, dual

        init = (z_x, z_u, l_x, l_u, z_x, z_u)

        if tol <= 0.0:
            def body(carry, _):
                z_x, z_u, l_x, l_u, X, U = carry
                z_x, z_u, l_x, l_u, X, U, _, _ = iteration(z_x, z_u, l_x, l_u)
                return (z_x, z_u, l_x, l_u, X, U), None

            (z_x, z_u, l_x, l_u, X, U), _ = lax.scan(
                body, init, None, length=n_iters)
        else:
            # per-instance early stopping: frozen instances keep their
            # iterates (select-masked carries), the loop exits when all
            # instances are frozen or the cap is hit
            done0 = jnp.zeros(batch, bool)

            def cond(state):
                it, done, *_ = state
                return jnp.logical_and(
                    it < n_iters, jnp.logical_not(jnp.all(done)))

            def wbody(state):
                it, done, z_x, z_u, l_x, l_u, X, U = state
                nz_x, nz_u, nl_x, nl_u, nX, nU, prim, dual = iteration(
                    z_x, z_u, l_x, l_u)
                keep = done[:, None, None]
                z_x = jnp.where(keep, z_x, nz_x)
                z_u = jnp.where(keep, z_u, nz_u)
                l_x = jnp.where(keep, l_x, nl_x)
                l_u = jnp.where(keep, l_u, nl_u)
                X = jnp.where(keep, X, nX)
                U = jnp.where(keep, U, nU)
                done = jnp.logical_or(
                    done, jnp.logical_and(prim < tol, dual < tol))
                return (it + 1, done, z_x, z_u, l_x, l_u, X, U)

            state = (jnp.int32(0), done0) + init
            _, _, z_x, z_u, l_x, l_u, X, U = lax.while_loop(
                cond, wbody, state)

        du = U[:, :, 0]
        phi_u = jnp.concatenate(
            [U[:, :, 1 : p + 1],
             jnp.broadcast_to(PHI_unc[:, p:], (batch,) + PHI_unc[:, p:].shape)],
            axis=-1,
        )
        return du, phi_u, U

    return solve
