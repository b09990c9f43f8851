"""GEMM-formulated batched LQT-ADMM — the XLA throughput path.

Observation: with the lifted operators prefactored, every ADMM iteration
of the constrained LQT is two dense matmuls plus elementwise projections:

    u = (r_side + x_reg W_x + u_reg W_u) @ l_inv^T      (GEMM)
    x = free + u @ Su^T                                  (GEMM)
    z/λ updates, projections                             (elementwise, fused)

so a *batch* of instances maps onto (batch, N·m) GEMMs with shared
operators — no per-timestep scans in the hot loop at all. This is the
batched redesign of both reference ADMM paths (`sls.py:252-317`):
the Riccati-DP x-update's O(N) sweep is replaced by a precomputed
closed-loop affine response, mathematically identical to the prefactored
lifted solve.

`make_batched_lqt_admm` returns a jitted solver over (batch, x_dim)
initial states; iterations run as a `lax.scan` with a fixed count
(per-instance convergence masks are cheap to add on top — the fixed
count is what a throughput benchmark and fleet solves want).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx

# ADMM iterates are sensitive to matmul precision: a reduced-precision
# default f32 matmul (TF32 on the GPU) loses enough accuracy to stall
# convergence, so the hot GEMMs pin HIGHEST (IEEE f32) precision — the
# plain reference path. Whether a cheaper preset passes the oracle gates
# is open (ROADMAP).
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def _chol_solve_small(M, b):
    """Unrolled batched Cholesky solve for tiny SPD systems.

    M: (..., n, n) SPD (n static, small — the Anderson gram), b: (..., n).
    Every operation is an elementwise broadcast over the leading batch
    axes — `jnp.linalg.solve`'s batched LU can lower pathologically for
    thousands of tiny systems."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = M[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(acc, 1e-30))
            else:
                L[i][j] = acc / L[j][j]
    y = [None] * n
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return jnp.stack(x, axis=-1)
from ilqr_admm_tpu.problem import QuadCost
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu.solvers.admm import validate_constraint_blocks


def make_batched_lqt_admm(
    A,
    B,
    cost: QuadCost,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    n_iters: int = 100,
    alpha: float = 1.0,
    tol: float = 0.0,
    anderson_m: int = 0,
    anderson_safeguard: float = 10.0,
    anderson_reg: float = 1e-10,
):
    """Build a jitted batched constrained-LQT ADMM solver.

    project_x / project_u operate on flattened (batch, N*dim) arrays.
    Returns solve(x0s (batch, d)) -> (x (batch, N*d), u (batch, N*m)).

    tol = 0 runs exactly n_iters (deterministic count, the benchmark
    mode). tol > 0 adds per-instance early stopping: converged instances
    freeze while the while_loop continues until every instance converges
    or the cap is hit — the SPMD analogue of per-instance residual
    stopping (reference `admm.py:72-85`).

    anderson_m > 0 (requires tol > 0) runs PER-INSTANCE safeguarded
    type-II Anderson acceleration on top of the early stopping: every
    instance carries its own secant memory over the batch axis (the
    (B, m, m) grams and extrapolations are batched contractions; the
    tiny per-instance gram solves are an unrolled batch-vectorized
    Cholesky), restarts on residual increase independently, and each
    instance returns its best-scoring plain evaluation (same certificate
    discipline as `admm_solve`). SCOPE: pays off when plain ADMM's
    iteration count is large — tight-tolerance f64 fleets (on the
    CPU in f64, iterations to the same solution fell from 24-1,333 to
    8-21; the time saved on the GPU is not measured,
    `benchmarks/bench_fleet_anderson.py`). At
    f32 serving tolerances plain early-stop needs few iterations and
    the secant differences of near-converged instances approach the
    matmul noise floor (the fleet can then ride the iteration cap; the
    best-iterate guarantee bounds, but does not repair, those
    instances). Prefer plain early-stop for f32 serving fleets.
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if anderson_m > 0 and tol <= 0.0:
        raise ValueError(
            "anderson_m > 0 requires tol > 0: the fixed-count scan mode "
            "returns the last iterate, which Anderson cannot certify — "
            "use the per-instance early-stopping mode"
        )
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    has_x = project_x is not None
    has_u = project_u is not None

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)

    # The one-time operator setup must run at HIGHEST precision too:
    # reduced-precision matmuls perturb l_inv/SuTQ enough that the ADMM
    # converges tightly to the optimum of a *perturbed* problem (a
    # percent-level cost gap vs the f64 oracle with a bf16-pass setup;
    # the hot-loop _mm pinning alone does not fix it).
    with jax.default_matmul_precision("highest"):
        Su = build_Su(A, B)
        Sx = build_Sx(A).reshape(N * d, d)
        Qlift = block_diag_stacked(cost.Q)
        Rlift = block_diag_stacked(cost.R)
        SuTQ = Su.T @ Qlift
        l_side = SuTQ @ Su + Rlift
        l_inv_unreg = jnp.linalg.inv(l_side)

        SuTQr = None
        if Qr is not None and has_x:
            SuTQr = Su.T @ block_diag_stacked(Qr)
            l_side = l_side + SuTQr @ Su
        Rr_l = None
        if Rr is not None and has_u:
            Rr_l = block_diag_stacked(Rr)
            l_side = l_side + Rr_l
        l_inv = jnp.linalg.inv(l_side)
        r_const = SuTQ @ cost.lifted_xd()

    def solve(x0s):
        """x0s: (batch, d). Returns (x, u) flattened per instance."""
        free = _mm(x0s, Sx.T)  # (batch, N*d)
        r_base = r_const[None] - _mm(free, SuTQ.T)  # (batch, N*m)
        if SuTQr is not None:
            r_base = r_base - _mm(free, SuTQr.T)  # move free response into reg target

        # warm start from the unconstrained optimum (reference `sls.py:269-271`)
        u0 = _mm(r_const[None] - _mm(free, SuTQ.T), l_inv_unreg.T)
        z_u = u0
        z_x = free + _mm(u0, Su.T)
        l_x = jnp.zeros_like(z_x)
        l_u = jnp.zeros_like(z_u)

        def iteration(z_x, z_u, l_x, l_u):
            r = r_base
            if SuTQr is not None:
                # reg target is absolute x; operator pullback uses (x_reg - free)
                r = r + _mm(z_x - l_x, SuTQr.T)
            if Rr_l is not None:
                r = r + _mm(z_u - l_u, Rr_l.T)
            u_hat = _mm(r, l_inv.T)  # (batch, N*m) GEMM
            x_hat = free + _mm(u_hat, Su.T)  # (batch, N*d) GEMM

            prim = jnp.zeros(u_hat.shape[0], u_hat.dtype)
            dual = jnp.zeros_like(prim)
            if has_x:
                z_rel = alpha * x_hat + (1.0 - alpha) * z_x
                z_x_new = project_x(z_rel + l_x)
                l_x = l_x + x_hat - z_x_new
                prim = prim + jnp.linalg.norm(x_hat - z_x_new, axis=-1)
                dual = dual + jnp.linalg.norm(z_x_new - z_x, axis=-1)
                z_x = z_x_new
            if has_u:
                z_rel = alpha * u_hat + (1.0 - alpha) * z_u
                z_u_new = project_u(z_rel + l_u)
                l_u = l_u + u_hat - z_u_new
                prim = prim + jnp.linalg.norm(u_hat - z_u_new, axis=-1)
                dual = dual + jnp.linalg.norm(z_u_new - z_u, axis=-1)
                z_u = z_u_new
            return z_x, z_u, l_x, l_u, x_hat, u_hat, prim, dual

        init = (z_x, z_u, l_x, l_u, z_x, z_u)

        if tol <= 0.0:
            def body(carry, _):
                z_x, z_u, l_x, l_u, x, u = carry
                z_x, z_u, l_x, l_u, x, u, _, _ = iteration(z_x, z_u, l_x, l_u)
                return (z_x, z_u, l_x, l_u, x, u), None

            (z_x, z_u, l_x, l_u, x, u), _ = lax.scan(body, init, None, length=n_iters)
            return x, u

        # per-instance early stopping: frozen instances keep their iterates
        done0 = jnp.zeros(x0s.shape[0], bool)

        def cond(state):
            it, done, *_ = state
            return jnp.logical_and(it < n_iters, jnp.logical_not(jnp.all(done)))

        if anderson_m <= 0:
            def wbody(state):
                it, done, z_x, z_u, l_x, l_u, x, u = state
                nz_x, nz_u, nl_x, nl_u, nx, nu, prim, dual = iteration(z_x, z_u, l_x, l_u)
                keep = done[:, None]
                z_x = jnp.where(keep, z_x, nz_x)
                z_u = jnp.where(keep, z_u, nz_u)
                l_x = jnp.where(keep, l_x, nl_x)
                l_u = jnp.where(keep, l_u, nl_u)
                x = jnp.where(keep, x, nx)
                u = jnp.where(keep, u, nu)
                done = jnp.logical_or(done, jnp.logical_and(prim < tol, dual < tol))
                return (it + 1, done, z_x, z_u, l_x, l_u, x, u)

            state = (jnp.int32(0), done0) + init
            _, done, z_x, z_u, l_x, l_u, x, u = lax.while_loop(cond, wbody, state)
            return x, u

        # ---- per-instance Anderson (batched mirror of
        # solvers/admm.py::_admm_solve_anderson; pack only enabled blocks)
        Bn = x0s.shape[0]
        m_aa = anderson_m
        # same defaults/semantics as ADMMConfig.anderson_safeguard /
        # anderson_reg — keep the two 'KEEP IN SYNC' drivers tunable
        # identically (a user moving between admm_solve and this mirror
        # must get the same behavior from the same knobs)
        SAFE = float(anderson_safeguard)  # restart vs best-since-restart
        REG = float(anderson_reg)  # relative Tikhonov reg of the gram

        def pack(zx, zu, lx, lu):
            parts = []
            if has_x:
                parts += [zx, lx]
            if has_u:
                parts += [zu, lu]
            return jnp.concatenate(parts, axis=-1)

        sxd = N * d if has_x else 0
        sud = N * m if has_u else 0
        D = 2 * (sxd + sud)

        def unpack(v):
            zx = v[:, :sxd] if has_x else z_x
            lx = v[:, sxd : 2 * sxd] if has_x else l_x
            zu = v[:, 2 * sxd : 2 * sxd + sud] if has_u else z_u
            lu = v[:, 2 * sxd + sud :] if has_u else l_u
            return zx, zu, lx, lu

        eye_aa = jnp.eye(m_aa, dtype=dtype)

        def abody(state):
            (it, done, v_in, x, u, mem_dv, mem_dg,
             prev_v, prev_g, has_prev, best, ret_score) = state
            cz_x, cz_u, cl_x, cl_u = unpack(v_in)
            nz_x, nz_u, nl_x, nl_u, nx, nu, prim, dual = iteration(
                cz_x, cz_u, cl_x, cl_u
            )
            v_plain = pack(nz_x, nz_u, nl_x, nl_u)
            g = v_plain - v_in
            gnorm = jnp.linalg.norm(g, axis=-1)

            restart = jnp.logical_and(has_prev, gnorm > SAFE * best)
            push = jnp.logical_and(has_prev, jnp.logical_not(restart))
            mem_dv_p = jnp.roll(mem_dv, -1, axis=1).at[:, -1].set(v_in - prev_v)
            mem_dg_p = jnp.roll(mem_dg, -1, axis=1).at[:, -1].set(g - prev_g)
            sel = push[:, None, None]
            rst = restart[:, None, None]
            mem_dv_new = jnp.where(sel, mem_dv_p, jnp.where(rst, 0.0, mem_dv))
            mem_dg_new = jnp.where(sel, mem_dg_p, jnp.where(rst, 0.0, mem_dg))

            # the secant gram/extrapolation contractions MUST run at
            # HIGHEST precision: at reduced precision the gram of
            # near-converged secant differences is pure noise -> garbage
            # weights -> endless restarts (the fleet sits at the
            # iteration cap)
            gram = jnp.einsum("bmd,bnd->bmn", mem_dg_new, mem_dg_new,
                              precision=_PREC)
            tr = jnp.trace(gram, axis1=-2, axis2=-1)[:, None, None]
            rhs = jnp.einsum("bmd,bd->bm", mem_dg_new, g, precision=_PREC)
            gam = _chol_solve_small(gram + (REG * tr + 1e-30) * eye_aa, rhs)
            v_aa = v_in + g - jnp.einsum(
                "bmd,bm->bd", mem_dv_new + mem_dg_new, gam, precision=_PREC
            )
            # near the dtype's residual floor the secant pairs are noise
            # and extrapolation chatters an instance around the tolerance
            # forever (in f32 a few such instances can keep the whole
            # fleet's while_loop at the iteration cap) — finish
            # with plain steps below a machine-precision-scaled floor
            # (~1e-4·||v|| in f32, ~2e-13·||v|| in f64: irrelevant for
            # tight-tolerance f64 runs, which is where Anderson pays)
            eps = jnp.finfo(dtype).eps
            noise_floor = 1e3 * eps * (1.0 + jnp.linalg.norm(v_plain, axis=-1))
            use_aa = gnorm > noise_floor
            v_next = jnp.where(
                jnp.logical_and(use_aa, jnp.logical_not(restart))[:, None],
                v_aa, v_plain,
            )

            best = jnp.where(restart, jnp.inf, jnp.minimum(best, gnorm))
            conv = jnp.logical_and(prim < tol, dual < tol)
            # returned iterate per instance = its BEST-scoring plain
            # evaluation (same guarantee as admm_solve's anderson path:
            # extrapolation wander on hard instances must not degrade
            # what the caller gets below the best plain pass seen); a
            # converging evaluation is always taken so the frozen iterate
            # satisfies the declared tolerance
            score = prim + dual
            take = jnp.logical_and(
                jnp.logical_not(done),
                jnp.logical_or(score < ret_score, conv),
            )
            tk = take[:, None]
            keep = done[:, None]
            keep3 = keep[:, :, None]
            return (
                it + 1,
                jnp.logical_or(done, conv),
                jnp.where(keep, v_in, v_next),
                jnp.where(tk, nx, x),
                jnp.where(tk, nu, u),
                jnp.where(keep3, mem_dv, mem_dv_new),
                jnp.where(keep3, mem_dg, mem_dg_new),
                jnp.where(keep, prev_v, v_in),
                jnp.where(keep, prev_g, g),
                jnp.where(done, has_prev, jnp.logical_not(restart)),
                best,
                jnp.where(take, score, ret_score),
            )

        v0 = pack(z_x, z_u, l_x, l_u)
        astate = (
            jnp.int32(0), done0, v0, z_x, z_u,
            jnp.zeros((Bn, m_aa, D), dtype), jnp.zeros((Bn, m_aa, D), dtype),
            jnp.zeros((Bn, D), dtype), jnp.zeros((Bn, D), dtype),
            jnp.zeros(Bn, bool), jnp.full((Bn,), jnp.inf, dtype),
            jnp.full((Bn,), jnp.inf, dtype),
        )
        out = lax.while_loop(cond, abody, astate)
        x, u = out[3], out[4]
        return x, u

    return jax.jit(solve)
