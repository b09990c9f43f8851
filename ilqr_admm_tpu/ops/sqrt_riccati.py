"""Square-root (array-form) Riccati backward pass — f32-stable at stiff weights.

The standard Riccati recursion propagates the value Hessian V directly;
at the reference benchmarks' weight ratios (x_std/u_std up to 1e10, 3DoF
arm) V's condition exceeds f32 and the `Quu` Cholesky NaNs. The classical
*array algorithm* propagates a factor S with V = S S^T instead: each step
is one QR of the pre-array

        [ Cuu^{1/2}   0        ]            [ X11  X12 ]
    T = [ S^T B       S^T A    ]  ,  qr(T) =[ 0    X22 ]  (R factor)
        [ 0           Cxx^{1/2}]            [ 0    0   ]

whose R-factor blocks satisfy X11^T X11 = Quu, X11^T X12 = Qux and
X22^T X22 = V_new — so K = -X11^{-1} X12 by triangular solve and the new
factor is X22 directly. Condition numbers live on the *factors* (square
root of the Hessian's), which keeps the 1e10-ratio arm benchmark inside
f32 (factor cond ~1e5).

Cross terms Cux != 0 are handled by per-step completion of squares:
with M = Cuu^{-1} Cux, substituting u = u~ - M x gives an equivalent
problem with zero cross term — dynamics A_bar = A - B M, state cost
Cxx_bar = Cxx - Cux^T M (a Schur complement, PSD), cx_bar = cx - M^T cu
— and gains map back as K = K~ - M, k = k~. Requires Cuu > 0 (true
whenever the control penalty R is positive, as in every cost here;
the plain `riccati.ilqr_backward` needs only Quu > 0).

The linear (v, k) terms are propagated unfactored via the closed-loop
form v_new = cx + K^T cu + (A + B K)^T v, which is benign (no
factorization).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

from ilqr_admm_tpu.utils.precision import highest_precision


def _sqrt_psd(M):
    """Symmetric PSD square root (eigh-based; handles zero blocks)."""
    w, V = jnp.linalg.eigh(M)
    return V @ jnp.diag(jnp.sqrt(jnp.maximum(w, 0.0))) @ V.T


def _mm(a, b):
    """Exact-f32 small matmul: elementwise broadcast-multiply-sum.

    Independent of how the backend lowers small dot_generals (a
    reduced-precision pass adds noise to the backward's linear-term
    accumulation at the stiff arm weights). The expanded form is
    exact f32 and these blocks are tiny (d <= 9)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _mv(a, v):
    """Exact-f32 small matvec (see `_mm`)."""
    return jnp.sum(a * v[..., None, :], axis=-1)


def _qr_r(Ain):
    """Householder QR, R factor only, in plain elementwise f32.

    Independent of the backend's `jnp.linalg.qr` lowering, whose noise
    on the arm's stiff pre-arrays, accumulated over the scan, can stall
    the f32 arm solve above the optimum. Unrolled Householder with
    broadcast-multiply-sum updates is exact f32; the
    pre-arrays are tiny ((m + 2d) x (m + d)), so the static unroll over
    columns is cheap under jit."""
    Mrows, n = Ain.shape
    R = Ain
    dtype = Ain.dtype
    eps = jnp.asarray(jnp.finfo(dtype).tiny * 1e8, dtype)
    for j in range(n):
        x = R[j:, j]
        normx = jnp.sqrt(jnp.sum(x * x))
        # sign chosen to avoid cancellation; guard zero columns
        alpha = -jnp.sign(jnp.where(x[0] == 0, 1.0, x[0])) * normx
        v = x.at[0].add(-alpha)
        vnorm = jnp.sqrt(jnp.sum(v * v))
        v = jnp.where(vnorm > eps, v / jnp.maximum(vnorm, eps), jnp.zeros_like(v))
        # R[j:, j:] -= 2 v (v' R[j:, j:])  (rank-1, exact f32)
        tail = R[j:, j:]
        w = jnp.sum(v[:, None] * tail, axis=0)
        R = R.at[j:, j:].set(tail - 2.0 * v[:, None] * w[None, :])
    return jnp.triu(R[:n, :n])


def _solve_upper(U, rhs):
    """Unrolled upper-triangular solve U x = rhs, rhs (m, k).

    Independent of the backend's `solve_triangular` lowering; the
    unrolled back-substitution is exact f32. m is tiny
    (control dim), so the Python loop is fine under jit."""
    m = U.shape[0]
    rows = [None] * m
    for i in range(m - 1, -1, -1):
        acc = rhs[i]
        for j in range(i + 1, m):
            acc = acc - U[i, j] * rows[j]
        rows[i] = acc / U[i, i]
    return jnp.stack(rows, axis=0)


def _solve_lower(L, rhs):
    """Unrolled lower-triangular solve L x = rhs (see `_solve_upper`)."""
    m = L.shape[0]
    rows = [None] * m
    for i in range(m):
        acc = rhs[i]
        for j in range(i):
            acc = acc - L[i, j] * rows[j]
        rows[i] = acc / L[i, i]
    return jnp.stack(rows, axis=0)


@highest_precision
def ilqr_backward_sqrt(
    A: jax.Array,
    B: jax.Array,
    Cts: jax.Array,
    cts: jax.Array,
):
    """Array-form iLQR backward pass.

    Same (K, k) contract as `riccati.ilqr_backward`; per step one QR of a
    ((m + 2d) x (m + d)) pre-array instead of forming/factoring Quu.
    Nonzero Cux handled by completion of squares (requires Cuu > 0).
    """
    from jax.scipy.linalg import cho_factor, cho_solve

    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = jnp.result_type(A.dtype, Cts.dtype)
    A = A.astype(dtype)
    B = B.astype(dtype)
    Cts = Cts.astype(dtype)
    cts = cts.astype(dtype)

    # per-step cross-term elimination: M = Cuu^{-1} Cux
    def eliminate(Ct):
        Cxx, Cuu, Cux = Ct[:d, :d], Ct[d:, d:], Ct[d:, :d]
        M = cho_solve(cho_factor(0.5 * (Cuu + Cuu.T)), Cux)
        Cxx_bar = Cxx - Cux.T @ M
        return M, 0.5 * (Cxx_bar + Cxx_bar.T)

    Ms, Cxx_bar = jax.vmap(eliminate)(Cts)
    A_bar = A - jnp.einsum("tij,tjk->tik", B, Ms)
    cx_bar = cts[:, :d] - jnp.einsum("tji,tj->ti", Ms, cts[:, d:])

    Cxx_sqrt = jax.vmap(_sqrt_psd)(Cxx_bar)
    Cuu_sqrt = jax.vmap(_sqrt_psd)(Cts[:, d:, d:])

    # terminal value uses the raw state blocks: final-step gains are zero
    # by convention (u_{N-1} unused), so no elimination at step N-1
    S_term = _sqrt_psd(Cts[-1][:d, :d])  # V = S S^T
    v_term = cts[-1][:d]

    # Three-phase structure (precision/latency split):
    #   1. factor chain — sequential scan propagating S via the native
    #      `jnp.linalg.qr` X22 block (its FACTOR is accurate; only its
    #      gain extraction can be noisy), emitting S_{t+1} per step;
    #   2. gain extraction — the same pre-arrays re-factored by the
    #      exact-f32 Householder `_qr_r`, VMAPPED over all steps at once
    #      (independent given the S-chain): accuracy of the slow
    #      unrolled-in-scan variant at batched speed;
    #   3. linear chain — trivial sequential scan for (v, k) using the
    #      accurate gains (elementwise matvecs).

    def factor_step(S, inp):
        At, Bt, Cuu_h, Cxx_h = inp
        ST = S.T
        pre = jnp.concatenate(
            [
                jnp.concatenate([Cuu_h, jnp.zeros((m, d), dtype)], axis=1),
                jnp.concatenate([_mm(ST, Bt), _mm(ST, At)], axis=1),
                jnp.concatenate([jnp.zeros((d, m), dtype), Cxx_h], axis=1),
            ],
            axis=0,
        )
        R = jnp.linalg.qr(pre, mode="r")
        return R[m:, m:].T, pre  # S_new (factor: V_new = X22^T X22), pre

    xs_f = (A_bar[:-1], B[:-1], Cuu_sqrt[:-1], Cxx_sqrt[:-1])
    _, pres = lax.scan(factor_step, S_term, xs_f, reverse=True)

    def gains_one(pre):
        R = _qr_r(pre)
        X11 = R[:m, :m]
        X12 = R[:m, m:]
        Kt = -_solve_upper(X11, X12)
        return Kt, X11

    K_raw, X11s = jax.vmap(gains_one)(pres)

    def linear_step(v, inp):
        At, Bt, Kt, X11, cx, cu, Mt = inp
        qu = cu + _mv(Bt.T, v)
        kt = -_solve_upper(X11, _solve_lower(X11.T, qu[:, None]))[:, 0]
        v_new = cx + _mv(Kt.T, cu) + _mv((At + _mm(Bt, Kt)).T, v)
        # map gains back to original controls: u = u~ - M x
        return v_new, (Kt - Mt, kt)

    xs_l = (
        A_bar[:-1], B[:-1], K_raw, X11s, cx_bar[:-1], cts[:-1, d:], Ms[:-1],
    )
    _, (K, k) = lax.scan(linear_step, v_term, xs_l, reverse=True)
    K = jnp.concatenate([K, jnp.zeros((1, m, d), dtype)], axis=0)
    k = jnp.concatenate([k, jnp.zeros((1, m), dtype)], axis=0)
    return K, k
