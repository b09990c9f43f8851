"""Riccati backward passes as `lax.scan` recursions.

Device-side replacements for the reference's per-timestep Python loops:

- `lqt_backward`      ⇔ `SLS.solve_dp` (reference `sls.py:85-166`)
- `lqt_backward_ff`   ⇔ `SLS.solve_dp_ff` (reference `sls.py:168-202`) —
  the cheap linear re-sweep that is the hot inner step of DP-ADMM.
- `ilqr_backward`     ⇔ `iSLS.backward_pass_DP` (reference
  `isls.py:229-308`) — full iLQR Riccati with `Cux` cross terms.

Cost convention (matches reference `sls_base.py:25-44`, no 1/2):
    sum_t (x_t - xd_t)^T Q_t (x_t - xd_t) + u_t^T R_t u_t
ADMM regularizer terms add rho-weighted quadratics
    sum_t (x_t - xr_t)^T Qr_t (x_t - xr_t) + (u_t - ur_t)^T Rr_t (u_t - ur_t).

All passes leave the final-step gains at zero (K_{N-1} = 0, k_{N-1} = 0),
matching the reference recursion range `t = N-2 .. 0` (`sls.py:122`,
`isls.py:261`): u_{N-1} does not influence states inside the horizon.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_factor, cho_solve


from ilqr_admm_tpu.utils.precision import highest_precision

class DPGains(NamedTuple):
    """Feedback gains + cached quadratic-model blocks for fast re-sweeps.

    K: (N, u, x); k: (N, u); Quu / Quu_inv: (N, u, u); Qux: (N, u, x).
    Mirrors the `return_Qs=True` logs of the reference (`sls.py:117-164`).
    """

    K: jax.Array
    k: jax.Array
    Quu: jax.Array
    Quu_inv: jax.Array
    Qux: jax.Array


def _sym(M):
    return 0.5 * (M + M.T)


@highest_precision
def lqt_backward(
    A: jax.Array,
    B: jax.Array,
    Q: jax.Array,
    xd: jax.Array,
    R: jax.Array,
    Qr: Optional[jax.Array] = None,
    xr: Optional[jax.Array] = None,
    Rr: Optional[jax.Array] = None,
    ur: Optional[jax.Array] = None,
) -> DPGains:
    """LQT Riccati backward pass (no cross terms, per-step cost).

    A (N,x,x), B (N,x,u), Q (N,x,x), xd (N,x), R (N,u,u).
    Optional ADMM regularizers: Qr (N,x,x) with targets xr (N,x); Rr
    (N,u,u) with targets ur (N,u).
    Returns DPGains with all per-step blocks for `lqt_backward_ff`.
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    zQr = jnp.zeros((N, d, d), dtype) if Qr is None else Qr
    zxr = jnp.zeros((N, d), dtype) if xr is None else xr
    zRr = jnp.zeros((N, m, m), dtype) if Rr is None else Rr
    zur = jnp.zeros((N, m), dtype) if ur is None else ur

    V_term = 2.0 * Q[-1] + 2.0 * zQr[-1]
    v_term = -2.0 * Q[-1] @ xd[-1] - 2.0 * zQr[-1] @ zxr[-1]

    def step(carry, inp):
        V, v = carry
        At, Bt, Qt, xdt, Rt, Qrt, xrt, Rrt, urt = inp

        Cxx = 2.0 * Qt + 2.0 * Qrt
        Cuu = 2.0 * Rt + 2.0 * Rrt
        cx = -2.0 * Qt @ xdt - 2.0 * Qrt @ xrt
        cu = -2.0 * Rrt @ urt

        qx = cx + At.T @ v
        qu = cu + Bt.T @ v

        Qxx = Cxx + At.T @ V @ At
        Qux = Bt.T @ V @ At
        Quu = Cuu + Bt.T @ V @ Bt

        cf = cho_factor(_sym(Quu))
        sol = -cho_solve(cf, jnp.concatenate([Qux, qu[:, None]], axis=-1))
        Kt = sol[:, :-1]
        kt = sol[:, -1]
        Quu_inv = cho_solve(cf, jnp.eye(Quu.shape[0], dtype=Quu.dtype))

        V_new = Qxx + Qux.T @ Kt + Kt.T @ Qux + Kt.T @ Quu @ Kt
        v_new = qx + Qux.T @ kt + Kt.T @ qu + Kt.T @ Quu @ kt
        return (V_new, v_new), (Kt, kt, Quu, Quu_inv, Qux)

    xs = (A[:-1], B[:-1], Q[:-1], xd[:-1], R[:-1], zQr[:-1], zxr[:-1], zRr[:-1], zur[:-1])
    _, (K, k, Quu, Quu_inv, Qux) = lax.scan(step, (V_term, v_term), xs, reverse=True)

    pad = lambda arr, tail: jnp.concatenate([arr, tail[None]], axis=0)
    return DPGains(
        K=pad(K, jnp.zeros((m, d), dtype)),
        k=pad(k, jnp.zeros((m,), dtype)),
        Quu=pad(Quu, jnp.zeros((m, m), dtype)),
        Quu_inv=pad(Quu_inv, jnp.zeros((m, m), dtype)),
        Qux=pad(Qux, jnp.zeros((m, d), dtype)),
    )


@highest_precision
def lqt_backward_ff(
    gains: DPGains,
    A: jax.Array,
    B: jax.Array,
    Q: jax.Array,
    xd: jax.Array,
    Qr: Optional[jax.Array] = None,
    xr: Optional[jax.Array] = None,
    Rr: Optional[jax.Array] = None,
    ur: Optional[jax.Array] = None,
) -> jax.Array:
    """Feedforward-only re-sweep with cached Quu/Quu_inv/Qux/K.

    Used by DP-ADMM where only the linear cost terms change between ADMM
    iterations (reference `sls.py:168-202`). Returns k (N, u).
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    zQr = jnp.zeros((N, d, d), dtype) if Qr is None else Qr
    zxr = jnp.zeros((N, d), dtype) if xr is None else xr
    zRr = jnp.zeros((N, m, m), dtype) if Rr is None else Rr
    zur = jnp.zeros((N, m), dtype) if ur is None else ur

    v_term = -2.0 * Q[-1] @ xd[-1] - 2.0 * zQr[-1] @ zxr[-1]

    def step(v, inp):
        At, Bt, Qt, xdt, Qrt, xrt, Rrt, urt, Kt, Quut, Quu_invt, Quxt = inp
        cx = -2.0 * Qt @ xdt - 2.0 * Qrt @ xrt
        cu = -2.0 * Rrt @ urt
        qx = cx + At.T @ v
        qu = cu + Bt.T @ v
        kt = -Quu_invt @ qu
        v_new = qx + Quxt.T @ kt + Kt.T @ qu + Kt.T @ Quut @ kt
        return v_new, kt

    xs = (
        A[:-1], B[:-1], Q[:-1], xd[:-1], zQr[:-1], zxr[:-1], zRr[:-1], zur[:-1],
        gains.K[:-1], gains.Quu[:-1], gains.Quu_inv[:-1], gains.Qux[:-1],
    )
    _, ks = lax.scan(step, v_term, xs, reverse=True)
    return jnp.concatenate([ks, jnp.zeros((1, m), dtype)], axis=0)


@highest_precision
def ilqr_backward(
    A: jax.Array,
    B: jax.Array,
    Cts: jax.Array,
    cts: jax.Array,
    reg: float | jax.Array = 0.0,
    fzz: jax.Array | None = None,
):
    """General iLQR Riccati backward pass over a quadratic cost model.

    Cts: (N, x+u, x+u) full Hessians (Cxx, Cuu, Cux blocks used);
    cts: (N, x+u) gradients — the `get_Cs` Taylor-expansion interface of
    the reference (`isls.py:229-308`). `reg` adds Levenberg-style
    regularization to Quu. Returns (K, k) with zero final-step gains.

    fzz: optional (N, d, d+m, d+m) stage dynamics Hessians — FULL DDP
    (Tassa et al. 2012), beyond the reference's Gauss-Newton iLQR
    (`isls.py:229-308` drops these terms): the stage quadratic model
    gains sum_i v'_i (f_i)_zz with v' the next-stage value gradient,
    contracted inside the scan step (the gradient is only known there).
    Hessians are symmetric per output row, so the Cux block comes from
    the lower-left of the contraction.
    """
    d = A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    V_term = Cts[-1][:d, :d]
    v_term = cts[-1][:d]

    def step(carry, inp):
        V, v = carry
        if fzz is None:
            At, Bt, Ct, ct = inp
            T = None
        else:
            At, Bt, Ct, ct, ft = inp
            # DDP term: contract next-stage value gradient with the
            # dynamics Hessian (one small einsum per step).
            T = jnp.einsum("i,ijk->jk", v, ft)
        Cxx = Ct[:d, :d]
        Cuu = Ct[d:, d:]
        Cux = Ct[d:, :d]
        cx = ct[:d]
        cu = ct[d:]

        qx = cx + At.T @ v
        qu = cu + Bt.T @ v
        Qxx = Cxx + At.T @ V @ At
        Qux = Cux + Bt.T @ V @ At
        Quu = Cuu + Bt.T @ V @ Bt + reg * jnp.eye(m, dtype=dtype)
        if T is not None:
            Qxx = Qxx + T[:d, :d]
            Qux = Qux + T[d:, :d]
            Quu = Quu + T[d:, d:]

        cf = cho_factor(_sym(Quu))
        sol = -cho_solve(cf, jnp.concatenate([Qux, qu[:, None]], axis=-1))
        Kt = sol[:, :-1]
        kt = sol[:, -1]

        V_new = Qxx + Kt.T @ Quu @ Kt + Qux.T @ Kt + Kt.T @ Qux
        v_new = qx + Kt.T @ qu + Kt.T @ Quu @ kt + Qux.T @ kt
        return (V_new, v_new), (Kt, kt)

    if fzz is None:
        xs = (A[:-1], B[:-1], Cts[:-1], cts[:-1])
    else:
        xs = (A[:-1], B[:-1], Cts[:-1], cts[:-1], fzz[:-1])
    _, (K, k) = lax.scan(step, (V_term, v_term), xs, reverse=True)
    K = jnp.concatenate([K, jnp.zeros((1, m, d), dtype)], axis=0)
    k = jnp.concatenate([k, jnp.zeros((1, m), dtype)], axis=0)
    return K, k


@highest_precision
def quad_cost_model(Q, xd, R, x_nom, u_nom):
    """Build (cts, Cts) Taylor blocks of the quadratic cost around a nominal.

    Reproduces the delta-coordinate expansion the reference builds inline
    (`isls.py:263-271`): Cxx = 2Q, Cuu = 2R, Cux = 0,
    cx = 2Q(x_nom - xd), cu = 2R u_nom.
    """
    N, d = Q.shape[0], Q.shape[-1]
    m = R.shape[-1]
    dtype = Q.dtype
    Cts = jnp.zeros((N, d + m, d + m), dtype)
    Cts = Cts.at[:, :d, :d].set(2.0 * Q)
    Cts = Cts.at[:, d:, d:].set(2.0 * R)
    cx = 2.0 * jnp.einsum("tij,tj->ti", Q, x_nom - xd)
    cu = 2.0 * jnp.einsum("tij,tj->ti", R, u_nom)
    cts = jnp.concatenate([cx, cu], axis=-1)
    return cts, Cts
