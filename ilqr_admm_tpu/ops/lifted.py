"""Lifted causal response operators Sw, Su — scan-built and matrix-free.

The reference materializes dense `Sw = (I - Z A)^{-1}` and `Su = Sw Z B`
with an O(N) backward column construction (`base.py:98-119`). Here:

- `sw_x0`, `su_apply`, `su_t_apply` are *matrix-free* applications of the
  lifted operators as `lax.scan` rollouts / adjoint recursions — O(N d^2)
  and O(N) memory, the preferred path.
- `build_Sw` / `build_Su` materialize the dense operators (needed where
  the matrix itself is the object, e.g. SLS response-map synthesis); they
  are forward row recursions expressed as a single scan of small batched
  matmuls.

Conventions: A (N, x, x), B (N, x, u); trajectory x_0..x_{N-1} with
x_{t+1} = A_t x_t + B_t u_t; lifted vectors stack timesteps first.
Block (i, j) of Sw is A_{i-1}···A_j (I on the diagonal); block (i, j) of
Su is A_{i-1}···A_{j+1} B_j for i > j.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


from ilqr_admm_tpu.utils.precision import highest_precision

@highest_precision
def sw_x0(A: jax.Array, x0: jax.Array) -> jax.Array:
    """Free response Sw[:, :x_dim] @ x0 as a trajectory (N, x_dim).

    Equivalent to rolling x_{t+1} = A_t x_t from x0 (reference computes
    this as a dense matvec, `sls.py:80`).
    """
    N = A.shape[0]

    def step(x, At):
        return At @ x, x

    _, xs = lax.scan(step, x0, A)
    return xs


@highest_precision
def su_apply(A: jax.Array, B: jax.Array, us: jax.Array) -> jax.Array:
    """Su @ u as a trajectory: forced response from zero state.

    us: (N, u_dim) → (N, x_dim). x_0 = 0; x_{t+1} = A_t x_t + B_t u_t.
    """
    d = A.shape[-1]

    def step(x, inp):
        At, Bt, ut = inp
        return At @ x + Bt @ ut, x

    _, xs = lax.scan(step, jnp.zeros((d,), A.dtype), (A, B, us))
    return xs


@highest_precision
def su_t_apply(A: jax.Array, B: jax.Array, vs: jax.Array) -> jax.Array:
    """Adjoint Su^T @ v: (N, x_dim) → (N, u_dim).

    (Su^T v)_j = B_j^T p_{j+1} with the costate recursion
    p_t = v_t + A_t^T p_{t+1}, p_N = 0 — the backward-accumulation
    formulation of the dense transpose matvec.
    """
    d = A.shape[-1]

    def step(p, inp):
        At, Bt, vt = inp
        out = Bt.T @ p  # p here is p_{t+1}
        p_new = vt + At.T @ p
        return p_new, out

    _, outs = lax.scan(step, jnp.zeros((d,), A.dtype), (A, B, vs), reverse=True)
    return outs


@highest_precision
def build_Sx(A: jax.Array, p: int | None = None) -> jax.Array:
    """First p columns of Sw as stacked blocks: (N, x_dim, p).

    Sx[t] = A_{t-1} ··· A_0 restricted to the first p input columns
    (reference uses `Sw[:, :x_dim//2]` for robustness w.r.t. the initial
    position block, `sls.py:330`).
    """
    d = A.shape[-1]
    p = d if p is None else p
    M0 = jnp.eye(d, dtype=A.dtype)[:, :p]

    def step(M, At):
        return At @ M, M

    _, Ms = lax.scan(step, M0, A)
    return Ms


@highest_precision
def build_Sw(A: jax.Array) -> jax.Array:
    """Dense lifted Sw: (N*x, N*x). Row-block recursion as one scan."""
    N, d, _ = A.shape
    row0 = jnp.zeros((d, N * d), A.dtype).at[:, :d].set(jnp.eye(d, dtype=A.dtype))
    eye = jnp.eye(d, dtype=A.dtype)

    def step(carry, inp):
        row, t = carry
        At = inp
        new_row = At @ row
        blk = lax.dynamic_slice(new_row, (jnp.int32(0), t * d), (d, d)) + eye
        new_row = lax.dynamic_update_slice(new_row, blk, (jnp.int32(0), t * d))
        return (new_row, t + 1), new_row

    (_, _), rows = lax.scan(step, (row0, jnp.int32(1)), A[:-1])
    rows = jnp.concatenate([row0[None], rows], axis=0)  # (N, d, N*d)
    return rows.reshape(N * d, N * d)


def _build_Su_seq(A: jax.Array, B: jax.Array) -> jax.Array:
    """Sequential row-block recursion (one N-step scan)."""
    N, d, _ = A.shape
    m = B.shape[-1]
    row0 = jnp.zeros((d, N * m), A.dtype)

    def step(carry, inp):
        row, t = carry
        At, Bt = inp  # dynamics at step t-1
        new_row = At @ row
        blk = lax.dynamic_slice(new_row, (jnp.int32(0), (t - 1) * m), (d, m)) + Bt
        new_row = lax.dynamic_update_slice(new_row, blk, (jnp.int32(0), (t - 1) * m))
        return (new_row, t + 1), new_row

    (_, _), rows = lax.scan(step, (row0, jnp.int32(1)), (A[:-1], B[:-1]))
    rows = jnp.concatenate([row0[None], rows], axis=0)
    return rows.reshape(N * d, N * m)


def _pick_block(N: int) -> int:
    """Largest divisor of N not exceeding ~sqrt-scale (32)."""
    for L in (32, 25, 20, 16, 10, 8, 5, 4):
        if N % L == 0 and L < N:
            return L
    return 0


@highest_precision
def build_Su(A: jax.Array, B: jax.Array, block_size: int | None = None) -> jax.Array:
    """Dense lifted Su: (N*x, N*u); block (i, j) = A_{i-1}···A_{j+1} B_j.

    For long horizons the N-step sequential row recursion is scan-latency
    bound (and e.g. ilqr_admm rebuilds Su every outer iteration). The two-level blocked construction runs
    L + N/L sequential steps instead of N:

    - level 1 (one L-step scan, BATCHED over the N/L blocks): per block,
      the within-block local rows, the entry-to-row transitions
      G_i = A_{i-1}···A_{block start}, the block transition Phi, and the
      block-exit input response E;
    - level 2 (one N/L-step scan): propagate the block-entry state
      response S across blocks (S' = Phi S + E) and complete each row as
      G_i S + local.

    Exact up to fp reassociation (tested vs the sequential build).
    block_size=None picks a divisor of N near 32 and falls back to the
    sequential scan for short/indivisible horizons; 0 forces sequential.
    """
    N, d, _ = A.shape
    m = B.shape[-1]
    L = _pick_block(N) if block_size is None else block_size
    # auto-blocking only past N=256: on short horizons the blocked
    # build's two scans cost more than they save (GPU crossover: not
    # measured)
    if L <= 1 or N % L != 0 or (block_size is None and N <= 256) or N <= 64:
        return _build_Su_seq(A, B)
    P = N // L

    Ab = A.reshape(P, L, d, d)
    Bb = B.reshape(P, L, d, m)

    def level1(block):
        Ablk, Bblk = block  # (L, d, d), (L, d, m)

        def step(carry, inp):
            row, G, t = carry
            At, Bt = inp  # dynamics at local step t-1
            new_row = At @ row
            blk = lax.dynamic_slice(
                new_row, (jnp.int32(0), (t - 1) * m), (d, m)
            ) + Bt
            new_row = lax.dynamic_update_slice(
                new_row, blk, (jnp.int32(0), (t - 1) * m)
            )
            return (new_row, At @ G, t + 1), (new_row, At @ G)

        row0 = jnp.zeros((d, L * m), A.dtype)
        G0 = jnp.eye(d, dtype=A.dtype)
        (row_last, G_last, _), (rows_tail, G_tail) = lax.scan(
            step, (row0, G0, jnp.int32(1)), (Ablk[:-1], Bblk[:-1])
        )
        local = jnp.concatenate([row0[None], rows_tail], axis=0)  # (L, d, Lm)
        G = jnp.concatenate([G0[None], G_tail], axis=0)  # (L, d, d)
        # block exit: state after the block from in-block inputs, and
        # the full-block transition
        A_end, B_end = Ablk[-1], Bblk[-1]
        E = A_end @ row_last
        E = E.at[:, (L - 1) * m :].add(B_end)  # (d, Lm)
        Phi = A_end @ G_last  # (d, d)
        return local, G, Phi, E

    local, G, Phi, E = jax.vmap(level1)((Ab, Bb))

    # level 2: N/L sequential block steps (an associative-scan variant
    # was tried and measured SLOWER — its combines move full-width
    # (d, N*m) operands at every tree level, while this scan touches
    # each block's data once)
    def level2(S, inp):
        local_b, G_b, Phi_b, E_b, b = inp
        # rows of this block: entry response through G_i plus local part
        z = jnp.int32(0)  # literal 0s must match the traced index dtype
        R = jnp.einsum("lde,ef->ldf", G_b, S)  # (L, d, N*m)
        R = lax.dynamic_update_slice(
            R,
            lax.dynamic_slice(R, (z, z, b * (L * m)), (L, d, L * m)) + local_b,
            (z, z, b * (L * m)),
        )
        S_new = Phi_b @ S
        S_new = lax.dynamic_update_slice(
            S_new,
            lax.dynamic_slice(S_new, (z, b * (L * m)), (d, L * m)) + E_b,
            (z, b * (L * m)),
        )
        return S_new, R

    S0 = jnp.zeros((d, N * m), A.dtype)
    _, R = lax.scan(
        level2, S0, (local, G, Phi, E, jnp.arange(P, dtype=jnp.int32))
    )
    return R.reshape(N * d, N * m)
