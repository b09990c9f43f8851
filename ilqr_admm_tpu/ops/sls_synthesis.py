"""SLS response-map synthesis via a time-reversed Cholesky factorization.

The reference computes, for every timestep i, the inverse of the trailing
principal submatrix `l_side[i·u:, i·u:]` of the lifted normal matrix
`l_side = Su^T Q Su + R` through a Woodbury rank-downdate cascade
(`base.py:32-53`), then solves one feedback column block per timestep
(`sls.py:205-233`). That is a sequential chain of N dense inverses.

Batched redesign: the trailing principal submatrices of `l_side` are
the *leading* principal submatrices of the index-reversed matrix
`l_rev = l_side[::-1, ::-1]`. One Cholesky `Lr = chol(l_rev)` therefore
factors *all* N trailing systems at once: triangular forward substitution
with `Lr` restricted to the first s rows/cols is exactly the factor of
`l_rev[:s, :s]`. Each per-timestep solve becomes a pair of masked
triangular solves with the single shared factor — one O(M^3/3) Cholesky
plus batched triangular solves, instead of N sequential
Woodbury updates.

Masking argument (why one shared factor is sound):
- forward solve `Lr z = b` with `b` supported on rows < s yields
  `z[:s]` depending only on `Lr[:s, :s]` and `b[:s]`;
- zeroing `z[s:]` and back-solving `Lr^T y = z` yields `y[s:] = 0` and
  `y[:s]` equal to the leading-subsystem solution, because the trailing
  triangular subsystem has zero right-hand side.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


from ilqr_admm_tpu.utils.precision import highest_precision

@highest_precision
def causal_cholesky_factors(l_side: jax.Array) -> jax.Array:
    """Cholesky factor of the time-reversed normal matrix.

    Returns Lr lower-triangular with Lr Lr^T = l_side[::-1, ::-1].
    """
    l_rev = l_side[::-1, ::-1]
    return jnp.linalg.cholesky(l_rev)


@highest_precision
def causal_trailing_solve(
    Lr: jax.Array,
    rhs: jax.Array,
    starts: jax.Array,
) -> jax.Array:
    """Batched solve of trailing systems l_side[s_i:, s_i:] y = rhs_i[s_i:].

    Lr: (M, M) reversed Cholesky factor from `causal_cholesky_factors`.
    rhs: (nb, M, c) right-hand sides in *original* (unreversed) row order;
         rows < starts[i] of rhs_i are ignored.
    starts: (nb,) int — row offset s_i of each trailing system.

    Returns y (nb, M, c) in original row order with y[i, :starts[i]] = 0.
    """
    M = Lr.shape[0]
    rows = jnp.arange(M)

    def solve_one(b, s):
        # reverse rows; trailing rows [s:] map to leading rows [:M-s]
        b_rev = b[::-1]
        mask = (rows < (M - s)).astype(b.dtype)[:, None]
        z = solve_triangular(Lr, b_rev * mask, lower=True)
        y_rev = solve_triangular(Lr.T, z * mask, lower=False)
        return (y_rev * mask)[::-1]

    return jax.vmap(solve_one)(rhs, starts)


@highest_precision
def sls_synthesize(
    l_side: jax.Array,
    r_side_ff: jax.Array,
    r_side_fb: jax.Array,
    u_dim: int,
    x_dim: int,
):
    """Unconstrained SLS synthesis: feedforward du + causal feedback Phi_u.

    l_side:     (M, M) with M = N*u_dim — Su^T Q Su + R (+ regularizers).
    r_side_ff:  (M,)   — Su^T Q xd.
    r_side_fb:  (M, N*x_dim) — -Su^T Q Sw.

    Returns (PHI_U (M, N*x_dim), du (M,)). Equivalent to the reference
    `SLS.solve_sls` (`sls.py:205-233`) with the cascade replaced by the
    reversed-Cholesky batched solve.
    """
    M = l_side.shape[0]
    N = M // u_dim
    Lr = causal_cholesky_factors(l_side)

    # Feedforward: full system (start = 0).
    du = causal_trailing_solve(Lr, r_side_ff[None, :, None], jnp.zeros((1,), jnp.int32))[0, :, 0]

    # Feedback: one (M, x_dim) column block per timestep, trailing start i*u.
    rhs = r_side_fb.reshape(M, N, x_dim).transpose(1, 0, 2)  # (N, M, x_dim)
    starts = jnp.arange(N, dtype=jnp.int32) * u_dim
    cols = causal_trailing_solve(Lr, rhs, starts)  # (N, M, x_dim)
    PHI_U = cols.transpose(1, 0, 2).reshape(M, N * x_dim)
    return PHI_U, du
