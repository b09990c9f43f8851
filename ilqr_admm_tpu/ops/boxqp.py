"""Small box-constrained QP via projected Newton — the stage solver for
control-limited DDP (boxDDP).

Solves   min_u  (1/2) u^T H u + g^T u   s.t.  lb <= u <= ub
for strictly convex H of small dimension (control dims, m <= ~8), as a
fixed-iteration, branchless program so it jits, vmaps over batch/stage
axes, and runs inside `lax.scan` Riccati recursions.

The reference handles control bounds only through ADMM splitting
(`isls.py:379-501`); this kernel enables the *first-class* DP treatment
(Tassa, Mansard & Todorov, ICRA 2014: "Control-limited differential
dynamic programming"): per-stage box-QP in the backward pass, feedback
restricted to the free subspace, clipped forward rollouts.

Accelerator notes: every iteration is a masked m x m solve + an m-point
backtracking grid — all fixed shape; no data-dependent control flow.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ilqr_admm_tpu.utils.precision import highest_precision

# projected-Newton backtracking grid (fixed shape; cheap at small m)
_ALPHAS = (1.0, 0.5, 0.25, 0.1)


def _masked_solve(H, free, rhs):
    """Solve H_ff x_f = rhs_f on the free subspace; zeros on clamped dims.

    Builds M = F H F + (I - F) with F = diag(free) so the clamped rows
    decouple to the identity — one fixed-shape solve regardless of the
    active set (no gather/scatter, vmap/scan friendly). For m <= 4 the
    solve uses the closed-form adjugate inverse (`inv_small`) — no LU in
    the inner scan loop (same trick as the parallel Riccati's
    fast_inverse path).
    """
    from ilqr_admm_tpu.ops.parallel_riccati import inv_small

    m = H.shape[-1]
    F = free.astype(H.dtype)
    M = H * F[:, None] * F[None, :] + jnp.diag(1.0 - F)
    rhs_m = rhs * (F[:, None] if rhs.ndim == 2 else F)
    if m <= 4:
        x = inv_small(M) @ (rhs_m[:, None] if rhs.ndim == 1 else rhs_m)
        x = x[:, 0] if rhs.ndim == 1 else x
    else:
        x = jnp.linalg.solve(M, rhs_m)
    return x * (F[:, None] if rhs.ndim == 2 else F)


@highest_precision
def boxqp(H, g, lb, ub, u0=None, n_iters: int = 12, eps: float = 1e-9):
    """Projected-Newton box QP. Returns (u, free_mask (bool m,)).

    `free_mask` marks dimensions NOT clamped at a bound by the KKT test
    (at a bound with the gradient pushing outward); the boxDDP backward
    pass zeroes feedback on the clamped complement.
    """
    mdim = H.shape[-1]
    dtype = H.dtype
    lb = jnp.broadcast_to(jnp.asarray(lb, dtype), (mdim,))
    ub = jnp.broadcast_to(jnp.asarray(ub, dtype), (mdim,))
    u_init = jnp.zeros(mdim, dtype) if u0 is None else jnp.asarray(u0, dtype)
    u_init = jnp.clip(u_init, lb, ub)

    def obj(u):
        return 0.5 * u @ H @ u + g @ u

    def clamped_mask(u, grad):
        at_lo = (u <= lb + eps) & (grad > 0)
        at_hi = (u >= ub - eps) & (grad < 0)
        return at_lo | at_hi

    def step(u, _):
        grad = H @ u + g
        free = ~clamped_mask(u, grad)
        du = _masked_solve(H, free, -grad)
        cands = jnp.stack([jnp.clip(u + a * du, lb, ub) for a in _ALPHAS])
        vals = jax.vmap(obj)(cands)
        best = cands[jnp.argmin(vals)]
        u_new = jnp.where(vals.min() < obj(u), best, u)
        return u_new, None

    u, _ = lax.scan(step, u_init, None, length=n_iters)
    grad = H @ u + g
    free = ~clamped_mask(u, grad)
    return u, free


@highest_precision
def boxqp_enum(H, g, lb, ub, eps: float = 1e-7):
    """EXACT small box QP by KKT active-set enumeration.

    Every dimension is free, clamped-at-lb, or clamped-at-ub: 3^m cases.
    Each case is one masked solve on the free subspace plus a KKT check
    (free solution inside the box; clamped gradients pointing outward);
    the strictly convex objective makes the KKT-consistent case the
    unique optimum, selected branchlessly by masked argmin. All cases
    evaluate as ONE batched step instead of projected Newton's
    sequential iteration chain for small m (the boxDDP stage regime),
    and the answer is exact rather than iteratively approximate.

    Returns (u, free_mask) with `boxqp`-compatible semantics.

    `eps` is scale-relative: the KKT/box tests use
    `eps * (1 + max|g| + max|H|)` so f32 roundoff on ill-scaled Quu
    (the 'auto' m<=3 path of ilqr_backward_box runs this in f32)
    cannot reject every combo. If roundoff still rejects all 3^m cases,
    the fallback is the best *clipped* candidate by objective value —
    never a silent combo-0 (all-free) pick.
    """
    mdim = H.shape[-1]
    dtype = H.dtype
    lb = jnp.broadcast_to(jnp.asarray(lb, dtype), (mdim,))
    ub = jnp.broadcast_to(jnp.asarray(ub, dtype), (mdim,))

    combos = np.asarray(
        list(itertools.product((0, 1, 2), repeat=mdim)), dtype=np.int32
    )  # (3^m, m): 0 = free, 1 = at lb, 2 = at ub
    F = jnp.asarray(combos == 0)  # (K, m) free masks
    u_c = jnp.where(combos == 1, lb[None], 0.0) + jnp.where(
        combos == 2, ub[None], 0.0
    )
    u_c = u_c.astype(dtype)

    rhs = -(g[None] + u_c @ H.T)  # (K, m); H symmetric
    u_f = jax.vmap(_masked_solve, in_axes=(None, 0, 0))(H, F, rhs)
    Ff = F.astype(dtype)
    u = u_f * Ff + u_c * (1.0 - Ff)

    scale = 1.0 + jnp.max(jnp.abs(g)) + jnp.max(jnp.abs(H))
    tol = jnp.asarray(eps, dtype) * scale.astype(dtype)
    grad = u @ H.T + g[None]
    ok_free = jnp.where(F, (u >= lb[None] - tol) & (u <= ub[None] + tol), True)
    ok_lo = jnp.where(combos == 1, grad >= -tol, True)
    ok_hi = jnp.where(combos == 2, grad <= tol, True)
    feas = jnp.all(ok_free & ok_lo & ok_hi, axis=-1)

    u_clip = jnp.clip(u, lb[None], ub[None])
    obj_clip = 0.5 * jnp.einsum("ki,ij,kj->k", u_clip, H, u_clip) + u_clip @ g
    obj = jnp.where(feas, obj_clip, jnp.inf)
    # roundoff fallback: if no combo passes KKT, take the best clipped
    # candidate by objective instead of silently landing on combo 0
    best = jnp.where(jnp.any(feas), jnp.argmin(obj), jnp.argmin(obj_clip))
    return u_clip[best], F[best]
