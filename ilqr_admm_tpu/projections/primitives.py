"""Primitive Euclidean projection operators — branchless, batched, jit-safe.

Accelerator re-design of the reference projection catalog
(`isls/projections.py`): every operator is written with `jnp.where`
masks (no boolean indexing / data-dependent branches), works on a single
vector or any leading batch shape, and composes with `vmap`/`jit`.

Batch convention: the last axis is the vector dimension; all leading axes
are independent batch points (the reference's `_batch` variants,
`projections.py:30-162`, are subsumed — the same function handles both;
`_batch` aliases are kept for API parity).
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-30


def project_bound(x, l, u):
    """Box projection: l <= P(x) <= u (reference `projections.py:7-11`)."""
    return jnp.clip(x, l, u)


def project_linear(x, a, l, u):
    """Project x so that l <= a·x <= u (halfspace pair).

    Reference `projections.py:13-43`. Batched over leading axes of x.
    """
    x = jnp.asarray(x)
    a = jnp.asarray(a)
    aTx = jnp.sum(x * a, axis=-1, keepdims=True)
    aTa = jnp.sum(a * a, axis=-1, keepdims=True) + _EPS
    mu = jnp.where(aTx > u, aTx - u, jnp.where(aTx < l, aTx - l, 0.0))
    return x - mu * a / aTa


project_linear_batch = project_linear


def project_multilinear(x, A, l, u):
    """Clip Ax into [l, u] and pull back through A (boundary projection).

    Reference `projections.py:46-61` — lands on the boundary, not
    necessarily the least-norm point.
    """
    Ax = x @ A.T if x.ndim > 1 else A @ x
    tmp = jnp.clip(Ax, l, u)
    AAT_inv = jnp.linalg.inv(A @ A.T)
    mu = (Ax - tmp) @ AAT_inv.T
    return x - mu @ A


def project_affine(x, a, b, l, u):
    """Project x so that l <= a·x + b <= u (reference `projections.py:64-68`)."""
    return project_linear(x, a, l - b, u - b)


def project_quadratic(x, l, u):
    """Project onto the shell l <= 0.5 ||x||^2 <= u (annulus).

    Reference `projections.py:70-105`. Batched over leading axes.
    """
    x = jnp.asarray(x)
    val = 0.5 * jnp.sum(x * x, axis=-1, keepdims=True)
    nrm = jnp.linalg.norm(x, axis=-1, keepdims=True)
    hi = x * jnp.sqrt(2.0 * u) / (nrm + _EPS)  # val > u implies nrm > 0
    # inner-shell branch: x ~ 0 has no unique nearest point — pick the
    # first-coordinate direction deterministically instead of returning
    # the (infeasible) zero vector (the reference divides by ||x|| and
    # NaNs there; a commented-out random-perturbation hack at
    # `projections.py:101-102` shows the same problem)
    e1 = jnp.zeros_like(x).at[..., 0].set(1.0)
    dir_lo = jnp.where(nrm > 1e-12, x / (nrm + _EPS), e1)
    lo = dir_lo * jnp.sqrt(2.0 * l)
    return jnp.where(val > u, hi, jnp.where(val < l, lo, x))


project_quadratic_batch = project_quadratic


def project_quadratic_b(x, b, l, u):
    """Project so that l <= 0.5 x·x + b·x <= u (reference `projections.py:107-115`)."""
    z = x + b
    const = 0.5 * jnp.sum(jnp.asarray(b) ** 2)
    return project_quadratic(z, l + const, u + const) - b


def project_soc_unit(zt):
    """Second-order-cone projection of stacked [z, t]: onto ||z|| <= t.

    zt: (..., d+1) with z = zt[..., :-1], t = zt[..., -1]. Standard SOC
    projection (reference `projections.py:118-162`; the reference batch
    path zeroes the `t < 0, ||z|| > -t` case — here the mathematically
    correct scaling branch is used, per SURVEY §2 defect policy).
    """
    zt = jnp.asarray(zt)
    z = zt[..., :-1]
    t = zt[..., -1:]
    n = jnp.linalg.norm(z, axis=-1, keepdims=True)
    scale = 0.5 * (n + t) / (n + _EPS)
    z_out = jnp.where(n <= t, z, jnp.where(n <= -t, 0.0, scale * z))
    t_out = jnp.where(n <= t, t, jnp.where(n <= -t, 0.0, 0.5 * (n + t)))
    return jnp.concatenate([z_out, t_out], axis=-1)


def project_soc_unit_batch(z, t):
    """(z, t) interface of the SOC projection (reference `projections.py:140-162`)."""
    zt = jnp.concatenate([z, t[..., None]], axis=-1)
    out = project_soc_unit(zt)
    return out[..., :-1], out[..., -1]


def project_unit_ball(x):
    """Project into the unit ball (reference `projections.py:235-243`)."""
    n = jnp.linalg.norm(x, axis=-1, keepdims=True)
    return jnp.where(n <= 1.0, x, x / (n + _EPS))


def project_square(x, l, u):
    """Project onto the inf-norm shell l <= ||x||_inf <= u.

    Reference `projections.py:245-266`: push the largest-magnitude
    coordinate out to l if inside the inner box, then clip into [-u, u].
    """
    x = jnp.asarray(x)
    absx = jnp.abs(x)
    inf_norm = jnp.max(absx, axis=-1, keepdims=True)
    j = jnp.argmax(absx, axis=-1, keepdims=True)
    onehot = jnp.arange(x.shape[-1]) == j  # (..., d) bool
    sgn = jnp.where(x >= 0, 1.0, -1.0)
    pushed = jnp.where(onehot, l * sgn, x)
    z = jnp.where(inf_norm < l, pushed, x)
    return jnp.clip(z, -u, u)


project_square_batch = project_square


def project_square_c(x, c, l, u):
    """Inf-norm shell centered at c (reference `projections.py:268-275`)."""
    return project_square(x - c, l, u) + c


def project_block_lower_triangular(z, x_dim, u_dim, N):
    """Zero the block-diagonal rows enforcing strict causality.

    Reference `projections.py:277-282`: for each timestep i, zero
    z[i*u_dim, i*x_dim:(i+1)*x_dim].
    """
    z = jnp.asarray(z)
    rows = jnp.arange(z.shape[0])
    cols = jnp.arange(z.shape[1])
    row_t = rows // u_dim
    is_first = (rows % u_dim) == 0
    col_t = cols // x_dim
    mask = is_first[:, None] & (row_t[:, None] == col_t[None, :])
    return jnp.where(mask, 0.0, z)


def prox_l1(v, thresh):
    """Soft-thresholding: prox of thresh·‖·‖₁ (elementwise shrinkage).

    Not in the reference (its z-updates are all set projections); enables
    l1-regularized / sparse control à la "An ADMM Algorithm for Solving
    l1 Regularized MPC" (PAPERS.md): use as `project_u` with
    thresh = γ / (2·ρ_u) for a sparsity cost γ‖u‖₁ under this codebase's
    no-1/2 penalty convention (z-update solves
    min_z γ‖z‖₁ + ρ‖x̂ − z + λ‖²).
    """
    v = jnp.asarray(v)
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - thresh, 0.0)


def prox_l1_box(v, thresh, lower, upper):
    """Prox of thresh·‖·‖₁ + indicator of [lower, upper].

    Exact composition for separable scalars: the objective in each
    coordinate is convex/unimodal, so the box-constrained minimizer is
    the clip of the unconstrained soft-threshold.
    """
    return jnp.clip(prox_l1(v, thresh), lower, upper)


def project_weighted_l1(x, w, r):
    """Exact projection onto the weighted-l1 ball {v : Σ w_i |v_i| <= r}.

    Not in the reference. Closed form via the sorted-threshold algorithm
    (weighted-simplex projection, Held-Wolfe-Crowder): lambda* solves
    Σ_i w_i max(|x_i| - lambda w_i, 0) = r, piecewise-linear with
    breakpoints |x_i|/w_i; the valid segment is selected branchlessly
    over the descending sort. Batched over leading axes (projection acts
    on the LAST axis). This is the row set of the chance-constrained
    control-bounds construction, |du| + psi*sigma*|phi| <= bound (the
    intersection of the two SOCs in `examples/` / SURVEY §3.3), so it
    replaces an inner consensus-ADMM projection with an exact O(n log n)
    one — the XLA twin of the fused kernel's diamond z-update
    (`ops/pallas_sls.py::_diamond_project_slabs`).

    w: positive weights, broadcastable to x's last axis (a zero weight
    would make the set unbounded in that coordinate and the breakpoint
    division meaningless — rejected). r: scalar or batched radius
    (broadcastable to x's leading axes).
    """
    import numpy as _np

    w_arr = jnp.asarray(w, x.dtype)
    if isinstance(w, (list, tuple, _np.ndarray)) and not _np.all(
        _np.asarray(w, _np.float64) > 0.0
    ):
        raise ValueError(f"weights must be strictly positive, got {w}")
    w = jnp.broadcast_to(w_arr, x.shape)
    r = jnp.asarray(r, x.dtype)[..., None]
    a = jnp.abs(x)
    z = a / w  # breakpoints
    order = jnp.argsort(-z, axis=-1)
    z_s = jnp.take_along_axis(z, order, axis=-1)
    wa_s = jnp.take_along_axis(w * a, order, axis=-1)
    w2_s = jnp.take_along_axis(w * w, order, axis=-1)
    P_wa = jnp.cumsum(wa_s, axis=-1)
    P_w2 = jnp.cumsum(w2_s, axis=-1)
    lam_k = (P_wa - r) / P_w2
    # the valid k is the largest with z_s[k] > lam_k (support of lambda*)
    valid = z_s > lam_k
    k_star = jnp.sum(valid.astype(jnp.int32), axis=-1, keepdims=True) - 1
    lam = jnp.take_along_axis(lam_k, jnp.maximum(k_star, 0), axis=-1)
    lam = jnp.maximum(lam, 0.0)
    inside = jnp.sum(w * a, axis=-1, keepdims=True) <= r
    return jnp.where(inside, x, prox_l1(x, lam * w))


projections = {
    "SOC": project_soc_unit,
    "bound": project_bound,
    "linear": project_linear,
    "quadratic": project_quadratic,
    "square": project_square,
}
