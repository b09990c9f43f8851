"""Intersection and affine-preimage projections (inner ADMM / Dykstra).

Device-side equivalents of the reference's composite projections:
- `project_soc`              ⇔ `projections.py:163-234` — projection onto
  {z : Az + b ∈ SOC} by a bounded-iteration scaled ADMM.
- `project_set_convex`       ⇔ `projections.py:289-374` — consensus ADMM
  over a list of (A_i, b_i, P_i) constraint blocks with a prefactored
  (I + rho Σ A_i^T A_i)^{-1}.
- `project_set_convex_dykstra` ⇔ `projections.py:465-505` — Dykstra's
  alternating projection algorithm.

All three run as `lax.while_loop`s with a hard iteration cap and
residual / stall stopping, so they are safe inside an outer jitted ADMM
(the reference nests these inside its z-updates, `admm.py:49`).
Row-major batching: inputs are (..., dim) with independent leading axes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_admm_tpu.projections.primitives import project_soc_unit
from ilqr_admm_tpu.utils.precision import highest_precision

_EPS = 1e-30


@highest_precision
def project_soc(z0, A, b, rho: float = 1.0, max_iter: int = 100, tol: float = 1e-5):
    """Project z0 onto {z : A z + b in SOC} via scaled ADMM.

    z0: (..., dim); A: (m, dim); b: (m,). Returns the same shape as z0.
    """
    z0 = jnp.asarray(z0)
    single = z0.ndim == 1
    z0b = z0[None] if single else z0

    dim = z0b.shape[-1]
    l_side = jnp.eye(dim, dtype=z0b.dtype) + rho * A.T @ A
    l_inv = jnp.linalg.inv(l_side)

    def Az_b(z):
        return z @ A.T + b

    z_init = z0b
    lmb_init = jnp.zeros(z0b.shape[:-1] + (A.shape[0],), z0b.dtype)

    def cond(state):
        j, z, lmb, prim, dual, prev_prim, prev_dual = state
        converged = jnp.logical_and(prim < tol, dual < tol)
        stalled = jnp.logical_and(
            jnp.abs(prev_prim - prim) / (prev_prim + _EPS) < 1e-5,
            jnp.abs(prev_dual - dual) / (prev_dual + _EPS) < 1e-5,
        )
        return jnp.logical_and(j < max_iter, jnp.logical_not(jnp.logical_or(converged, stalled)))

    def body(state):
        j, z, lmb, prim, dual, _, _ = state
        x = project_soc_unit(Az_b(z) + lmb)
        z_new = (z0b + rho * (x - b - lmb) @ A) @ l_inv.T
        r = Az_b(z_new) - x
        lmb_new = lmb + r
        prim_new = jnp.max(jnp.linalg.norm(r, axis=-1))
        dual_new = jnp.max(rho * jnp.linalg.norm(z_new - z, axis=-1))
        return j + 1, z_new, lmb_new, prim_new, dual_new, prim, dual

    big = jnp.asarray(1e5, z0b.dtype)
    prev = jnp.asarray(1e10, z0b.dtype)  # != big so the stall check can't fire before iterating
    state = (jnp.int32(0), z_init, lmb_init, big, big, prev, prev)
    _, z, *_ = lax.while_loop(cond, body, state)
    return z[0] if single else z


@highest_precision
def project_set_convex(
    x0,
    As: Sequence[jax.Array] = (),
    bs: Sequence[jax.Array] = (),
    projections: Sequence[Callable] = (),
    rho: float = 1.0,
    max_iter: int = 200,
    threshold: float = 1e-4,
    stall_tol: float = 1e-5,
    verbose: bool = False,  # accepted for API parity; logging is host-side
):
    """Consensus-ADMM projection onto the intersection of constraint sets.

    Finds the point closest to x0 with A_i x + b_i in set_i for every i,
    where set_i is implied by projection P_i. x0: (..., dim).
    """
    del verbose
    x0 = jnp.asarray(x0)
    single = x0.ndim == 1
    x0b = x0[None] if single else x0
    nb = len(projections)
    if nb == 0:
        raise ValueError(
            "project_set_convex needs at least one (A, b, projection) "
            "constraint set"
        )
    if len(As) != nb or len(bs) != nb:
        raise ValueError(
            f"As ({len(As)}), bs ({len(bs)}) and projections ({nb}) must "
            "have equal lengths"
        )
    dim = x0b.shape[-1]

    As = [jnp.asarray(A, x0b.dtype) for A in As]
    bs = [jnp.asarray(b, x0b.dtype) for b in bs]

    l_side = jnp.eye(dim, dtype=x0b.dtype)
    for A in As:
        l_side = l_side + rho * (A.T @ A)
    l_inv = jnp.linalg.inv(l_side)

    z_init = tuple(x0b @ As[i].T + bs[i] for i in range(nb))
    lmb_init = tuple(jnp.zeros_like(z) for z in z_init)

    def cond(state):
        j, x, zs, lmbs, prim, dual, prev_prim, prev_dual = state
        converged = jnp.logical_and(prim < threshold, dual < threshold)
        stalled = jnp.logical_and(
            jnp.abs(prev_prim - prim) / (prev_prim + _EPS) < stall_tol,
            jnp.abs(prev_dual - dual) / (prev_dual + _EPS) < stall_tol,
        )
        return jnp.logical_and(j < max_iter, jnp.logical_not(jnp.logical_or(converged, stalled)))

    def body(state):
        j, x, zs, lmbs, prim, dual, _, _ = state
        r_side = jnp.zeros_like(x0b)
        for i in range(nb):
            r_side = r_side + (zs[i] - bs[i] - lmbs[i]) @ As[i]
        x_new = (x0b + rho * r_side) @ l_inv.T

        zs_new, lmbs_new = [], []
        prim_terms, dual_terms = [], []
        for i in range(nb):
            Ax_b = x_new @ As[i].T + bs[i]
            z_new = projections[i](Ax_b + lmbs[i])
            r = Ax_b - z_new
            lmbs_new.append(lmbs[i] + r)
            prim_terms.append(jnp.max(jnp.linalg.norm(r, axis=-1)))
            dual_terms.append(
                jnp.max(rho * jnp.linalg.norm((z_new - zs[i]) @ As[i], axis=-1))
            )
            zs_new.append(z_new)
        prim_new = jnp.max(jnp.stack(prim_terms))
        dual_new = jnp.max(jnp.stack(dual_terms))
        return j + 1, x_new, tuple(zs_new), tuple(lmbs_new), prim_new, dual_new, prim, dual

    big = jnp.asarray(1e5, x0b.dtype)
    prev = jnp.asarray(1e10, x0b.dtype)  # != big so the stall check can't fire before iterating
    state = (jnp.int32(0), x0b, z_init, lmb_init, big, big, prev, prev)
    _, x, *_ = lax.while_loop(cond, body, state)
    return x[0] if single else x


@highest_precision
def project_outside_rotated_boxes(
    p,
    As: jax.Array,
    bs: jax.Array,
    l: float = 1.0,
    max_steps: int = 8,
    viol_tol: float = 1e-6,
):
    """Exact projection onto the intersection of rotated-box *exteriors*.

    The car obstacle-avoidance constraint (reference `Car/Iterative LQR
    with state constraints on a maze.ipynb`, built from
    `project_square_batch` + `project_set_convex`, `projections.py:245-374`)
    keeps a position p outside every rotated rectangle
    {p : ||A_i p + b_i||_inf <= l}. The reference projects onto the
    intersection with consensus ADMM, which is only approximate at a
    bounded iteration count. This operator is EXACT for the benchmark
    geometry (pairwise-disjoint obstacles with non-overlapping dilations):

    - if p is feasible (outside every box) the projection is p itself;
    - otherwise p lies inside exactly one box i; the closest point
      outside box i is the single-coordinate push of `project_square`
      mapped through A_i (exact for orthogonal_scaled A_i); if that
      candidate is outside every other box it is the global projection
      (any feasible point is outside box i, and this is the nearest
      such point).

    The rare near-tangent case (candidate lands inside another box) is
    handled by repeating the most-violated-set projection up to
    `max_steps` times — feasibility is then guaranteed whenever the
    loop exits early, and the returned `exact` certificate says whether
    the one-step optimality argument applied.

    Args:
      p:  (..., d) points (batched over leading axes).
      As: (n_sets, d, d) per-box linear maps (rotation/scaling into the
          frame where the box is the unit inf-norm ball).
      bs: (n_sets, d) per-box offsets.
      l:  inf-norm radius of each box (reference uses 1.0).
      max_steps: cap on corrective projections.

    Returns:
      (proj, exact): proj (..., d); exact (...) bool — True where the
      result is certified to be the exact Euclidean projection.
    """
    p = jnp.asarray(p)
    single = p.ndim == 1
    x0 = p[None] if single else p
    As = jnp.asarray(As, x0.dtype)
    bs = jnp.asarray(bs, x0.dtype)
    Ainvs = jnp.linalg.inv(As)  # exact pullback of the per-box frame

    def to_frames(x):
        # (..., n_sets, d): y_i = A_i x + b_i
        return jnp.einsum("sij,...j->...si", As, x) + bs

    def violation(x):
        # depth inside each box: (l - ||y_i||_inf)_+  -> (..., n_sets)
        y = to_frames(x)
        return jnp.maximum(l - jnp.max(jnp.abs(y), axis=-1), 0.0)

    # world length of a unit step along frame axis i: the frame is an
    # anisotropic (scaled-rotation) map, so the cheapest exit axis is the
    # one minimizing h_i (l - |y_i|) in WORLD metric, not max |y_i|
    hs = jnp.linalg.norm(Ainvs, axis=-2)  # (n_sets, d) column norms

    def push_out(x, idx):
        # exact exterior projection w.r.t. box `idx` (one-hot gathered);
        # exact for scaled-rotation A_i (rectangle faces ⊥ frame axes)
        y = to_frames(x)  # (..., s, d)
        y_sel = jnp.take_along_axis(y, idx[..., None, None], axis=-2)[..., 0, :]
        h = hs[idx]  # (..., d)
        exit_cost = h * (l - jnp.abs(y_sel))
        j = jnp.argmin(exit_cost, axis=-1, keepdims=True)
        onehot = jnp.arange(y_sel.shape[-1]) == j
        sgn = jnp.where(y_sel >= 0, 1.0, -1.0)
        y_out = jnp.where(onehot, l * sgn, y_sel)
        Ainv = Ainvs[idx]  # (..., d, d)
        b_sel = bs[idx]
        return jnp.einsum("...ij,...j->...i", Ainv, y_out - b_sel)

    # pushes land exactly on a box boundary; the A^{-1}/A roundtrip leaves
    # O(eps) residual depth — only re-push on violations past viol_tol·l
    push_bar = viol_tol * l

    def body(state):
        k, x, pushes, _ = state
        v = violation(x)
        idx = jnp.argmax(v, axis=-1)
        x_new = push_out(x, idx)
        any_viol = jnp.any(v > push_bar, axis=-1)
        x = jnp.where(any_viol[..., None], x_new, x)
        pushes = pushes + any_viol.astype(jnp.int32)
        return k + 1, x, pushes, jnp.any(any_viol)

    def cond(state):
        k, _, _, active = state
        return jnp.logical_and(k < max_steps, active)

    pushes0 = jnp.zeros(x0.shape[:-1], jnp.int32)
    _, x, pushes, _ = lax.while_loop(
        cond, body, (jnp.int32(0), x0, pushes0, jnp.bool_(True))
    )

    # certificate: feasible now, at most one box contained p, and a
    # single push sufficed (the one-step optimality argument) — or p
    # was feasible to begin with (0 pushes).
    v0 = violation(x0)
    feasible_now = jnp.all(violation(x) <= push_bar, axis=-1)
    exact = jnp.logical_and(
        feasible_now,
        jnp.logical_and(jnp.sum(v0 > push_bar, axis=-1) <= 1, pushes <= 1),
    )

    if single:
        return x[0], exact[0]
    return x, exact


@highest_precision
def project_set_convex_dykstra(
    x0,
    projections: Sequence[Callable] = (),
    max_iter: int = 200,
    tol: float = 1e-4,
    verbose: bool = False,
):
    """Dykstra's alternating projection onto an intersection of convex sets.

    Unlike plain alternating projection, Dykstra converges to the true
    Euclidean projection. x0: (..., dim).
    """
    del verbose
    x0 = jnp.asarray(x0)
    single = x0.ndim == 1
    u0 = x0[None] if single else x0
    nb = len(projections)
    if nb == 0:
        raise ValueError(
            "project_set_convex_dykstra needs at least one projection"
        )

    z_init = tuple(jnp.zeros_like(u0) for _ in range(nb))

    def cond(state):
        k, u, zs, cI = state
        return jnp.logical_and(k < max_iter, jnp.any(cI >= tol))

    def body(state):
        k, u, zs, _ = state
        cI = jnp.zeros(u.shape[:-1], u.dtype)
        zs_new = list(zs)
        for i in range(nb):
            prev_u = u
            u = projections[i](prev_u - zs_new[i])
            prev_z = zs_new[i]
            zs_new[i] = u - (prev_u - prev_z)
            cI = cI + jnp.sum((prev_z - zs_new[i]) ** 2, axis=-1)
        return k + 1, u, tuple(zs_new), cI

    cI0 = jnp.full(u0.shape[:-1], 10.0, u0.dtype)
    state = (jnp.int32(0), u0, z_init, cI0)
    _, u, *_ = lax.while_loop(cond, body, state)
    return u[0] if single else u
