"""Constrained Riccati backward passes: first-class DP treatment of
stagewise control constraints (no ADMM splitting).

`ilqr_backward_box` is the boxDDP backward pass (Tassa/Mansard/Todorov,
ICRA 2014): each stage solves a box-QP over the control increment
(`ops/boxqp.py`), and the feedback gain is restricted to the free
subspace (rows clamped at a bound carry zero feedback). The reference
only reaches control limits through ADMM splitting (`isls.py:379-501`,
replicating Tassa's car example via projections); this is the direct DP
path SURVEY §7 / ROADMAP list as the remaining conic-DP capability —
see also PAPERS.md "Parallel Dynamic Programming for Conic Linear
Quadratic Control" (stagewise cones inside the DP recursion rather than
as an outer splitting).

Same conventions as `ops/riccati.py::ilqr_backward`: Cts (N, x+u, x+u)
Taylor Hessians, cts (N, x+u) gradients (the internal model is
c^T delta + (1/2) delta^T C delta), zero final-step gains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_admm_tpu.ops.boxqp import boxqp, boxqp_enum, _masked_solve
from ilqr_admm_tpu.utils.precision import highest_precision


def _sym(M):
    return 0.5 * (M + M.T)


@highest_precision
def ilqr_backward_box(
    A: jax.Array,
    B: jax.Array,
    Cts: jax.Array,
    cts: jax.Array,
    u_nom: jax.Array,
    u_lower,
    u_upper,
    reg: float | jax.Array = 0.0,
    qp_iters: int = 12,
    qp_method: str = "auto",
):
    """boxDDP backward pass: per-stage box-QP feedforward + free-subspace
    feedback.

    u_lower/u_upper: scalars or (m,) absolute control bounds; the QP is
    over the increment delta_u with bounds [u_lower - u_nom_t,
    u_upper - u_nom_t]. Returns (K (N,u,x), k (N,u)) with zero final-step
    gains; forward rollouts must clip u into [u_lower, u_upper]
    (`rollout_closed_loop_clipped`).

    qp_method: 'enum' solves each stage QP exactly by 3^m active-set
    enumeration in one batched step (`ops/boxqp.py::boxqp_enum`);
    'newton' runs `qp_iters` projected-Newton iterations; 'auto'
    (default) picks 'enum' for m <= 3 — the sequential Newton chain
    is the stage latency, and enumeration replaces it with one
    vectorized solve batch.
    """
    if qp_method not in ("auto", "enum", "newton"):
        raise ValueError(f"qp_method must be auto|enum|newton, got {qp_method!r}")
    d = A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    lo = jnp.broadcast_to(jnp.asarray(u_lower, dtype), (m,))
    hi = jnp.broadcast_to(jnp.asarray(u_upper, dtype), (m,))

    use_enum = qp_method == "enum" or (qp_method == "auto" and m <= 3)

    V_term = Cts[-1][:d, :d]
    v_term = cts[-1][:d]

    def step(carry, inp):
        V, v = carry
        At, Bt, Ct, ct, ut = inp
        Cxx = Ct[:d, :d]
        Cuu = Ct[d:, d:]
        Cux = Ct[d:, :d]
        cx = ct[:d]
        cu = ct[d:]

        qx = cx + At.T @ v
        qu = cu + Bt.T @ v
        Qxx = Cxx + At.T @ V @ At
        Qux = Cux + Bt.T @ V @ At
        Quu = _sym(Cuu + Bt.T @ V @ Bt + reg * jnp.eye(m, dtype=dtype))

        if use_enum:
            kt, free = boxqp_enum(Quu, qu, lo - ut, hi - ut)
        else:
            kt, free = boxqp(Quu, qu, lo - ut, hi - ut, n_iters=qp_iters)
        Kt = _masked_solve(Quu, free, -Qux)

        V_new = Qxx + Qux.T @ Kt + Kt.T @ Qux + Kt.T @ Quu @ Kt
        v_new = qx + Qux.T @ kt + Kt.T @ qu + Kt.T @ Quu @ kt
        return (V_new, v_new), (Kt, kt)

    xs = (A[:-1], B[:-1], Cts[:-1], cts[:-1], u_nom[:-1])
    _, (K, k) = lax.scan(step, (V_term, v_term), xs, reverse=True)
    K = jnp.concatenate([K, jnp.zeros((1, m, d), dtype)], axis=0)
    k = jnp.concatenate([k, jnp.zeros((1, m), dtype)], axis=0)
    return K, k


@highest_precision
def ilqr_backward_box_parallel(
    A: jax.Array,
    B: jax.Array,
    Cts: jax.Array,
    cts: jax.Array,
    u_nom: jax.Array,
    u_lower,
    u_upper,
    reg: float | jax.Array = 0.0,
    mask_iters: int = 3,
    clamp0=None,
    return_clamp: bool = False,
    mesh=None,
    mesh_axis: str = "time",
):
    """Time-parallel boxDDP backward pass: trajectory-wide active-set
    iteration where every pass is an associative scan (O(log N) depth).

    The exact box-QP recursion (`ilqr_backward_box`) is inherently
    sequential — each stage's clamped set depends on the cost-to-go.
    This variant solves the SAME clamped-subspace model by iterating an
    active-set exchange over the whole horizon at once:

    1. an unconstrained pass seeds, per stage, which control increments
       cross their box (clamp at the crossed bound);
    2. each clamped dim is frozen at its bound OFFSET c = bound - u_nom
       (nonzero for strictly-inside dims — the round-3 zero-offset
       freezing mis-modeled exactly those and plateaued above the
       optimum). The frozen controls become an affine dynamics drift
       d_t = B_t c_t (`ilqr_backward_parallel(drift=...)`) plus linear
       stage-cost shifts; the remaining free subspace is a standard
       parallel Riccati pass. Given the active set, this model is
       IDENTICAL to the sequential box-QP recursion's clamped-subspace
       model, so a mask fixed point reproduces `ilqr_backward_box`'s
       solution exactly;
    3. between passes the set is exchanged primal-dually at the masked
       solution: clamped dims release on a wrong-sign multiplier
       g_t = qu_t + Quu_t k_t (their KKT test; free dims have g = 0 by
       construction), free dims clamp when their step crosses a bound.

    `box_kkt_residual` provides the independent sequential certificate.
    The boxDDP line search + LM regularization schedule
    (solvers/boxddp.py) globalizes exactly as with the sequential pass.
    Returns (K (N,m,d), k (N,m)): k carries the bound offsets on clamped
    dims (like boxQP's solution), K is zero on clamped rows; forward
    rollouts clip as usual.

    The Jacobi-style exchange moves only a few set entries per pass
    (a set change at stage t invalidates the cost-to-go every EARLIER
    stage saw), so cold-started it needs many passes on heavily
    saturated problems. `clamp0=(clamp_lo, clamp_hi)` warm-starts the
    set — across boxDDP outer iterations the set stabilizes after a few
    outers, making 1-3 passes sufficient (solvers/boxddp.py carries it).
    `return_clamp=True` additionally returns the post-exchange set.

    mesh: a `jax.sharding.Mesh` distributes every pass's horizon over
    `mesh_axis` (`parallel/time_sharded.py::ilqr_backward_time_sharded`
    — one all_gather of O(P·d²) chunk totals per pass); the masked-model
    construction and the exchange are per-stage algebra and stay
    sharded. This is the pod-scale constrained backward.
    """
    from ilqr_admm_tpu.ops.parallel_riccati import ilqr_backward_parallel

    if mesh is not None:
        from ilqr_admm_tpu.parallel.time_sharded import (
            ilqr_backward_time_sharded,
        )

        def backward(A_, B_, Cts_, cts_, **kw):
            return ilqr_backward_time_sharded(
                A_, B_, Cts_, cts_, kw.pop("drift", None),
                mesh=mesh, axis=mesh_axis, **kw,
            )
    else:
        backward = ilqr_backward_parallel

    d = A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    lo = jnp.broadcast_to(jnp.asarray(u_lower, dtype), (m,))
    hi = jnp.broadcast_to(jnp.asarray(u_upper, dtype), (m,))

    # reg may be a traced scalar (the boxDDP LM schedule) — apply
    # unconditionally (zero adds nothing)
    Cts = Cts.at[:, d:, d:].add(
        jnp.asarray(reg, dtype) * jnp.eye(m, dtype=dtype)[None]
    )

    dlo = lo[None] - u_nom  # (N, m) increment bounds
    dhi = hi[None] - u_nom
    Cuu_full = Cts[:, d:, d:]
    Cux_full = Cts[:, d:, :d]
    cu_full = cts[:, d:]
    fast = d <= 4 and m <= 4  # adjugate inverses act on (d,d) combine
    # blocks AND (m,m) gain blocks (inv_small supports trailing dim <= 4)

    def masked_pass(clamp_lo, clamp_hi):
        clamp = clamp_lo | clamp_hi
        F = (~clamp).astype(dtype)
        c = jnp.where(clamp_lo, dlo, jnp.where(clamp_hi, dhi, 0.0))
        c = c.at[-1].set(0.0)  # terminal controls unused by convention

        # frozen increments -> affine drift + linear-cost shifts
        drift = jnp.einsum("tij,tj->ti", B, c)
        cu_eff = (cu_full + jnp.einsum("tij,tj->ti", Cuu_full, c)) * F
        cx_eff = cts[:, :d] + jnp.einsum("tji,tj->ti", Cux_full, c)

        B_eff = B * F[:, None, :]
        Cuu_eff = (
            Cuu_full * F[:, :, None] * F[:, None, :]
            + jnp.eye(m, dtype=dtype)[None] * (1.0 - F)[:, :, None]
        )
        Cts_eff = Cts.at[:, d:, d:].set(Cuu_eff)
        Cts_eff = Cts_eff.at[:, d:, :d].set(Cux_full * F[:, :, None])
        Cts_eff = Cts_eff.at[:, :d, d:].set(Cts[:, :d, d:] * F[:, None, :])
        cts_eff = jnp.concatenate([cx_eff, cu_eff], axis=-1)
        K, k, J, eta = backward(
            A, B_eff, Cts_eff, cts_eff, return_value=True, drift=drift,
            fast_inverse=fast,
        )
        return K * F[:, :, None], k * F + c, J, eta

    def exchange(clamp_lo, clamp_hi, k, J, eta):
        """Primal-dual active-set update at the masked solution.

        Batched over stages (no sequential dependence): the masked
        cost-to-go is the data, the update is per-stage algebra. Free
        dims satisfy g = 0 at the masked solution by construction, so
        the gradient test is only informative for CLAMPED dims (it is
        their multiplier estimate): release on wrong multiplier sign.
        Free dims clamp when their masked step crosses a bound.

        Also returns the total KKT violation of the masked solution
        (wrong-sign multiplier magnitudes on clamped dims + bound-crossing
        magnitudes on free dims) — the merit the vetted multi-exchange
        loop monitors; it is zero exactly at the active-set fixed point.
        """
        # broadcast-multiply-sum matmuls for the tiny batched products
        # (see parallel_riccati._bmm)
        bmm = lambda a, b: jnp.sum(a[..., :, :, None] * b[..., None, :, :], -2)
        Jn, etan = J[1:], eta[1:]  # V_{t+1} for t = 0..N-2
        BT = jnp.swapaxes(B[:-1], -1, -2)
        qu = cu_full[:-1] - jnp.sum(BT * etan[:, None, :], axis=-1)
        Quu = Cuu_full[:-1] + bmm(bmm(BT, Jn), B[:-1])
        g = qu + jnp.sum(Quu * k[:-1][:, None, :], axis=-1)
        g = jnp.concatenate([g, jnp.zeros((1, m), dtype)], axis=0)
        clamp = clamp_lo | clamp_hi
        new_lo = (clamp_lo & (g >= 0)) | (~clamp & (k <= dlo))
        new_hi = (clamp_hi & (g <= 0)) | (~clamp & (k >= dhi))
        viol = jnp.sum(jnp.where(clamp_lo, jnp.maximum(-g, 0.0), 0.0))
        viol = viol + jnp.sum(jnp.where(clamp_hi, jnp.maximum(g, 0.0), 0.0))
        viol = viol + jnp.sum(
            jnp.where(~clamp, jnp.maximum(dlo - k, 0.0)
                      + jnp.maximum(k - dhi, 0.0), 0.0)
        )
        # NaN -> +inf so a NaN pass (near-singular masked Quu under f32)
        # can never win the best-pass comparison NOR poison it: with a
        # NaN best, `viol < best` is always False and finite later
        # passes could never displace it
        viol = jnp.where(jnp.isnan(viol), jnp.inf, viol)
        return new_lo, new_hi, viol

    # seed from the warm-started set when given, else from the
    # unconstrained step; then iterate the exchange (each pass O(log N)).
    if clamp0 is None:
        _, k_unc = backward(A, B, Cts, cts, fast_inverse=fast)
        clamp_lo = k_unc <= dlo
        clamp_hi = k_unc >= dhi
    else:
        clamp_lo, clamp_hi = clamp0
    K, k, J, eta = masked_pass(clamp_lo, clamp_hi)
    prop_lo, prop_hi, viol = exchange(clamp_lo, clamp_hi, k, J, eta)
    # Vetted multi-exchange (mask_iters >= 2): the exchange iterates
    # UNVETTED (the KKT-violation merit is transiently non-monotone
    # along convergent exchange paths — rejecting on increase freezes
    # progress: measured 25/30 random cross-term problems stuck vs 0/30
    # free-running), but the RETURNED gains/warm-start set are those of
    # the lowest-violation pass seen, not the last. On a convergent
    # exchange viol -> 0 so best == last (bit-identical to the
    # free-running variant); if the f32 exchange cycles (observed on
    # heavily saturated problems at mask_iters >= 2), the caller gets
    # the least-violating member of the cycle instead of an arbitrary
    # phase, and the line search + carried warm set take it from there.
    best_K, best_k, best_viol = K, k, viol
    best_lo, best_hi = prop_lo, prop_hi
    for _ in range(max(1, mask_iters) - 1):
        K, k, J, eta = masked_pass(prop_lo, prop_hi)
        lo2, hi2, viol = exchange(prop_lo, prop_hi, k, J, eta)
        better = viol < best_viol
        best_K = jnp.where(better, K, best_K)
        best_k = jnp.where(better, k, best_k)
        best_lo = jnp.where(better, lo2, best_lo)
        best_hi = jnp.where(better, hi2, best_hi)
        best_viol = jnp.where(better, viol, best_viol)
        prop_lo, prop_hi = lo2, hi2
    if return_clamp:
        return best_K, best_k, (best_lo, best_hi)
    return best_K, best_k


@highest_precision
def box_kkt_residual(
    A: jax.Array,
    B: jax.Array,
    Cts: jax.Array,
    cts: jax.Array,
    u_nom: jax.Array,
    u_lower,
    u_upper,
    reg: float | jax.Array = 0.0,
    eps: float = 1e-6,
):
    """Sequential-backward KKT residual of a nominal trajectory.

    Runs the exact sequential box-QP recursion (`ilqr_backward_box`
    semantics, qp_method='enum'-grade V propagation) and measures how
    far the NOMINAL (delta_u = 0) is from each stage's box-QP optimality
    conditions given the constrained cost-to-go:

        free dims (strictly inside the box): |qu_t|
        dims at the lower bound:             max(0, -qu_t)
        dims at the upper bound:             max(0,  qu_t)

    Returns the max over all stages/dims — the certificate that an
    accepted solution (e.g. from the time-parallel backward) satisfies
    the sequential backward's KKT conditions. Zero iff the trajectory
    is a stationary point of the control-limited problem's DP model.
    """
    d = A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    lo = jnp.broadcast_to(jnp.asarray(u_lower, dtype), (m,))
    hi = jnp.broadcast_to(jnp.asarray(u_upper, dtype), (m,))
    tol = eps * (1.0 + jnp.maximum(jnp.abs(lo), jnp.abs(hi)))

    V_term = Cts[-1][:d, :d]
    v_term = cts[-1][:d]

    def step(carry, inp):
        V, v = carry
        At, Bt, Ct, ct, ut = inp
        Cxx = Ct[:d, :d]
        Cuu = Ct[d:, d:]
        Cux = Ct[d:, :d]
        cx = ct[:d]
        cu = ct[d:]

        qx = cx + At.T @ v
        qu = cu + Bt.T @ v
        Qxx = Cxx + At.T @ V @ At
        Qux = Cux + Bt.T @ V @ At
        Quu = _sym(Cuu + Bt.T @ V @ Bt + reg * jnp.eye(m, dtype=dtype))

        at_lo = ut <= lo + tol
        at_hi = ut >= hi - tol
        r = jnp.where(
            at_lo, jnp.maximum(0.0, -qu),
            jnp.where(at_hi, jnp.maximum(0.0, qu), jnp.abs(qu)),
        )

        kt, free = boxqp_enum(Quu, qu, lo - ut, hi - ut)
        Kt = _masked_solve(Quu, free, -Qux)
        V_new = Qxx + Qux.T @ Kt + Kt.T @ Qux + Kt.T @ Quu @ Kt
        v_new = qx + Qux.T @ kt + Kt.T @ qu + Kt.T @ Quu @ kt
        return (V_new, v_new), jnp.max(r)

    xs = (A[:-1], B[:-1], Cts[:-1], cts[:-1], u_nom[:-1])
    _, r = lax.scan(step, (V_term, v_term), xs, reverse=True)
    return jnp.max(r)


@highest_precision
def rollout_closed_loop_clipped(
    f,
    x0: jax.Array,
    K: jax.Array,
    k: jax.Array,
    x_nom: jax.Array,
    u_nom: jax.Array,
    u_lower,
    u_upper,
):
    """Clipped feedback rollout: u_t = clip(u_nom + k + K (x - x_nom), bounds).

    The clip is part of the boxDDP policy (not a post-hoc projection):
    feedback pushing past a bound saturates, matching the backward
    pass's clamped-subspace model. Returns (xs (N,x), us (N,u)).
    """
    dtype = K.dtype
    m = K.shape[-2]
    lo = jnp.broadcast_to(jnp.asarray(u_lower, dtype), (m,))
    hi = jnp.broadcast_to(jnp.asarray(u_upper, dtype), (m,))

    def step(x, inp):
        Kt, kt, xnt, unt = inp
        # expanded matvec: exact elementwise f32 (same rationale as
        # rollout_closed_loop — K rows reach 1e3-scale on stiff problems)
        u = jnp.clip(
            unt + kt + jnp.sum(Kt * (x - xnt)[None, :], axis=-1), lo, hi
        )
        return f(x, u), (x, u)

    _, (xs, us) = lax.scan(step, x0, (K, k, x_nom, u_nom))
    return xs, us
