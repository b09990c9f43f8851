"""Parallel (associative-scan) Riccati recursion — time-axis parallelism.

The sequential Riccati backward pass is O(N) dependent steps. Following
the temporal-parallelization of dynamic programming (Särkkä &
García-Fernández; PAPERS.md "The Parallelization of Riccati Recursion"),
the LQT value functions are computed with `lax.associative_scan` in
O(log N) parallel depth: each element represents a *conditional* value
function between two timesteps,

    V(x, z) = min_u { cost } parametrized by (A, b, C, eta, J):
    z = A x + b + C-dual,  value-at-x part (J, eta),

and composition (eliminating the middle state) is associative:

    M  = (I + C1 J2)^{-1}
    A  = A2 M A1
    b  = A2 M (b1 + C1 eta2) + b2
    C  = A2 M C1 A2^T + C2
    eta = A1^T M^T (eta2 - J2 b1) + eta1
    J  = A1^T M^T J2 A1 + J1

This is the genuine "sequence parallelism" of this problem domain
(SURVEY §5): for long horizons / small batches the scan's O(N) latency is
replaced by O(log N) rounds of batched d×d solves.

Produces the same `DPGains` as `riccati.lqt_backward` (value functions →
per-step gain extraction is embarrassingly parallel).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_factor, cho_solve

from ilqr_admm_tpu.ops.riccati import DPGains


from ilqr_admm_tpu.utils.precision import highest_precision

def _minor_det(M, r, c, n):
    """Determinant of the (n-1)x(n-1) minor of batched (..., n, n) M with
    row r / column c removed (compile-time-unrolled cofactor expansion)."""
    rows = [i for i in range(n) if i != r]
    cols = [j for j in range(n) if j != c]
    k = n - 1
    if k == 0:
        return jnp.ones(M.shape[:-2], M.dtype)
    if k == 1:
        return M[..., rows[0], cols[0]]
    if k == 2:
        return (
            M[..., rows[0], cols[0]] * M[..., rows[1], cols[1]]
            - M[..., rows[0], cols[1]] * M[..., rows[1], cols[0]]
        )
    # k == 3: expand along the first remaining row
    a, b, c3 = (M[..., rows[0], cols[j]] for j in range(3))
    d1, e, f = (M[..., rows[1], cols[j]] for j in range(3))
    g, h, i_ = (M[..., rows[2], cols[j]] for j in range(3))
    return a * (e * i_ - f * h) - b * (d1 * i_ - f * g) + c3 * (d1 * h - e * g)


def inv_small(M):
    """Closed-form (adjugate) batched inverse for trailing dim <= 4.

    No LU inside scan loops, at adjugate accuracy: relative error ~ eps * cond(M) in f32 — use
    only when cond(M) ≲ 1e4 (LU keeps ~eps * cond^0.5-1 with pivoting).
    A per-matrix scalar scaling guards the determinant against f32
    overflow without changing the cancellation structure.
    """
    n = M.shape[-1]
    if n > 4:
        raise ValueError(f"inv_small supports trailing dim <= 4, got {n}")
    if n == 1:
        return 1.0 / M
    s = jnp.max(jnp.abs(M), axis=(-2, -1), keepdims=True)
    Mh = M / s
    # adj[i, j] = (-1)^{i+j} minor_det(j, i)  (transposed cofactors)
    adj = jnp.stack(
        [
            jnp.stack(
                [((-1.0) ** (r + c)) * _minor_det(Mh, r, c, n) for r in range(n)],
                axis=-1,
            )
            for c in range(n)
        ],
        axis=-2,
    )
    det = sum(Mh[..., 0, j] * adj[..., j, 0] for j in range(n))
    return adj / det[..., None, None] / s


def _bmm(a, b):
    """Batched tiny matmul as a broadcast-multiply-sum (exact f32).

    For trailing dims <= 4 the surrounding program traces under
    default_matmul_precision('highest'), and XLA can lower tiny batched
    HIGHEST matmuls pathologically; the expanded form is exact f32
    elementwise code. (GPU comparison against `dot_general`: not
    measured.)
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _combine(e1, e2, fast_inverse: bool = False):
    """Associative composition of conditional-value-function elements.

    e1 covers the earlier interval, e2 the later one (both pytrees of
    stacked leading-batch arrays).
    """
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    d = A1.shape[-1]
    I = jnp.eye(d, dtype=A1.dtype)
    mm = _bmm if d <= 4 else (lambda a, b: a @ b)

    # M = (I + C1 J2)^{-1}; LU solve by default, closed-form adjugate
    # (`inv_small`) when fast_inverse — 3.4x faster combines, adjugate
    # accuracy envelope (see inv_small docstring).
    if fast_inverse:
        M = inv_small(I + mm(C1, J2))
    else:
        M = jnp.linalg.solve(I + mm(C1, J2), I)
    A2M = mm(A2, M)
    MT = jnp.swapaxes(M, -1, -2)
    A1T = jnp.swapaxes(A1, -1, -2)

    A = mm(A2M, A1)
    b = mm(A2M, b1[..., None] + mm(C1, eta2[..., None]))[..., 0] + b2
    C = mm(mm(A2M, C1), jnp.swapaxes(A2, -1, -2)) + C2
    eta = mm(A1T, mm(MT, eta2[..., None] - mm(J2, b1[..., None])))[..., 0] + eta1
    J = mm(A1T, mm(MT, mm(J2, A1))) + J1
    return (A, b, C, eta, J)


def _blocked_suffix_scan(combine, identity, elems, N, block_size):
    """Inclusive suffix scan result[t] = e_t ∘ e_{t+1} ∘ … ∘ e_{N-1} via a
    two-level blocked algorithm: O(N) total combines (vs the associative
    scan's O(N log N)) with all the sequential steps batched block-wide.

    combine(earlier, later) must broadcast over leading batch dims;
    identity(shape_prefix) builds identity elements. elems: pytree tuple
    of (N, ...) arrays. Returns the same pytree of (N, ...) arrays.

    Level 1: within each of nb = ceil(N/L) blocks, a reverse sequential
    scan of depth L where each step is an (nb,)-batched combine.
    Level 2: an exclusive reverse scan over the nb block totals (depth
    nb, single-element combines). Finish: one batched combine joining
    every local suffix with its block's exclusive suffix.
    """
    L = block_size
    nb = -(-N // L)
    pad = nb * L - N

    def pad_elem(x, ident_x):
        if pad == 0:
            return x
        tail = jnp.broadcast_to(ident_x, (pad,) + x.shape[1:])
        return jnp.concatenate([x, tail], axis=0)

    ident1 = identity(())
    elems = tuple(
        pad_elem(x, ix) for x, ix in zip(elems, ident1)
    )
    # (N_pad, ...) -> (L, nb, ...): block-major rows, scan over the L axis
    by_j = tuple(
        jnp.moveaxis(x.reshape((nb, L) + x.shape[1:]), 0, 1) for x in elems
    )

    def step(carry, ej):
        out = combine(ej, carry)  # e_j ∘ (suffix of later js)
        return out, out

    _, r = lax.scan(step, identity((nb,)), by_j, reverse=True)  # (L, nb, ...)

    totals = tuple(x[0] for x in r)  # suffix of whole block, per block

    def step2(carry, ti):
        return combine(ti, carry), carry  # emit EXCLUSIVE suffix

    _, S = lax.scan(step2, identity(()), totals, reverse=True)  # (nb, ...)

    res = combine(r, S)  # broadcast (L, nb, ...) against (nb, ...)
    out = tuple(
        jnp.moveaxis(x, 0, 1).reshape((nb * L,) + x.shape[2:])[:N] for x in res
    )
    return out


def _identity_elems(prefix, d, dtype):
    """Monoid identity of `_combine`: (I, 0, 0, 0, 0) — combine(e, id) =
    combine(id, e) = e (checked both ways against the formulas above)."""
    I = jnp.broadcast_to(jnp.eye(d, dtype=dtype), prefix + (d, d))
    z_m = jnp.zeros(prefix + (d, d), dtype)
    z_v = jnp.zeros(prefix + (d,), dtype)
    return (I, z_v, z_m, z_v, z_m)


def lqt_backward_parallel(
    A: jax.Array,
    B: jax.Array,
    Q: jax.Array,
    xd: jax.Array,
    R: jax.Array,
    Qr: Optional[jax.Array] = None,
    xr: Optional[jax.Array] = None,
    Rr: Optional[jax.Array] = None,
    ur: Optional[jax.Array] = None,
    block_size: Optional[int] = None,
    fast_inverse: bool = False,
) -> DPGains:
    """LQT Riccati via associative scan. Same contract as `lqt_backward`.

    fast_inverse=True replaces the combine's LU solve with the
    closed-form adjugate `inv_small` — cheaper combines (the end-to-end
    gain on the GPU is not measured), at adjugate accuracy (rel err ~
    eps * cond(I + C J); fine for moderately-weighted problems, avoid
    at extreme stiffness).

    block_size=None runs a flat `lax.associative_scan` (O(log N) depth,
    O(N log N) combines — best at short/moderate horizons). With
    block_size=L it runs the two-level blocked scan (`_blocked_suffix_scan`):
    O(N) combines with the L sequential level-1 steps batched over the
    N/L blocks — the right shape for long horizons, where the flat scan's
    N log N work at HIGHEST precision loses to even the sequential scan.

    Jitted with (block_size, fast_inverse) static: the combinator emits
    hundreds of small ops that eager dispatch pays one-by-one (measured
    4x slower first call and 600x slower repeats than the jitted
    program at N=33 on CPU)."""
    if block_size is not None and (
        isinstance(block_size, bool) or not isinstance(block_size, int) or block_size < 1
    ):
        raise ValueError(f"block_size must be a positive int, got {block_size!r}")
    if fast_inverse and A.shape[-1] > 4:
        raise ValueError(
            f"fast_inverse=True uses the closed-form adjugate inverse, which "
            f"supports state dim <= 4 (got d={A.shape[-1]}); use the default "
            "LU combine for larger states"
        )
    return _lqt_backward_parallel_impl(
        A, B, Q, xd, R, Qr, xr, Rr, ur,
        block_size=block_size, fast_inverse=fast_inverse,
    )


@functools.partial(jax.jit, static_argnames=("block_size", "fast_inverse"))
@highest_precision
def _lqt_backward_parallel_impl(
    A, B, Q, xd, R, Qr, xr, Rr, ur, *, block_size, fast_inverse
) -> DPGains:
    elems, U, s = value_elements(
        A, B, Q, xd, R, Qr=Qr, xr=xr, Rr=Rr, ur=ur, fast_inverse=fast_inverse
    )
    N, d = A.shape[0], A.shape[-1]
    dtype = A.dtype

    # inclusive reverse scan: result[t] = e_t ⊗ e_{t+1} ⊗ ... ⊗ e_{N-1}
    comb = functools.partial(_combine, fast_inverse=fast_inverse)
    if block_size is None:
        comb_v = jax.vmap(comb)
        scanned = lax.associative_scan(
            lambda a, b: comb_v(b, a), elems, reverse=True
        )
    else:
        scanned = _blocked_suffix_scan(
            comb, lambda p: _identity_elems(p, d, dtype),
            elems, N, block_size,
        )
    return gains_from_scanned(A, B, U, s, scanned, fast_inverse=fast_inverse)


def value_elements(
    A, B, Q, xd, R, Qr=None, xr=None, Rr=None, ur=None,
    fast_inverse: bool = False,
):
    """Conditional-value-function elements (A, b, C, eta, J) for the
    parallel Riccati scan, plus the control Hessians/targets (U, s)
    needed for gain extraction. Shared by the single-device scans and
    the mesh time-sharded path (`parallel/time_sharded.py`).

    fast_inverse swaps the batched (N, m, m) LU solves for the adjugate
    `inv_small` (m <= 4) — at N=10k this construction is LU-bound."""
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype

    zQr = jnp.zeros((N, d, d), dtype) if Qr is None else Qr
    zxr = jnp.zeros((N, d), dtype) if xr is None else xr
    zRr = jnp.zeros((N, m, m), dtype) if Rr is None else Rr
    zur = jnp.zeros((N, m), dtype) if ur is None else ur

    X = 2.0 * Q + 2.0 * zQr  # (N, d, d) state-cost Hessians
    eta_all = 2.0 * jnp.einsum("tij,tj->ti", Q, xd) + 2.0 * jnp.einsum(
        "tij,tj->ti", zQr, zxr
    )
    U = 2.0 * R + 2.0 * zRr  # (N, m, m) control-cost Hessians
    s = 2.0 * jnp.einsum("tij,tj->ti", zRr, zur)  # linear control targets
    return value_elements_general(A, B, X, eta_all, U, s, fast_inverse=fast_inverse)


def value_elements_general(
    A, B, X, eta_all, U, s, fast_inverse: bool = False, drift=None
):
    """Scan elements from a general stage-quadratic model (no cross terms):

        cost_t = (1/2) x' X_t x - eta_t' x + (1/2) u' U_t u - s_t' u

    (i.e. eta = -cx, s = -cu in the `get_Cs` Taylor convention). The
    LQT entry point `value_elements` reduces to this with
    eta = 2 Q xd + 2 Qr xr, s = 2 Rr ur.

    drift: optional (N, d) affine dynamics term x_{t+1} = A x + B u + d_t
    (terminal row unused). It enters only the b element — `_combine`
    already propagates b into downstream eta/J — plus a qu correction in
    `gains_from_scanned` (pass the same drift there)."""
    N, d = A.shape[0], A.shape[-1]
    dtype = A.dtype

    # stage elements t = 0..N-2
    if fast_inverse:
        Uinv = inv_small(U[:-1])
        Uinv_s = jnp.einsum("tij,tj->ti", Uinv, s[:-1])
        Uinv_BT = Uinv @ jnp.swapaxes(B[:-1], -1, -2)
    else:
        Uinv_s = jnp.linalg.solve(U[:-1], s[:-1][..., None])[..., 0]
        Uinv_BT = jnp.linalg.solve(U[:-1], jnp.swapaxes(B[:-1], -1, -2))
    elem_A = A[:-1]
    elem_b = jnp.einsum("tij,tj->ti", B[:-1], Uinv_s)
    if drift is not None:
        elem_b = elem_b + drift[:-1]
    elem_C = B[:-1] @ Uinv_BT
    elem_eta = eta_all[:-1]
    elem_J = X[:-1]

    # terminal element at index N-1
    zero_d = jnp.zeros((1, d, d), dtype)
    elems = (
        jnp.concatenate([elem_A, zero_d], 0),
        jnp.concatenate([elem_b, jnp.zeros((1, d), dtype)], 0),
        jnp.concatenate([elem_C, zero_d], 0),
        jnp.concatenate([elem_eta, eta_all[-1:]], 0),
        jnp.concatenate([elem_J, X[-1:]], 0),
    )
    return elems, U, s


def gains_from_scanned(
    A, B, U, s, scanned, fast_inverse: bool = False, drift=None
) -> DPGains:
    """Per-step gain extraction from scanned value functions
    V_{t+1} = (J_{t+1}, eta_{t+1}); embarrassingly parallel over t.

    fast_inverse: batched adjugate inverses of the (m, m) Quu blocks
    (m <= 4) instead of per-step Cholesky — at long horizons the batched
    tiny-Cholesky can be the bottleneck.

    drift: the same (N, d) affine dynamics term passed to
    `value_elements_general` — shifts qu by B' J_{t+1} d_t."""
    m = B.shape[-1]
    d = A.shape[-1]
    dtype = A.dtype
    J_all, eta_val = scanned[4], scanned[3]
    Jn = J_all[1:]  # (N-1, d, d)
    etan = eta_val[1:]
    if drift is not None:
        # qu = -s + B'(J_{t+1} d - eta_{t+1}): fold the drift into eta
        etan = etan - jnp.einsum("tij,tj->ti", Jn, drift[:-1])

    if fast_inverse:
        BT = jnp.swapaxes(B[:-1], -1, -2)
        BTJ = BT @ Jn
        Quu = U[:-1] + BTJ @ B[:-1]
        Quu = 0.5 * (Quu + jnp.swapaxes(Quu, -1, -2))
        Qux = BTJ @ A[:-1]
        qu = -s[:-1] - jnp.einsum("tij,tj->ti", BT, etan)
        Quu_inv = inv_small(Quu)
        K = -(Quu_inv @ Qux)
        k = -jnp.einsum("tij,tj->ti", Quu_inv, qu)
    else:
        def gains_one(At, Bt, Ut, st, Jt1, etat1):
            Quu = Ut + Bt.T @ Jt1 @ Bt
            Qux = Bt.T @ Jt1 @ At
            qu = -st - Bt.T @ etat1
            cf = cho_factor(0.5 * (Quu + Quu.T))
            sol = -cho_solve(cf, jnp.concatenate([Qux, qu[:, None]], -1))
            Quu_inv = cho_solve(cf, jnp.eye(Quu.shape[0], dtype=Quu.dtype))
            return sol[:, :-1], sol[:, -1], Quu, Quu_inv, Qux

        K, k, Quu, Quu_inv, Qux = jax.vmap(gains_one)(
            A[:-1], B[:-1], U[:-1], s[:-1], Jn, etan
        )

    pad = lambda arr, tail: jnp.concatenate([arr, tail[None]], axis=0)
    return DPGains(
        K=pad(K, jnp.zeros((m, d), dtype)),
        k=pad(k, jnp.zeros((m,), dtype)),
        Quu=pad(Quu, jnp.zeros((m, m), dtype)),
        Quu_inv=pad(Quu_inv, jnp.zeros((m, m), dtype)),
        Qux=pad(Qux, jnp.zeros((m, d), dtype)),
    )


@jax.jit
@highest_precision
def rollout_closed_loop_parallel(A, B, K, k, x0):
    """Closed-loop *linear* rollout via associative scan (O(log N) depth).

    x_{t+1} = (A_t + B_t K_t) x_t + B_t k_t is an affine recurrence; the
    prefix composition (M, v) ∘ (M', v') = (M' M, M' v + v') is
    associative. Returns (xs (N, d), us (N, m)) like `rollout_closed_loop`
    on linear dynamics — the time-parallel forward-pass counterpart of
    `lqt_backward_parallel`.
    """
    N, d = A.shape[0], A.shape[-1]
    Acl = A + B @ K  # (N, d, d)
    bcl = jnp.einsum("tij,tj->ti", B, k)

    def comb(a, b):
        M1, v1 = a
        M2, v2 = b
        return M2 @ M1, jnp.einsum("tij,tj->ti", M2, v1) + v2

    Ms, vs = lax.associative_scan(comb, (Acl, bcl))
    # xs[0] = x0; xs[t] = Ms[t-1] x0 + vs[t-1]
    xs_tail = jnp.einsum("tij,j->ti", Ms[:-1], x0) + vs[:-1]
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    us = jnp.einsum("tij,tj->ti", K, xs) + k
    return xs, us


@highest_precision
def ilqr_value_elements(A, B, Cts, cts, fast_inverse=False, drift=None):
    """Scan elements for the general iLQR model (with cross terms).

    Completion of squares removes the Cux cross term stage-by-stage. The
    final stage is left untouched: u_{N-1} is unused by convention and
    the terminal value function must stay (Cxx[-1], cx[-1]) raw
    (matches `ilqr_backward`'s V_term/v_term).

    All prelude matmuls are broadcast-multiply-sums, NOT dot_general:
    callers trace under default_matmul_precision('highest'), and XLA
    can lower inner-dim-2 batched HIGHEST matmuls pathologically. The
    expanded form runs exact f32 elementwise.

    Returns (elems, U, s, A_t, Kc): feed (elems) to a suffix scan (local
    or mesh time-sharded), then `gains_from_scanned(A_t, B, U, s,
    scanned, drift=drift)` and map v-gains back as K = K_v - Kc.
    Shared by `ilqr_backward_parallel` and
    `parallel/time_sharded.py::ilqr_backward_time_sharded`."""
    d = A.shape[-1]
    m = B.shape[-1]
    Cxx = Cts[:, :d, :d]
    Cuu = Cts[:, d:, d:]
    Cux = Cts[:, d:, :d]
    cx = cts[:, :d]
    cu = cts[:, d:]

    def bmm(a, b):  # (N, i, k) @ (N, k, j) with tiny k
        return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)

    if m <= 4:
        Kc = bmm(inv_small(Cuu), Cux).at[-1].set(0.0)  # (N, m, d)
    else:
        Kc = jnp.linalg.solve(Cuu, Cux).at[-1].set(0.0)
    A_t = A - bmm(B, Kc)
    X = Cxx - bmm(jnp.swapaxes(Cux, -1, -2), Kc)
    X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    cx_t = cx - jnp.einsum("tji,tj->ti", Kc, cu)  # cx - Kc' cu

    elems, U, s = value_elements_general(
        A_t, B, X, -cx_t, Cuu, -cu, fast_inverse=fast_inverse, drift=drift
    )
    return elems, U, s, A_t, Kc


def ilqr_backward_parallel(
    A: jax.Array,
    B: jax.Array,
    Cts: jax.Array,
    cts: jax.Array,
    block_size: Optional[int] = None,
    fast_inverse: bool = False,
    return_value: bool = False,
    drift=None,
):
    """Time-parallel iLQR Riccati over a general quadratic cost model.

    Same (Cts, cts) contract as `ops/riccati.py::ilqr_backward`, same
    (K, k) output — but the backward recursion runs as an associative
    scan (O(log N) depth; or the two-level blocked scan with
    block_size=L), so the nonlinear solvers (iLQR, AL-iLQR, barrier
    iLQR) get the long-horizon time-parallelism previously exclusive to
    the LQT path. Nonzero Cux cross terms are removed by per-stage
    completion of squares (v = u + Cuu^{-1} Cux x), which shifts the
    dynamics (A <- A - B Cuu^{-1} Cux) and costs; the recovered feedback
    is K = K_v - Cuu^{-1} Cux, k = k_v.

    With AL/barrier outer loops this composes into parallel dynamic
    programming for conic LQ control (PAPERS.md #4) — stagewise cones
    via the smooth outer method, time-parallel DP inside.

    Jitted (see `lqt_backward_parallel`: eager dispatch of the scan
    combinator is 4x slower to first result, 600x on repeats).

    return_value=True additionally returns the per-stage cost-to-go
    (J (N,d,d), eta (N,d)) with V_t(x) = (1/2) x' J_t x - eta_t' x —
    invariant under the internal completion-of-squares substitution
    (it reparameterizes u, not x), so these are the value functions of
    the original model. Consumers: the box-constrained active-set
    refinement (`ops/constrained_riccati.py`).
    """
    if fast_inverse and A.shape[-1] > 4:
        raise ValueError(
            f"fast_inverse=True supports state dim <= 4 (got d={A.shape[-1]})"
        )
    return _ilqr_backward_parallel_impl(
        A, B, Cts, cts, drift, block_size=block_size,
        fast_inverse=fast_inverse, return_value=return_value,
    )


@functools.partial(
    jax.jit, static_argnames=("block_size", "fast_inverse", "return_value")
)
@highest_precision
def _ilqr_backward_parallel_impl(
    A, B, Cts, cts, drift=None, *, block_size, fast_inverse,
    return_value=False
):
    N, d = A.shape[0], A.shape[-1]
    dtype = A.dtype

    elems, U, s, A_t, Kc = ilqr_value_elements(
        A, B, Cts, cts, fast_inverse=fast_inverse, drift=drift
    )
    # materialize the scan elements: without this barrier XLA fuses the
    # completion-of-squares prelude INTO the scan body and recomputes it
    # per step (its cost on the GPU: not measured)
    elems = lax.optimization_barrier(elems)
    comb = functools.partial(_combine, fast_inverse=fast_inverse)
    if block_size is None:
        comb_v = jax.vmap(comb)
        scanned = lax.associative_scan(lambda a, b: comb_v(b, a), elems, reverse=True)
    else:
        scanned = _blocked_suffix_scan(
            comb, lambda p: _identity_elems(p, d, dtype), elems, N, block_size
        )
    gains = gains_from_scanned(
        A_t, B, U, s, scanned, fast_inverse=fast_inverse, drift=drift
    )
    # map v-gains back to u-gains (Kc[-1] is already zero)
    if return_value:
        return gains.K - Kc, gains.k, scanned[4], scanned[3]
    return gains.K - Kc, gains.k
