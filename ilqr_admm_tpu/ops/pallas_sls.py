"""Fused Pallas (Triton) kernel: batched robust SLS-ADMM with inlined
chance-constraint projections.

The XLA path (`solvers/batched_sls.py`) streams the (batch, Nm, p+1)
iterates through device memory every ADMM iteration and runs the
chance-constraint projection as generic vmapped code. This kernel keeps
a batch tile's entire iterate set in registers across ALL outer
iterations and fuses everything:

- layout: per-column **slabs** — the decision matrix [du | Phi_u-cols]
  is stored as p+1 separate (tile_b, Nm) arrays, so every reduction of
  the per-row chance-constraint projection (vectors of length p+1 / p+2)
  becomes *elementwise* code over slabs with compile-time scalar
  coefficients;
- x-update: p+1 products (tile_b, Nm) x (Nm, Nm) per iteration against
  one operator W that stays on chip for the whole loop;
- z-update: either the exact closed-form "diamond" row projection or the
  intersection-of-SOCs projection (chance-constrained bounds, reference
  notebook construction SURVEY §3.3) whose consensus-ADMM inner loop
  (`projections/sets.py::project_set_convex` semantics, fixed iteration
  count) runs as unrolled elementwise code, with the small (p+1, p+1)
  prefactored inverse unrolled to scalar constants.

Specialization: chance-constrained *control* rows — each row phi of
[du | Phi_u] must satisfy A_i phi + b_i in SOC for a static list of
A_i, with the per-instance scenario parameter (the bound) entering b_i
linearly. State chance constraints use the XLA path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.ops.pallas_admm import (
    MAX_KERNEL_NM, PRECISIONS, _max_abs, check_tile, next_pow2, pad_to,
    triton_params,
)
from ilqr_admm_tpu.problem import QuadCost
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho

_F32 = jnp.float32
_EPS = 1e-30


def _soc_project_slabs(ws, t):
    """SOC projection of slab-decomposed [w_0..w_{q-1} | t] onto
    ||w|| <= t. ws: list of (tile_b, Nm) slabs; t: (tile_b, Nm).
    Elementwise — mirrors `projections/primitives.py:83-98`."""
    n2 = ws[0] * ws[0]
    for w in ws[1:]:
        n2 = n2 + w * w
    n = jnp.sqrt(n2)
    inside = n <= t
    zero = n <= -t
    scale = 0.5 * (n + t) / (n + _EPS)
    w_out = [
        jnp.where(inside, w, jnp.where(zero, 0.0, scale * w)) for w in ws
    ]
    t_out = jnp.where(inside, t, jnp.where(zero, 0.0, 0.5 * (n + t)))
    return w_out, t_out


def _diamond_project_slabs(a, b, w0, w1, r):
    """Exact projection of rows (a, b) onto {w0|a| + w1|b| <= r}.

    The weighted-l1 'diamond' — the chance-constrained control-bounds
    row set |du| + psi*sigma*|phi| <= bound in closed form (p = 1).
    Elementwise over (tile_b, Nm) slabs: the soft-threshold solution
    v_k = sign(v_k) max(|v_k| - lam w_k, 0) with the 2D lambda resolved
    branchlessly (both-active line projection, then the two
    one-coordinate-clamped vertex branches). Replaces the generic
    n_cons_iters-deep consensus-ADMM inner loop entirely, and is EXACT
    (the consensus inner loop is only ever approximately feasible).
    """
    aa = jnp.abs(a)
    ab = jnp.abs(b)
    s = w0 * aa + w1 * ab
    inside = s <= r
    lam = (s - r) / (w0 * w0 + w1 * w1)
    xa = aa - lam * w0
    xb = ab - lam * w1
    # if one soft-thresholded coordinate would go negative, the KKT
    # solution clamps it to 0 and the other to the diamond vertex
    na = jnp.where(xb < 0.0, r / w0, jnp.where(xa < 0.0, 0.0, xa))
    nb = jnp.where(xb < 0.0, 0.0, jnp.where(xa < 0.0, r / w1, xb))
    a_out = jnp.where(inside, a, jnp.sign(a) * na)
    b_out = jnp.where(inside, b, jnp.sign(b) * nb)
    return a_out, b_out


def _sls_admm_kernel(
    bound_ref,  # (tile_b, 1) per-instance bound
    U_base_ref,  # (p1_p, Nm) unconstrained x-update base, one row per slab
    W_ref,  # (Nm, Nm) composite (l_inv Rr)^T
    U_out_ref,  # (p1_p, tile_b, Nm)
    *,
    n_iters: int,
    n_cons_iters: int,
    alpha: float,
    cons_rho: float,
    stop_tol: float,
    check_every: int,
    p1: int,
    soc_A,  # tuple of np (q, p1) matrices (compile-time constants)
    soc_b_fixed,  # tuple of np (q,) vectors
    soc_b_bound,  # tuple of np (q,) vectors: b_i = fixed + bound * coeff
    l_inv_cons,  # np (p1, p1) prefactored consensus inverse
    precision,
    z_update: str = "consensus",
    diamond_w=None,  # (p1,) weights when z_update == "diamond"
):
    nsets = len(soc_A)
    # SOC dimension (q-1 "z" comps + 1 "t" comp); unused in diamond mode
    q = soc_A[0].shape[0] if nsets else 0
    tile_b, Nm = U_out_ref.shape[1], U_out_ref.shape[2]
    bound = jnp.broadcast_to(bound_ref[...], (tile_b, Nm))
    U_base = [jnp.broadcast_to(U_base_ref[k, :][None, :], (tile_b, Nm))
              for k in range(p1)]
    W = W_ref[...]

    def b_slab(i, r):
        """Constraint offset b_i[r] as a (tile_b, Nm) slab."""
        c = float(soc_b_fixed[i][r])
        s = float(soc_b_bound[i][r])
        out = jnp.full_like(bound, c)
        if s != 0.0:
            out = out + s * bound
        return out

    def consensus_project(ys):
        """Project each row vector y (slab list, len p1) onto the
        intersection {phi : A_i phi + b_i in SOC for all i}."""
        # init: z_i = A_i y + b_i, lambda_i = 0  (sets.py:107-108)
        zs = []
        for i in range(nsets):
            zi = []
            for r in range(q):
                acc = jnp.zeros_like(ys[0])
                for k in range(p1):
                    a = float(soc_A[i][r, k])
                    if a != 0.0:
                        acc = acc + a * ys[k]
                zi.append(acc + b_slab(i, r))
            zs.append(zi)
        lmbs = [[jnp.zeros_like(ys[0]) for _ in range(q)] for _ in range(nsets)]

        def x_update(zs, lmbs):
            """x = l_inv_cons (y + rho * sum_i A_i^T (z_i - b_i - l_i)),
            unrolled with compile-time coefficients."""
            rx = []
            for k in range(p1):
                acc = ys[k]
                for i in range(nsets):
                    for r in range(q):
                        a = float(soc_A[i][r, k])
                        if a != 0.0:
                            acc = acc + (cons_rho * a) * (
                                zs[i][r] - b_slab(i, r) - lmbs[i][r]
                            )
                rx.append(acc)
            xs = []
            for k in range(p1):
                acc = jnp.zeros_like(ys[0])
                for j in range(p1):
                    c = float(l_inv_cons[k, j])
                    if c != 0.0:
                        acc = acc + c * rx[j]
                xs.append(acc)
            return xs

        def body(_, carry):
            zs, lmbs = carry
            xs = x_update(zs, lmbs)
            # z / dual updates per set (sets.py:126-136)
            zs_new, lmbs_new = [], []
            for i in range(nsets):
                Ax_b = []
                for r in range(q):
                    acc = b_slab(i, r)
                    for k in range(p1):
                        a = float(soc_A[i][r, k])
                        if a != 0.0:
                            acc = acc + a * xs[k]
                    Ax_b.append(acc)
                w_in = [Ax_b[r] + lmbs[i][r] for r in range(q)]
                w_out, t_out = _soc_project_slabs(w_in[:-1], w_in[-1])
                z_new = w_out + [t_out]
                l_new = [
                    lmbs[i][r] + Ax_b[r] - z_new[r] for r in range(q)
                ]
                zs_new.append(z_new)
                lmbs_new.append(l_new)
            return zs_new, lmbs_new

        # pack nested lists into tuples for the fori carry
        def pack(nested):
            return tuple(tuple(row) for row in nested)

        zs, lmbs = lax.fori_loop(
            0, n_cons_iters - 1, lambda i, c: tuple(map(pack, body(i, c))),
            (pack(zs), pack(lmbs)),
        )
        # the last iteration's x-update is the result, as in
        # project_set_convex (its z / dual half would be discarded)
        return x_update(zs, lmbs)

    def x_update(Z, L):
        # U_k = U_base_k + (Z_k - L_k) @ W
        return tuple(
            U_base[k] + jnp.dot(Z[k] - L[k], W, precision=precision,
                                preferred_element_type=_F32)
            for k in range(p1)
        )

    def z_dual_update(Z, L, U):
        ys = [alpha * U[k] + (1.0 - alpha) * Z[k] + L[k] for k in range(p1)]
        if z_update == "diamond":
            Z_new = _diamond_project_slabs(
                ys[0], ys[1], float(diamond_w[0]), float(diamond_w[1]), bound
            )
        else:
            Z_new = consensus_project(ys)
        return (tuple(Z_new),
                tuple(L[k] + U[k] - Z_new[k] for k in range(p1)))

    def step(_, carry):
        return z_dual_update(*carry, x_update(*carry))

    # zero start, as solvers/batched_sls.py: the first x-update is U_base.
    # The loop carries only (Z, L); the last iteration is peeled off.
    zero = jnp.zeros((tile_b, Nm), _F32)
    carry = ((zero,) * p1, (zero,) * p1)
    if stop_tol > 0.0:
        # per-program early exit: the residual is checked every
        # `check_every` iterations. At large rho_u the primal residual
        # |U - Z| is tight from the first iterations while the DUAL
        # residual (per-iteration z motion) is the live one, so the test
        # takes the max of both. An unconverged tile runs up to
        # check_every - 1 iterations past n_iters.
        n_chunks = -(-(n_iters - 1) // check_every)

        def w_cond(state):
            return jnp.logical_and(state[0] < n_chunks, state[2] >= stop_tol)

        def w_body(state):
            i, carry, _ = state
            Z, L = lax.fori_loop(0, check_every - 1, step, carry)
            U = x_update(Z, L)
            Z_new, L_new = z_dual_update(Z, L, U)
            r = jnp.asarray(0.0, _F32)
            for k in range(p1):
                r = jnp.maximum(r, _max_abs(U[k] - Z_new[k]))
                r = jnp.maximum(r, _max_abs(Z_new[k] - Z[k]))
            return i + 1, (Z_new, L_new), r

        _, carry, _ = lax.while_loop(
            w_cond, w_body, (jnp.int32(0), carry, jnp.asarray(jnp.inf, _F32))
        )
    else:
        carry = lax.fori_loop(0, n_iters - 1, step, carry)
    U = x_update(*carry)
    for k in range(p1):
        U_out_ref[k] = U[k]


def make_pallas_sls_admm(
    A,
    B,
    cost: QuadCost,
    soc_A,
    soc_b_fixed,
    soc_b_bound,
    rho_u,
    robust_dim: int = 1,
    n_iters: int = 50,
    n_cons_iters: int = 20,
    cons_rho: float = 10.0,
    alpha: float = 1.0,
    batch_tile: int = 16,
    precision: str = "tf32x3",
    stop_tol: float = 0.0,
    check_every: int = 8,
    interpret: bool = False,
    z_update: str = "consensus",
    diamond_w=None,
):
    """Build a fused-Pallas batched robust SLS-ADMM solver.

    z_update='diamond' (requires robust_dim == 1 and `diamond_w`, a pair
    of weights) replaces the inner consensus-ADMM projection with the
    EXACT closed-form projection of each row onto the weighted-l1 ball
    {w0 |du_r| + w1 |phi_r| <= bound} — the same row set as the two-SOC
    intersection of the chance-constrained control-bounds construction,
    and exactly feasible (soc_A/soc_b are ignored; pass empty tuples).

    stop_tol > 0 enables per-tile early exit (residual checked every
    `check_every` iterations) — heterogeneous scenario fleets sorted by
    `bounds` group stragglers so easy tiles stop early.

    Chance-constrained control rows: every row phi (length p+1 =
    robust_dim+1) of [du | Phi_u-cols] must satisfy
    `soc_A[i] @ phi + b_i in SOC` for each constraint set i, with
    b_i = soc_b_fixed[i] + bound * soc_b_bound[i] and `bound` the
    per-instance scenario parameter. soc_* are numpy arrays (they are
    baked into the kernel as scalar constants).

    precision, batch_tile, interpret: as
    `ops/pallas_admm.py::make_pallas_lqt_admm`. Any batch size is
    accepted (padded to the tile; padded instances get bound 1).

    Returns solve(bounds (batch,)) -> (du (batch, Nm),
    phi_u (batch, Nm, Nd), U (batch, Nm, p+1)), the iterates of
    `solvers/batched_sls.py::make_batched_sls_admm` (same zero start,
    same update order).
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    p = robust_dim
    p1 = p + 1
    dtype = _F32
    A = A.astype(dtype)
    B = B.astype(dtype)

    if z_update not in ("consensus", "diamond"):
        raise ValueError(f"unknown z_update {z_update!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; use {list(PRECISIONS)}")
    check_tile(batch_tile)
    if n_iters < 1 or n_cons_iters < 1:
        raise ValueError(
            f"n_iters and n_cons_iters must be >= 1, got {n_iters}, "
            f"{n_cons_iters}"
        )
    Nm = N * m
    Nm_p = next_pow2(Nm)
    if Nm_p > MAX_KERNEL_NM:
        raise ValueError(
            f"N*m = {Nm} pads to {Nm_p} > {MAX_KERNEL_NM}: the operator does "
            "not fit on chip; use solvers.batched_sls.make_batched_sls_admm"
        )
    if z_update == "diamond":
        if p1 != 2 or diamond_w is None or len(diamond_w) != 2:
            raise ValueError(
                "z_update='diamond' requires robust_dim == 1 and "
                "diamond_w = (w_du, w_phi)"
            )
        diamond_w = np.asarray(diamond_w, np.float64)
        if not np.all(diamond_w > 0.0):
            # a zero weight makes r/w infinite in the vertex-clamp
            # branch of the closed-form projection -> NaN iterates with
            # no error (e.g. the sigma=0 no-uncertainty degenerate case:
            # use plain box bounds / pallas_admm instead)
            raise ValueError(
                f"diamond_w must be strictly positive, got {tuple(diamond_w)}"
            )
        soc_A, soc_b_fixed, soc_b_bound = (), (), ()
        l_inv_cons = np.eye(p1)
    else:
        soc_A = tuple(np.asarray(a, np.float64) for a in soc_A)
        soc_b_fixed = tuple(np.asarray(b, np.float64) for b in soc_b_fixed)
        soc_b_bound = tuple(np.asarray(b, np.float64) for b in soc_b_bound)
        if len({a.shape[0] for a in soc_A}) != 1:
            # the kernel unrolls SOC rows with q = soc_A[0].shape[0]; ragged
            # sets would have their extra rows silently dropped
            raise ValueError(
                "all soc_A constraint sets must have the same number of rows; "
                f"got {[a.shape[0] for a in soc_A]} — zero-pad the smaller sets"
            )
        lc = np.eye(p1)
        for a in soc_A:
            lc = lc + cons_rho * (a.T @ a)
        l_inv_cons = np.linalg.inv(lc)

    from ilqr_admm_tpu.solvers.lqt import lqt_solve_sls

    # one-time setup pinned at HIGHEST (unpinned f32 may run in TF32)
    with jax.default_matmul_precision("highest"):
        PHI_unc, _ = lqt_solve_sls(A, B, cost)

        Su = build_Su(A, B)
        # first p columns of Sw, built directly (O(N d^2 p) vs the dense
        # (Nd)^2 operator)
        Sx = build_Sx(A, p).reshape(-1, p)
        Rr = broadcast_rho(rho_u, m, N, dtype)
        Rr_l = block_diag_stacked(Rr)

        Qlift = block_diag_stacked(cost.Q).astype(dtype)
        SuTQ = Su.T @ Qlift
        l_side = SuTQ @ Su + block_diag_stacked(cost.R).astype(dtype) + Rr_l
        l_inv = jnp.linalg.inv(l_side)
        r_ff = SuTQ @ cost.lifted_xd().astype(dtype)
        r_fb = -SuTQ @ Sx
        r_base = jnp.concatenate([r_ff[:, None], r_fb], axis=-1)  # (Nm, p1)

        U_base_cols = (l_inv @ r_base).T  # (p1, Nm)
        W = (l_inv @ Rr_l).T  # (Nm, Nm); U += (Z-L) @ W

    p1_p = next_pow2(p1, floor=1)
    U_base_p = pad_to(U_base_cols, (p1_p, Nm_p))
    W_p = pad_to(W, (Nm_p, Nm_p))

    kernel = functools.partial(
        _sls_admm_kernel,
        n_iters=n_iters, n_cons_iters=n_cons_iters, alpha=alpha,
        cons_rho=cons_rho, p1=p1,
        stop_tol=float(stop_tol), check_every=int(check_every),
        soc_A=soc_A, soc_b_fixed=soc_b_fixed, soc_b_bound=soc_b_bound,
        l_inv_cons=l_inv_cons, precision=PRECISIONS[precision],
        z_update=z_update, diamond_w=diamond_w,
    )
    params = triton_params()

    @jax.jit
    def solve_padded(bounds):
        """(batch,) -> padded slabs U: (p1_p, batch_p, Nm_p)."""
        batch_p = -(-bounds.shape[0] // batch_tile) * batch_tile
        bounds_p = pad_to(bounds.astype(dtype)[:, None], (batch_p, 1), 1.0)
        return pl.pallas_call(
            kernel,
            grid=(batch_p // batch_tile,),
            in_specs=[
                pl.BlockSpec((batch_tile, 1), lambda i: (i, 0)),
                pl.BlockSpec((p1_p, Nm_p), lambda i: (0, 0)),
                pl.BlockSpec((Nm_p, Nm_p), lambda i: (0, 0)),
            ],
            out_specs=pl.BlockSpec((p1_p, batch_tile, Nm_p),
                                   lambda i: (0, i, 0)),
            out_shape=jax.ShapeDtypeStruct((p1_p, batch_p, Nm_p), dtype),
            backend="triton",
            compiler_params=params,
            interpret=interpret,
        )(bounds_p, U_base_p, W_p)

    @jax.jit
    def solve(bounds):
        batch = bounds.shape[0]
        U = solve_padded(bounds)[:p1, :batch, :Nm]
        U = jnp.transpose(U, (1, 2, 0))  # (batch, Nm, p1)
        du = U[:, :, 0]
        phi_u = jnp.concatenate(
            [U[:, :, 1:p1],
             jnp.broadcast_to(PHI_unc[:, p:], (batch,) + PHI_unc[:, p:].shape)],
            axis=-1,
        )
        return du, phi_u, U

    solve.padded = solve_padded
    return solve
