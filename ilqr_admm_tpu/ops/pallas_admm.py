"""Fused Pallas (Triton) kernel: the full control-bounds LQT-ADMM loop.

The XLA GEMM formulation (`solvers/batched.py`) runs every ADMM
iteration as separate kernels that read and write every iterate from
device memory. This kernel runs the *entire* iteration loop inside one
`pallas_call` per batch tile:

- a tile's iterates (z, λ, u) stay in registers across all iterations
  (device-memory traffic collapses to one read and one write);
- the (Nm × Nm) response operator W is loaded once per program and
  stays on chip for the whole loop;
- the projection and dual update fuse into the loop.

Specialization: a box projection on u, expressed as (N·m,) lower/upper
vectors (±inf disables a coordinate). State boxes and general
projections use the XLA path (`solvers/batched.py`), which is also the
plain reference this kernel is tested against.

Triton wants power-of-two block shapes, so the wrapper pads N·m and
N·d to powers of two (zero operator rows and columns, [0, 0] bounds:
padded coordinates stay exactly zero) and pads a ragged batch up to a
multiple of the tile; outputs are sliced back.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.problem import QuadCost
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho

_F32 = jnp.float32

# In-loop product precision. "ieee": exact f32 FMA products; "tf32x3":
# three TF32 tensor-core passes (hi·hi + hi·lo + lo·hi), ~f32 accuracy.
# The XLA CPU backend has no TF32, so "tf32x3" runs on the GPU only.
PRECISIONS = {
    "ieee": lax.Precision.HIGHEST,
    "tf32x3": lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
}

# Largest padded N·m whose (Nm × Nm) f32 operator (64 KB at 128) stays
# in one program's shared memory for the whole loop; wider problems use
# the XLA path (`kernel_fits`).
MAX_KERNEL_NM = 128


def next_pow2(n: int, floor: int = 16) -> int:
    """Smallest power of two >= max(n, floor) (Triton block sizes)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def kernel_fits(Nm: int) -> bool:
    """Whether an N·m-wide fleet runs in this kernel."""
    return next_pow2(Nm) <= MAX_KERNEL_NM


def pad_to(x, shape, value=0.0):
    """Zero-pad (or `value`-pad) `x` at the end of every axis to `shape`."""
    pads = [(0, s - d) for s, d in zip(shape, x.shape)]
    return jnp.pad(x, pads, constant_values=value)


# Triton warps per program: with 8 a 16-row tile's iterates and the
# on-chip operator fit the registers; 4 warps are 1.4x (P1) and 2.4x
# (P2) slower (`benchmarks/bench_kernel_sweep.py`, PERF.md).
NUM_WARPS = 8


def triton_params():
    """NUM_WARPS warps; no loads inside the loop, so one pipeline stage."""
    return pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def check_tile(batch_tile: int) -> None:
    if batch_tile < 16 or batch_tile & (batch_tile - 1):
        raise ValueError(
            f"batch_tile must be a power of two >= 16, got {batch_tile}"
        )


def _max_abs(x):
    # Triton reductions take one axis at a time
    return jnp.max(jnp.max(jnp.abs(x), axis=1), axis=0)


def _admm_kernel(
    u_base_ref, u0_ref, x_base_ref,
    W_ref, Wx_ref, ub_ref,
    x_out_ref, u_out_ref, zu_out_ref,
    *, n_iters: int, alpha: float, precision, stop_tol: float,
    check_every: int,
):
    """One (tile × Nm)·(Nm × Nm) product per iteration.

    With only the u-block active, u_hat and x_hat are affine in the
    regularization target s = z_u - λ_u:
        u_hat = u_base + s @ W,   x_hat = x_base + s @ Wx,
    and x_hat never feeds back, so the Wx product runs once after the
    loop. The loop carries only (z, λ); the last iteration is peeled off
    to produce u_hat and s.
    """
    u_base = u_base_ref[...]
    lo = ub_ref[0, :][None, :]
    hi = ub_ref[1, :][None, :]
    W = W_ref[...]
    dot = functools.partial(
        jnp.dot, precision=precision, preferred_element_type=_F32
    )

    def x_update(z_u, l_u):
        s = z_u - l_u
        return s, u_base + dot(s, W)

    def project(z_u, l_u, u_hat):
        if alpha == 1.0:
            # t serves both the projection and the dual update
            t = u_hat + l_u
            z_new = jnp.clip(t, lo, hi)
            return z_new, t - z_new
        z_new = jnp.clip(alpha * u_hat + (1.0 - alpha) * z_u + l_u, lo, hi)
        return z_new, l_u + u_hat - z_new

    def step(_, carry):
        z_u, l_u = carry
        return project(z_u, l_u, x_update(z_u, l_u)[1])

    carry = (u0_ref[...], jnp.zeros_like(u_base))
    if stop_tol > 0.0:
        # per-program early exit: after each chunk of `check_every`
        # iterations the tile stops once every instance has max-abs
        # primal residual |u_hat - z| and z-motion |z - z_prev| under
        # stop_tol. Programs exit independently; an unconverged tile
        # runs up to check_every - 1 iterations past n_iters.
        n_chunks = -(-(n_iters - 1) // check_every)

        def w_cond(state):
            i, _, r = state
            return jnp.logical_and(i < n_chunks, r >= stop_tol)

        def w_body(state):
            i, carry, _ = state
            z_u, l_u = lax.fori_loop(0, check_every - 1, step, carry)
            u_hat = x_update(z_u, l_u)[1]
            z_new, l_new = project(z_u, l_u, u_hat)
            r = jnp.maximum(_max_abs(u_hat - z_new), _max_abs(z_new - z_u))
            return i + 1, (z_new, l_new), r

        _, carry, _ = lax.while_loop(
            w_cond, w_body, (jnp.int32(0), carry, jnp.asarray(jnp.inf, _F32))
        )
    else:
        carry = lax.fori_loop(0, n_iters - 1, step, carry)
    s, u = x_update(*carry)
    z_u, _ = project(*carry, u)

    x_out_ref[...] = x_base_ref[...] + dot(s, Wx_ref[...])
    u_out_ref[...] = u
    zu_out_ref[...] = z_u


def make_pallas_lqt_admm(
    A,
    B,
    cost: QuadCost,
    u_lower=None,
    u_upper=None,
    rho_u=None,
    n_iters: int = 100,
    alpha: float = 1.0,
    batch_tile: int = 16,
    precision: str = "tf32x3",
    stop_tol: float = 0.0,
    check_every: int = 8,
    interpret: bool = False,
):
    """Build a fused-Pallas batched control-bounds LQT-ADMM solver.

    u_lower/u_upper: scalars or (N*u_dim,) bounds (None: unbounded on
    that side). Returns solve(x0s (batch, d)) -> (x, u, z_u), the same
    iterates as `solvers/batched.py::make_batched_lqt_admm` (same warm
    start, same update order): x, u are the last x-update, z_u the
    projected iterate. Any batch size is accepted; `solve.padded`
    returns the kernel's padded outputs. State-box fleets use
    `solvers/batched.py`.

    precision: "ieee" or "tf32x3" (`PRECISIONS`). batch_tile: rows per
    program, a power of two >= 16. stop_tol > 0 enables per-tile early
    exit, checked every `check_every` iterations. interpret=True runs
    the kernel through the Pallas interpreter (the only mode on CPU).
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    if u_lower is None and u_upper is None:
        raise ValueError("control bounds required (u_lower and/or u_upper)")
    # same invariant as solvers.admm.validate_constraint_blocks: bounds
    # without a (nonzero) rho would be silently ignored by the x-update
    # (W stays zero and the kernel returns the unconstrained optimum
    # while zu looks feasible)
    from ilqr_admm_tpu.solvers.admm import validate_constraint_blocks

    validate_constraint_blocks(None, None, object(), rho_u)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; use {list(PRECISIONS)}")
    check_tile(batch_tile)
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    Nm, Nd = N * m, N * d
    Nm_p, Nd_p = next_pow2(Nm), next_pow2(Nd)
    if Nm_p > MAX_KERNEL_NM:
        raise ValueError(
            f"N*m = {Nm} pads to {Nm_p} > {MAX_KERNEL_NM}: the operator does "
            "not fit on chip; use solvers.batched.make_batched_lqt_admm"
        )

    dtype = _F32
    A = A.astype(dtype)
    B = B.astype(dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)

    # one-time operator setup at HIGHEST precision: unpinned f32 matmuls
    # may run in TF32 on the GPU and perturb the operators enough that
    # ADMM converges to the optimum of a different problem
    with jax.default_matmul_precision("highest"):
        Su = build_Su(A, B)
        Sx = build_Sx(A).reshape(Nd, d)
        SuTQ = Su.T @ block_diag_stacked(cost.Q).astype(dtype)
        l_side = SuTQ @ Su + block_diag_stacked(cost.R).astype(dtype)
        l_inv_unreg = jnp.linalg.inv(l_side)
        Rr_l = block_diag_stacked(Rr).astype(dtype)
        l_inv = jnp.linalg.inv(l_side + Rr_l)
        r_const = SuTQ @ cost.lifted_xd().astype(dtype)
        W = Rr_l.T @ l_inv.T  # (Nm, Nm): u_hat += s @ W
        Wx = W @ Su.T  # (Nm, Nd): state response to s

    lo = -jnp.inf if u_lower is None else u_lower
    hi = jnp.inf if u_upper is None else u_upper
    lo = jnp.broadcast_to(jnp.asarray(lo, dtype), (Nm,))
    hi = jnp.broadcast_to(jnp.asarray(hi, dtype), (Nm,))
    ub = pad_to(jnp.stack([lo, hi]), (2, Nm_p))  # pads are [0, 0]
    W_p = pad_to(W, (Nm_p, Nm_p))
    Wx_p = pad_to(Wx, (Nm_p, Nd_p))
    kernel = functools.partial(
        _admm_kernel, n_iters=n_iters, alpha=alpha,
        precision=PRECISIONS[precision], stop_tol=float(stop_tol),
        check_every=int(check_every),
    )
    params = triton_params()
    hp = lax.Precision.HIGHEST  # per-solve setup products, outside the kernel

    def tile(cols):
        return pl.BlockSpec((batch_tile, cols), lambda i: (i, 0))

    def shared(shape):
        return pl.BlockSpec(shape, lambda i: (0, 0))

    @jax.jit
    def solve_padded(x0s):
        """(batch, d) -> padded (x, u, z_u): (batch_p, Nd_p | Nm_p)."""
        batch_p = -(-x0s.shape[0] // batch_tile) * batch_tile
        x0s = pad_to(x0s.astype(dtype), (batch_p, d))
        free = jnp.matmul(x0s, Sx.T, precision=hp)
        r_base = r_const[None] - jnp.matmul(free, SuTQ.T, precision=hp)
        # warm start: the unconstrained optimum (as solvers/batched.py)
        u0 = jnp.matmul(r_base, l_inv_unreg.T, precision=hp)
        u_base = jnp.matmul(r_base, l_inv.T, precision=hp)
        x_base = free + jnp.matmul(u_base, Su.T, precision=hp)
        out = lambda cols: jax.ShapeDtypeStruct((batch_p, cols), dtype)
        return pl.pallas_call(
            kernel,
            grid=(batch_p // batch_tile,),
            in_specs=[
                tile(Nm_p), tile(Nm_p), tile(Nd_p),
                shared((Nm_p, Nm_p)), shared((Nm_p, Nd_p)), shared((2, Nm_p)),
            ],
            out_specs=(tile(Nd_p), tile(Nm_p), tile(Nm_p)),
            out_shape=(out(Nd_p), out(Nm_p), out(Nm_p)),
            backend="triton",
            compiler_params=params,
            interpret=interpret,
        )(
            pad_to(u_base, (batch_p, Nm_p)), pad_to(u0, (batch_p, Nm_p)),
            pad_to(x_base, (batch_p, Nd_p)), W_p, Wx_p, ub,
        )

    @jax.jit
    def solve(x0s):
        b = x0s.shape[0]
        x, u, zu = solve_padded(x0s)
        return x[:b, :Nd], u[:b, :Nm], zu[:b, :Nm]

    solve.padded = solve_padded
    return solve
