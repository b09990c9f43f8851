"""Trajectory rollouts as `lax.scan` recursions.

Replaces the reference's per-timestep Python simulators
(`sls_base.py:62-105`, `isls_base.py:28-71`, `isls.py:135-154,310-334`).
All rollouts are single-instance pure functions; batch over initial
states / line-search candidates / Monte-Carlo samples with `vmap`.

Conventions: trajectories are x_0..x_{N-1} (N states), matching the
reference's `x_log[:, :-1]` return. Optional additive process noise is
passed as a pre-sampled array `ws (N, x_dim)` so rollouts stay pure.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax


from ilqr_admm_tpu.utils.precision import highest_precision


@highest_precision
def rollout_linear(
    A: jax.Array, B: jax.Array, x0: jax.Array, us: jax.Array,
    ws: Optional[jax.Array] = None, unroll: int = 1,
) -> jax.Array:
    """Open-loop linear rollout: returns xs (N, x_dim), xs[0] = x0.

    unroll > 1 unrolls the scan body (identical math/order; cuts the
    per-step loop overhead that dominates small-state rollouts — see
    `rollout_nonlinear`)."""
    def step(x, inp):
        if ws is None:
            At, Bt, ut = inp
            w = 0.0
        else:
            At, Bt, ut, w = inp
        return At @ x + Bt @ ut + w, x

    xs_in = (A, B, us) if ws is None else (A, B, us, ws)
    _, xs = lax.scan(step, x0, xs_in, unroll=unroll)
    return xs


@highest_precision
def rollout_nonlinear(
    f: Callable, x0: jax.Array, us: jax.Array, ws: Optional[jax.Array] = None,
    unroll: int = 1,
) -> jax.Array:
    """Open-loop nonlinear rollout with f(x, u) -> x_next (single sample).

    unroll > 1 unrolls the scan body: bit-identical results, but the
    per-step loop overhead stops dominating
    small-state rollouts — the iLQR-ADMM line-search rollouts at N=500
    are the motivating hot path."""
    def step(x, inp):
        if ws is None:
            ut = inp
            w = 0.0
        else:
            ut, w = inp
        return f(x, ut) + w, x

    _, xs = lax.scan(step, x0, us if ws is None else (us, ws), unroll=unroll)
    return xs


@highest_precision
def rollout_closed_loop(
    f: Callable,
    x0: jax.Array,
    K: jax.Array,
    k: jax.Array,
    x_nom: Optional[jax.Array] = None,
    u_nom: Optional[jax.Array] = None,
    ws: Optional[jax.Array] = None,
    unroll: int = 1,
):
    """Per-step feedback rollout: u_t = K_t (x_t - x_nom_t) + k_t + u_nom_t.

    With x_nom/u_nom = None this is the LQT DP controller
    (`sls_base.py:76-89`); with nominals it is the iLQR line-search
    rollout (`isls.py:310-334`). Returns (xs (N,x), us (N,u)).
    """
    N = K.shape[0]
    dtype = K.dtype
    zx = jnp.zeros((N, K.shape[-1]), dtype) if x_nom is None else x_nom
    zu = jnp.zeros((N, K.shape[-2]), dtype) if u_nom is None else u_nom

    def step(x, inp):
        if ws is None:
            Kt, kt, xnt, unt = inp
            w = 0.0
        else:
            Kt, kt, xnt, unt, w = inp
        # expanded matvec: exact elementwise f32 whatever precision the
        # backend gives small dot_generals (K rows reach 1e3-scale on
        # stiff problems, so product noise feeds visible control
        # perturbations into the line-search rollouts)
        u = jnp.sum(Kt * (x - xnt)[None, :], axis=-1) + kt + unt
        return f(x, u) + w, (x, u)

    xs_in = (K, k, zx, zu) if ws is None else (K, k, zx, zu, ws)
    _, (xs, us) = lax.scan(step, x0, xs_in, unroll=unroll)
    return xs, us


@highest_precision
def rollout_sls(
    f: Callable,
    x0: jax.Array,
    K: jax.Array,
    k: jax.Array,
    x_dim: int,
    u_dim: int,
    ws: Optional[jax.Array] = None,
):
    """History-feedback SLS rollout: u_t = K[t, 0:t+1] · x_{0:t} + k_t.

    K is the lifted causal gain (N*u, N*x), k is (N*u,) — reference
    `sls_base.py:91-105`. Returns (xs, us).
    """
    N = K.shape[0] // u_dim
    K4 = K.reshape(N, u_dim, N, x_dim)
    k2 = k.reshape(N, u_dim)

    def step(carry, inp):
        x, xh, t = carry
        if ws is None:
            K4t, k2t = inp
            w = 0.0
        else:
            K4t, k2t, w = inp
        xh = lax.dynamic_update_slice(xh, x[None], (t, jnp.int32(0)))
        u = jnp.einsum("unj,nj->u", K4t, xh) + k2t
        return (f(x, u) + w, xh, t + 1), (x, u)

    xh0 = jnp.zeros((N, x_dim), K.dtype)
    xs_in = (K4, k2) if ws is None else (K4, k2, ws)
    _, (xs, us) = lax.scan(step, (x0, xh0, jnp.int32(0)), xs_in)
    return xs, us


@highest_precision
def rollout_sls_delta(
    f: Callable,
    x0: jax.Array,
    K: jax.Array,
    k: jax.Array,
    x_nom: jax.Array,
    u_nom: jax.Array,
    ws: Optional[jax.Array] = None,
):
    """SLS rollout around a nominal: history feedback on deltas.

    u_t = K[t, 0:t+1] · (x_{0:t} - x_nom_{0:t}) + k_t + u_nom_t
    (reference `isls_base.py:28-42`).
    """
    u_dim = u_nom.shape[-1]
    x_dim = x_nom.shape[-1]
    N = x_nom.shape[0]
    K4 = K.reshape(N, u_dim, N, x_dim)
    k2 = k.reshape(N, u_dim)

    def step(carry, inp):
        x, xh, t = carry
        if ws is None:
            K4t, k2t, xnt, unt = inp
            w = 0.0
        else:
            K4t, k2t, xnt, unt, w = inp
        xh = lax.dynamic_update_slice(xh, (x - xnt)[None], (t, jnp.int32(0)))
        u = jnp.einsum("unj,nj->u", K4t, xh) + k2t + unt
        return (f(x, u) + w, xh, t + 1), (x, u)

    xh0 = jnp.zeros((N, x_dim), K.dtype)
    xs_in = (K4, k2, x_nom, u_nom) if ws is None else (K4, k2, x_nom, u_nom, ws)
    _, (xs, us) = lax.scan(step, (x0, xh0, jnp.int32(0)), xs_in)
    return xs, us
