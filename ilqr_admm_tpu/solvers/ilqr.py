"""iLQR: iterative LQR with DP (Riccati) or batch (lifted LS) inner solves.

Functional equivalent of `iSLS.solve` / `iterate_once_dp` /
`iterate_once_batch` (reference `isls.py:54-374`), redesigned for
batched device execution:

- the Riccati backward pass is a `lax.scan` (`ops/riccati.py`);
- the whole line-search grid is rolled out in one `vmap` (the reference
  already batches alphas, `isls.py:357-358` — here the rollout itself is
  a scan, and candidate selection is an on-device argmin);
- the outer loop is a `lax.while_loop` with structured status, so the
  full solve jits and `vmap`s over problem instances.

All user functions are single-instance pure JAX:
  f(x, u) -> x_next;  cost_fn(xs, us) -> scalar;
  get_AB(xs, us) -> (A (N,d,d), B (N,d,m));
  get_Cs(xs, us) -> (cts (N,d+m), Cts (N,d+m,d+m)).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from ilqr_admm_tpu.ops.lifted import build_Su
from ilqr_admm_tpu.ops.riccati import ilqr_backward
from ilqr_admm_tpu.ops.rollout import rollout_closed_loop, rollout_nonlinear
from ilqr_admm_tpu.problem import ILQRConfig, SolveStatus, line_search_alphas

from ilqr_admm_tpu.utils.precision import highest_precision

# NaN line-search candidates must never win. The reference clamps NaN cost
# to 1e5 (`isls.py:362`) — a latent defect: when true costs exceed 1e5 (big
# weights / f32 overflow on exploding rollouts) the NaN candidate "wins" and
# poisons the nominal. Clamp to +inf instead (SURVEY §2 defect policy).
_NAN_COST = float("inf")


class ILQRState(NamedTuple):
    x_nom: jax.Array  # (N, d)
    u_nom: jax.Array  # (N, m)
    cost: jax.Array  # scalar
    prev_cost: jax.Array
    iteration: jax.Array  # int32
    status: jax.Array  # SolveStatus int32


def ilqr_init(f: Callable, cost_fn: Callable, x0, u0) -> ILQRState:
    """Roll out an initial guess and evaluate its cost."""
    xs = rollout_nonlinear(f, x0, u0)
    c = cost_fn(xs, u0)
    big = jnp.asarray(jnp.inf, c.dtype)
    return ILQRState(
        x_nom=xs, u_nom=u0, cost=c, prev_cost=big,
        iteration=jnp.int32(0), status=jnp.int32(SolveStatus.RUNNING),
    )


def _select_candidate(cost_fn, xs_cand, us_cand, state: ILQRState):
    """Evaluate all line-search candidates, pick the best, accept if better."""
    costs = jax.vmap(cost_fn)(xs_cand, us_cand)
    costs = jnp.where(jnp.isnan(costs), _NAN_COST, costs)
    ind = jnp.argmin(costs)
    best = costs[ind]
    accept = best < state.cost
    x_new = jnp.where(accept, xs_cand[ind], state.x_nom)
    u_new = jnp.where(accept, us_cand[ind], state.u_nom)
    return ILQRState(
        x_nom=x_new,
        u_nom=u_new,
        cost=jnp.where(accept, best, state.cost),
        prev_cost=state.cost,
        iteration=state.iteration + 1,
        status=state.status,
    ), accept


@highest_precision
def ilqr_iterate_dp(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state: ILQRState,
    alphas: jax.Array,
    riccati: str = "chol",
):
    """One DP iLQR iteration: Riccati backward + vmapped line search.

    riccati='sqrt' uses the array-form square-root backward pass
    (`ops/sqrt_riccati.py`) — f32-stable at stiff weight ratios; nonzero
    Cux cross terms are handled by per-step completion of squares.
    riccati='parallel' uses the associative-scan time-parallel pass
    (`ops/parallel_riccati.py::ilqr_backward_parallel`) — O(log N)
    depth for long horizons; 'parallel_fast' additionally turns on the
    closed-form adjugate combine inverses (fast_inverse, d <= 4) and
    the two-level blocked scan.
    Returns (new_state, accept, (K, k)).
    """
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)
    if riccati == "sqrt":
        from ilqr_admm_tpu.ops.sqrt_riccati import ilqr_backward_sqrt

        K, k = ilqr_backward_sqrt(A, B, Cts, cts)
    elif riccati in ("parallel", "parallel_fast"):
        from ilqr_admm_tpu.ops.parallel_riccati import ilqr_backward_parallel

        if riccati == "parallel_fast":
            K, k = ilqr_backward_parallel(
                A, B, Cts, cts, block_size=128,
                fast_inverse=A.shape[-1] <= 4,
            )
        else:
            K, k = ilqr_backward_parallel(A, B, Cts, cts)
    else:
        K, k = ilqr_backward(A, B, Cts, cts)

    def rollout_alpha(alpha):
        return rollout_closed_loop(
            f, state.x_nom[0], K, alpha * k, state.x_nom, state.u_nom
        )

    xs_cand, us_cand = jax.vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    return new_state, accept, (K, k)


@highest_precision
def ilqr_iterate_batch(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state: ILQRState,
    alphas: jax.Array,
):
    """One batch iLQR iteration: lifted least-squares + open-loop line search.

    Reference `iterate_once_batch` / `backward_pass_batch`
    (`isls.py:156-225`). Returns (new_state, accept, delta_u).
    """
    N, d = state.x_nom.shape
    m = state.u_nom.shape[-1]
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)

    Su = build_Su(A, B)
    Cxx = Cts[:, :d, :d]
    Cuu = Cts[:, d:, d:]
    cx = cts[:, :d].reshape(-1)
    cu = cts[:, d:].reshape(-1)

    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked

    SuTQ = Su.T @ (0.5 * block_diag_stacked(Cxx))
    l_side = SuTQ @ Su + 0.5 * block_diag_stacked(Cuu)
    r_side = Su.T @ (-0.5 * cx) - 0.5 * cu
    delta_u = jnp.linalg.solve(l_side, r_side).reshape(N, m)

    def rollout_alpha(alpha):
        us = state.u_nom + alpha * delta_u
        xs = rollout_nonlinear(f, state.x_nom[0], us)
        return xs, us

    xs_cand, us_cand = jax.vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    return new_state, accept, delta_u


@highest_precision
def ilqr_iterate_sls(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state: ILQRState,
    alphas: jax.Array,
):
    """One SLS iLQR iteration: response-map synthesis + history-feedback
    line search.

    Completes the method triple the reference leaves unimplemented
    (`isls.py:121-122` raises NotImplementedError for method='sls').
    The inner step synthesizes the causal closed-loop response map
    (Phi_u, du) on the linearized problem (`ops/sls_synthesis.py`),
    recovers lifted history-feedback gains K = Phi_u Phi_x^{-1},
    k = (I - K Su) du (`sls.py:235-242` semantics, in delta coordinates
    around the nominal), and line-searches the feedforward only — each
    candidate rolled out with full history feedback on the deviation from
    the nominal (`isls_base.py:28-42`).

    Returns (new_state, accept, (K_lifted (Nm,Nd), k_lifted (Nm,))).
    """
    from ilqr_admm_tpu.ops.lifted import build_Sw
    from ilqr_admm_tpu.ops.rollout import rollout_sls_delta
    from ilqr_admm_tpu.ops.sls_synthesis import sls_synthesize
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked

    N, d = state.x_nom.shape
    m = state.u_nom.shape[-1]
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)

    Su = build_Su(A, B)
    Sw = build_Sw(A)
    Cxx = Cts[:, :d, :d]
    Cuu = Cts[:, d:, d:]
    cx = cts[:, :d].reshape(-1)
    cu = cts[:, d:].reshape(-1)

    SuTQ = Su.T @ (0.5 * block_diag_stacked(Cxx))
    l_side = SuTQ @ Su + 0.5 * block_diag_stacked(Cuu)
    r_ff = Su.T @ (-0.5 * cx) - 0.5 * cu
    r_fb = -SuTQ @ Sw
    PHI_U, du = sls_synthesize(l_side, r_ff, r_fb, m, d)

    # Gains in delta coordinates: K = Phi_u Phi_x^{-1}, Phi_x = Sw + Su Phi_u.
    PHI_X = Sw + Su @ PHI_U
    K = jnp.linalg.solve(PHI_X.T, PHI_U.T).T
    k = (jnp.eye(N * m, dtype=du.dtype) - K @ Su) @ du

    def rollout_alpha(alpha):
        return rollout_sls_delta(
            f, state.x_nom[0], K, alpha * k, state.x_nom, state.u_nom
        )

    xs_cand, us_cand = jax.vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    return new_state, accept, (K, k)


@highest_precision
def ilqr_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state0: ILQRState,
    cfg: ILQRConfig = ILQRConfig(),
    method: str = "dp",
    riccati: str = "chol",
) -> ILQRState:
    """Full iLQR solve as a jittable while_loop (vmap over instances works).

    Stops on cost change < tol_fun (CONVERGED), line-search failure
    (LINE_SEARCH_FAILED), or iteration cap (MAX_ITER) — reference
    `isls.py:125-132`.
    """
    alphas = line_search_alphas(cfg, state0.x_nom.dtype)
    if riccati not in ("chol", "sqrt", "parallel", "parallel_fast"):
        raise ValueError(
            "riccati must be 'chol', 'sqrt', 'parallel' or "
            f"'parallel_fast', got {riccati!r}"
        )
    if method == "dp":
        def iterate(*args):
            return ilqr_iterate_dp(*args, riccati=riccati)
    elif method == "sls":
        iterate = ilqr_iterate_sls
    elif method == "batch":
        iterate = ilqr_iterate_batch
    else:
        raise ValueError(
            f"method must be 'dp', 'sls' or 'batch', got {method!r}"
        )

    def cond(state):
        return jnp.logical_and(
            state.iteration < cfg.max_iter, state.status == SolveStatus.RUNNING
        )

    def body(state):
        new_state, accept, _ = iterate(f, get_AB, get_Cs, cost_fn, state, alphas)
        dcost = jnp.abs(new_state.cost - new_state.prev_cost)
        status = jnp.where(
            jnp.logical_not(accept),
            SolveStatus.LINE_SEARCH_FAILED,
            jnp.where(dcost < cfg.tol_fun, SolveStatus.CONVERGED, SolveStatus.RUNNING),
        ).astype(jnp.int32)
        return new_state._replace(status=status)

    out = lax.while_loop(cond, body, state0)
    return out._replace(
        status=jnp.where(
            out.status == SolveStatus.RUNNING, SolveStatus.MAX_ITER, out.status
        ).astype(jnp.int32)
    )
