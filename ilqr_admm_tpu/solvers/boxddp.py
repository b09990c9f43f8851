"""boxDDP: control-limited DDP with the box-QP backward pass.

First-class DP treatment of control bounds — the direct alternative to
`solvers/ilqr_admm.py`'s splitting for the common box-on-u case
(reference reaches this capability only via ADMM, `isls.py:379-501`;
its DDP-replicate notebook reproduces Tassa's control-limited car with
projections). Here the bounds live inside the Riccati recursion
(`ops/constrained_riccati.py`), iterates are feasible at every step
(clipped rollouts), and there are no penalty parameters to tune.

Same jit/vmap contract as `solvers/ilqr.py::ilqr_solve`: the whole solve
is a `lax.while_loop`, so it vmaps over problem instances and shards
over a ('data',) mesh axis via `parallel/batch.py`.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ilqr_admm_tpu.ops.constrained_riccati import (
    ilqr_backward_box,
    rollout_closed_loop_clipped,
)
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu.solvers.ilqr import ILQRState, _select_candidate
from ilqr_admm_tpu.utils.precision import highest_precision


def boxddp_init(f: Callable, cost_fn: Callable, x0, u0, u_lower, u_upper) -> ILQRState:
    """Clip the initial controls into the box, roll out, evaluate cost."""
    u0 = jnp.clip(u0, u_lower, u_upper)
    xs = rollout_nonlinear(f, x0, u0)
    c = cost_fn(xs, u0)
    return ILQRState(
        x_nom=xs, u_nom=u0, cost=c, prev_cost=jnp.asarray(jnp.inf, c.dtype),
        iteration=jnp.int32(0), status=jnp.int32(SolveStatus.RUNNING),
    )


@highest_precision
def boxddp_iterate(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state: ILQRState,
    alphas: jax.Array,
    u_lower,
    u_upper,
    reg: float = 0.0,
    qp_iters: int = 12,
    qp_method: str = "auto",
    riccati: str = "seq",
    mask_iters: int = 3,
    clamp=None,
):
    """One boxDDP iteration: box-QP backward pass + clipped line search.

    riccati='parallel' swaps the sequential per-stage box-QP scan for
    the associative-scan active-set backward
    (`ops/constrained_riccati.py::ilqr_backward_box_parallel`, O(log N)
    depth per pass) — the long-horizon option. Pass `clamp=(clamp_lo,
    clamp_hi)` to warm-start its active set (the return value then gains
    a fourth element: the post-exchange set to carry forward).
    """
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)
    if riccati not in ("seq", "parallel"):
        raise ValueError(f"riccati must be 'seq' or 'parallel', got {riccati!r}")
    clamp_new = None
    if riccati == "parallel":
        from ilqr_admm_tpu.ops.constrained_riccati import (
            ilqr_backward_box_parallel,
        )

        if clamp is None:
            K, k = ilqr_backward_box_parallel(
                A, B, Cts, cts, state.u_nom, u_lower, u_upper, reg=reg,
                mask_iters=mask_iters,
            )
        else:
            K, k, clamp_new = ilqr_backward_box_parallel(
                A, B, Cts, cts, state.u_nom, u_lower, u_upper, reg=reg,
                mask_iters=mask_iters, clamp0=clamp, return_clamp=True,
            )
    else:
        K, k = ilqr_backward_box(
            A, B, Cts, cts, state.u_nom, u_lower, u_upper, reg=reg,
            qp_iters=qp_iters, qp_method=qp_method,
        )

    def rollout_alpha(alpha):
        return rollout_closed_loop_clipped(
            f, state.x_nom[0], K, alpha * k, state.x_nom, state.u_nom,
            u_lower, u_upper,
        )

    xs_cand, us_cand = jax.vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    if clamp_new is not None:
        return new_state, accept, (K, k), clamp_new
    return new_state, accept, (K, k)


@highest_precision
def boxddp_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state0: ILQRState,
    u_lower,
    u_upper,
    cfg: ILQRConfig = ILQRConfig(),
    reg: float = 0.0,
    qp_iters: int = 12,
    qp_method: str = "auto",
    reg_min: float = 1e-6,
    reg_max: float = 1e8,
    reg_factor: float = 10.0,
    reg_down: float | None = None,
    riccati: str = "seq",
    mask_iters: int = 1,
) -> ILQRState:
    """Full boxDDP solve as a jittable while_loop (vmaps over instances).

    Every accepted iterate satisfies the control bounds exactly (clipped
    rollouts) — unlike ADMM, where feasibility holds only at the
    splitting tolerance.

    Line-search failures escalate a Levenberg-Marquardt regularization
    on Quu (Tassa ICRA'14 schedule: multiply by `reg_factor` and retry,
    starting from max(reg, reg_min); divide back down on acceptance) —
    round 2 terminated on the FIRST failed line search, stalling the
    N=500 car above the 1.905 optimum (3.17 on CPU).
    Termination is LINE_SEARCH_FAILED only once the regularization
    exceeds `reg_max`. Retry iterations count toward cfg.max_iter.

    riccati='parallel' (r4): the exactness-certified time-parallel
    backward. The active set is carried in the while_loop and
    warm-started across outer iterations; mask_iters=1 (default) runs
    one masked pass + one primal-dual exchange per outer iteration —
    the cheapest AND most robust setting, because every exchange is
    vetted by a line search before the next. Higher mask_iters takes
    several unvetted set exchanges per backward, which changes the
    iteration PATH on nonconvex problems and can land in a different
    local basin (on the N=500 car: mi=1 -> 1.90535, the sequential
    pass's cost; mi=2 converges — in f64 too, so not a precision artifact — to an
    alternate 1.975 basin). Late-r4 the backward returns the
    lowest-KKT-violation pass of the exchange iteration instead of the
    last, which bounds the damage of f32 set oscillation within one
    call (the degraded CPU-f32 path improves monotonically with
    mask_iters where it previously regressed) without perturbing
    convergent exchanges (bit-identical there; cold-start exactness
    vs the sequential backward is test-pinned). Basin selection on
    saturated nonconvex tasks still wants mask_iters=1. KKT-certified
    vs the sequential backward by `box_kkt_residual` (test_boxddp).
    """
    alphas = line_search_alphas(cfg, state0.x_nom.dtype)
    dtype = state0.x_nom.dtype
    if reg_down is None:
        reg_down = reg_factor
    parallel = riccati == "parallel"
    N, m = state0.u_nom.shape

    def cond(carry):
        state = carry[0]
        return jnp.logical_and(
            state.iteration < cfg.max_iter, state.status == SolveStatus.RUNNING
        )

    def body(carry):
        state, lam, clamp = carry
        if parallel:
            # warm-started active set: carried across outer iterations,
            # so the Jacobi exchange only has to track set *changes*
            # (the set stabilizes after a few outers)
            new_state, accept, _, clamp = boxddp_iterate(
                f, get_AB, get_Cs, cost_fn, state, alphas,
                u_lower, u_upper, reg=reg + lam,
                riccati="parallel", mask_iters=mask_iters, clamp=clamp,
            )
        else:
            new_state, accept, _ = boxddp_iterate(
                f, get_AB, get_Cs, cost_fn, state, alphas,
                u_lower, u_upper, reg=reg + lam, qp_iters=qp_iters,
                qp_method=qp_method, riccati=riccati,
            )
        # regularization schedule: up on reject (retry), down on accept
        lam_up = jnp.maximum(lam * reg_factor, reg_min)
        lam_dn = jnp.where(lam <= reg_min * 1.01, 0.0, lam / reg_down)
        lam_new = jnp.where(accept, lam_dn, lam_up).astype(dtype)

        dcost = jnp.abs(new_state.cost - new_state.prev_cost)
        status = jnp.where(
            jnp.logical_not(accept),
            # rejected step: retry at higher reg unless it's exhausted
            jnp.where(
                lam_new > reg_max, SolveStatus.LINE_SEARCH_FAILED,
                SolveStatus.RUNNING,
            ),
            jnp.where(dcost < cfg.tol_fun, SolveStatus.CONVERGED, SolveStatus.RUNNING),
        ).astype(jnp.int32)
        return new_state._replace(status=status), lam_new, clamp

    # all-free initial set: the first masked pass is then exactly the
    # unconstrained pass + crossing-based exchange (the cold seed)
    clamp0 = (jnp.zeros((N, m), bool), jnp.zeros((N, m), bool))
    out, _, _ = lax.while_loop(
        cond, body, (state0, jnp.asarray(0.0, dtype), clamp0)
    )
    return out._replace(
        status=jnp.where(
            out.status == SolveStatus.RUNNING, SolveStatus.MAX_ITER, out.status
        ).astype(jnp.int32)
    )
