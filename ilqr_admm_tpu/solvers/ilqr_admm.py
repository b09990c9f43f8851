"""Constrained iLQR via ADMM splitting (ilqr_admm).

Functional equivalent of `iSLS.ilqr_admm` (reference `isls.py:379-501`):
outer loop relinearizes dynamics/cost around the nominal; the inner ADMM
x-update solves the regularized lifted least-squares *with the parallel
line search inside* and scores candidates with the augmented (penalty)
cost (`isls.py:456-478`). z/λ are warm-started across outer iterations
(`isls.py:488-490`); the outer loop stops on cost-change or oscillation
detection (`isls.py:493-499`).

The ADMM consensus variables are absolute flattened trajectories
(N*x_dim,) / (N*u_dim,), so projection closures written for the reference
notebooks port directly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_factor, cho_solve

from ilqr_admm_tpu.ops.lifted import build_Su
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho


class ILQRADMMResult(NamedTuple):
    x_nom: jax.Array
    u_nom: jax.Array
    cost: jax.Array
    outer_iters: jax.Array
    status: jax.Array
    cost_log: jax.Array  # (max_iter,) outer-iteration costs (inf beyond)
    # final ADMM consensus/dual state — warm-start the next solve with
    # these (receding-horizon MPC reuses them across ticks)
    z_x: jax.Array = None
    z_u: jax.Array = None
    lmb_x: jax.Array = None
    lmb_u: jax.Array = None


def _ilqr_admm_impl(
    f: Callable,
    get_AB: Callable,
    cost_fn: Callable,
    x_nom0,
    u_nom0,
    get_Cs: Optional[Callable] = None,
    quad_cost=None,  # QuadCost when the cost is quadratic (get_Cs None)
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    max_iter: int = 20,
    max_admm_iter: int = 20,
    alphas: Optional[jax.Array] = None,
    alpha: float = 1.0,
    tol: float = 1e-3,
    outer_tol: float = 1e-3,
    osc_tol: float = 1e-3,
    method: str = "batch",
    riccati: str = "chol",
    warm=None,  # optional (z_x, z_u, lmb_x, lmb_u) flattened warm start
    unroll: int = 8,
    line_search: str = "inner",
    anderson_m: int = 0,
) -> ILQRADMMResult:
    """Run constrained iLQR-ADMM from a nominal trajectory guess.

    method='batch': lifted least-squares x-update (reference behavior).
    method='dp': Riccati x-update with closed-loop line search — O(N)
    memory (no dense lifted matrices), the solution the reference left
    as "TODO: add dp solution" (`isls.py:411`). Preferred for long
    horizons; riccati='sqrt' uses the array-form backward pass
    (f32-stable at stiff weights; Cux cross terms handled by completion
    of squares).

    unroll: scan-unroll factor for the line-search rollouts — the inner
    ADMM runs one N-step rollout batch per iteration, and per-step scan
    overhead dominates at small state dims; unroll=8 is bit-identical
    math with fewer loop steps.

    line_search ('inner' | 'outer', batch method only):
    'inner' is the reference semantics (`isls.py:456-478`) — every inner
    ADMM iteration rolls out the whole alpha grid and scores candidates
    with the augmented cost. 'outer' is the SQP-style variant: the inner
    ADMM iterates on the *linearized* trajectory prediction
    x = x_nom + Su (u - u_nom) with NO rollouts at all (each iteration is
    one prefactored solve + projections, exactly lqt_admm on the local
    model), and ONE nonlinear line search per outer iteration globalizes
    the resulting step. One rollout batch per outer step instead of
    max_admm_iter of them — the dominant cost at long horizons, where
    rollout latency is transcendental-chain-bound (RESULTS.md r2 study).
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if line_search not in ("inner", "outer"):
        raise ValueError(
            f"line_search must be 'inner' or 'outer', got {line_search!r}"
        )
    if method == "dp":
        if line_search != "inner":
            raise ValueError(
                "line_search='outer' is only supported with method='batch' "
                "(the dp x-update's line search is closed-loop by design)"
            )
        return _ilqr_admm_dp(
            f, get_AB, cost_fn, x_nom0, u_nom0, get_Cs, quad_cost,
            project_x, project_u, rho_x, rho_u, max_iter, max_admm_iter,
            alphas, alpha, tol, outer_tol, osc_tol, riccati, warm, unroll,
            anderson_m=anderson_m,
        )
    if method != "batch":
        raise ValueError(f"method must be 'dp' or 'batch', got {method!r}")
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    dtype = x_nom0.dtype
    if alphas is None:
        alphas = 10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=dtype)[:20]

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)
    Qr_l = block_diag_stacked(Qr) if (Qr is not None and project_x is not None) else None
    Rr_l = block_diag_stacked(Rr) if (Rr is not None and project_u is not None) else None

    admm_cfg = ADMMConfig(
        max_iter=max_admm_iter, alpha=alpha, tol=tol, anderson_m=anderson_m
    )

    def outer_body(carry):
        x_nom, u_nom, cost, it, status, z_x, z_u, l_x, l_u, cost_log = carry
        A, B = get_AB(x_nom, u_nom)
        Su = build_Su(A, B)
        x_nom_f = x_nom.reshape(-1)
        u_nom_f = u_nom.reshape(-1)

        if get_Cs is not None:
            cts, Cts = get_Cs(x_nom, u_nom)
            Cxx = block_diag_stacked(Cts[:, :d, :d])
            Cuu = block_diag_stacked(Cts[:, d:, d:])
            cx = cts[:, :d].reshape(-1)
            cu = cts[:, d:].reshape(-1)
            SuTQ = Su.T @ (0.5 * Cxx)
            l_side = SuTQ @ Su + 0.5 * Cuu
            r_side = Su.T @ (-0.5 * cx) - 0.5 * cu
        else:
            Qlift = block_diag_stacked(quad_cost.Q)
            Rlift = block_diag_stacked(quad_cost.R)
            SuTQ = Su.T @ Qlift
            l_side = SuTQ @ Su + Rlift
            r_side = SuTQ @ (quad_cost.lifted_xd() - x_nom_f) + Rlift @ (-u_nom_f)

        SuTQr = None
        if Qr_l is not None:
            SuTQr = Su.T @ Qr_l
            l_side = l_side + SuTQr @ Su
        if Rr_l is not None:
            l_side = l_side + Rr_l
        cf = cho_factor(l_side)

        def f_argmin(x, u):
            add_r = jnp.zeros_like(r_side)
            if SuTQr is not None and x is not None:
                add_r = add_r + SuTQr @ (x - x_nom_f)
            if Rr_l is not None and u is not None:
                add_r = add_r + Rr_l @ (u - u_nom_f)
            delta_u = cho_solve(cf, r_side + add_r).reshape(N, m)

            us_c = u_nom[None] + alphas[:, None, None] * delta_u[None]
            xs_c = jax.vmap(
                lambda us: rollout_nonlinear(f, x_nom[0], us, unroll=unroll)
            )(us_c)
            costs = jax.vmap(cost_fn)(xs_c, us_c)
            costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
            # augmented-cost candidate scoring (`isls.py:470-477`) —
            # blockwise over the stacked penalties: the dense (Nd, Nd)
            # form costs (Nd)^2 per candidate where the block-diagonal
            # structure only needs N d^2
            if Qr_l is not None and x is not None:
                dx = xs_c - x.reshape(N, d)
                costs = costs + jnp.einsum("ati,tij,atj->a", dx, Qr, dx)
            if Rr_l is not None and u is not None:
                du_ = us_c - u.reshape(N, m)
                costs = costs + jnp.einsum("ati,tij,atj->a", du_, Rr, du_)
            ind = jnp.argmin(costs)
            return xs_c[ind].reshape(-1), us_c[ind].reshape(-1)

        if line_search == "outer":
            # Explicit inverse instead of per-iteration cho_solve: the
            # inner ADMM runs many rollout-free iterations whose only
            # heavy op is this solve, and a pair of serial triangular
            # solves (single RHS) is a latency chain where one one-time
            # multi-RHS solve + a GEMV per iteration is cheap.
            # l_side is rho-regularized SPD and traced under HIGHEST, so
            # the explicit inverse is accurate here (f32 matches the CPU
            # f64 oracle to 4 digits, bench_outer_ls.py).
            Minv = cho_solve(cf, jnp.eye(N * m, dtype=dtype))

        def f_argmin_lin(x, u):
            # SQP-style x-update: solve on the linearized trajectory
            # prediction, no rollouts (line_search='outer')
            add_r = jnp.zeros_like(r_side)
            if SuTQr is not None and x is not None:
                add_r = add_r + SuTQr @ (x - x_nom_f)
            if Rr_l is not None and u is not None:
                add_r = add_r + Rr_l @ (u - u_nom_f)
            delta_u = Minv @ (r_side + add_r)
            return x_nom_f + Su @ delta_u, u_nom_f + delta_u

        x_x, x_u, _, l_x_n, l_u_n, z_x_n, z_u_n, _info = admm_solve(
            f_argmin if line_search == "inner" else f_argmin_lin,
            project_x, project_u, (N * d,), (N * m,), admm_cfg,
            z_x_init=z_x, z_u_init=z_u, lmb_x_init=l_x, lmb_u_init=l_u, dtype=dtype,
        )

        if line_search == "outer":
            # ONE nonlinear line search per outer step globalizes the
            # linear-model ADMM solution; candidates scored by the true
            # cost plus penalties toward the final consensus targets
            delta_u = (x_u - u_nom_f).reshape(N, m)
            us_c = u_nom[None] + alphas[:, None, None] * delta_u[None]
            xs_c = jax.vmap(
                lambda us: rollout_nonlinear(f, x_nom[0], us, unroll=unroll)
            )(us_c)
            costs = jax.vmap(cost_fn)(xs_c, us_c)
            costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
            if Qr_l is not None:
                tx = (z_x_n - l_x_n).reshape(N, d)
                dxc = xs_c - tx[None]
                costs = costs + jnp.einsum("ati,tij,atj->a", dxc, Qr, dxc)
            if Rr_l is not None:
                tu = (z_u_n - l_u_n).reshape(N, m)
                duc = us_c - tu[None]
                costs = costs + jnp.einsum("ati,tij,atj->a", duc, Rr, duc)
            ind = jnp.argmin(costs)
            x_new = xs_c[ind]
            u_new = us_c[ind]
        else:
            x_new = x_x.reshape(N, d)
            u_new = x_u.reshape(N, m)
        cost_new = cost_fn(x_new, u_new)
        cost_log = cost_log.at[it].set(cost_new)

        converged = jnp.abs(cost_new - cost) < outer_tol
        recent = lax.dynamic_slice(
            jnp.concatenate([jnp.full((8,), jnp.inf, dtype), cost_log]), (it + 1,), (8,)
        )
        osc = jnp.abs(jnp.mean(recent[4:]) - jnp.mean(recent[:4])) < osc_tol
        status_new = jnp.where(
            converged,
            SolveStatus.CONVERGED,
            jnp.where(osc, SolveStatus.OSCILLATING, SolveStatus.RUNNING),
        ).astype(jnp.int32)
        return (x_new, u_new, cost_new, it + 1, status_new, z_x_n, z_u_n, l_x_n, l_u_n, cost_log)

    def outer_cond(carry):
        _, _, _, it, status, *_ = carry
        return jnp.logical_and(it < max_iter, status == SolveStatus.RUNNING)

    cost0 = cost_fn(x_nom0, u_nom0)
    if warm is None:
        warm = (
            jnp.zeros((N * d,), dtype), jnp.zeros((N * m,), dtype),
            jnp.zeros((N * d,), dtype), jnp.zeros((N * m,), dtype),
        )
    carry0 = (
        x_nom0, u_nom0, cost0, jnp.int32(0), jnp.int32(SolveStatus.RUNNING),
        warm[0], warm[1], warm[2], warm[3],
        jnp.full((max_iter,), jnp.inf, dtype),
    )
    x_nom, u_nom, cost, it, status, z_x, z_u, l_x, l_u, cost_log = lax.while_loop(
        outer_cond, outer_body, carry0
    )
    status = jnp.where(status == SolveStatus.RUNNING, SolveStatus.MAX_ITER, status).astype(jnp.int32)
    return ILQRADMMResult(
        x_nom=x_nom, u_nom=u_nom, cost=cost, outer_iters=it, status=status,
        cost_log=cost_log, z_x=z_x, z_u=z_u, lmb_x=l_x, lmb_u=l_u,
    )


def _ilqr_admm_dp(
    f, get_AB, cost_fn, x_nom0, u_nom0, get_Cs, quad_cost,
    project_x, project_u, rho_x, rho_u, max_iter, max_admm_iter,
    alphas, alpha, tol, outer_tol, osc_tol, riccati="chol", warm=None,
    unroll: int = 8,
    anderson_m: int = 0,
) -> ILQRADMMResult:
    """DP (Riccati) x-update iLQR-ADMM — scan-based, O(N) memory."""
    from ilqr_admm_tpu.ops.riccati import ilqr_backward, quad_cost_model
    from ilqr_admm_tpu.ops.rollout import rollout_closed_loop

    if riccati == "sqrt":
        from ilqr_admm_tpu.ops.sqrt_riccati import ilqr_backward_sqrt as backward
    else:
        backward = ilqr_backward

    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    dtype = x_nom0.dtype
    if alphas is None:
        alphas = 10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=dtype)[:20]

    Qr = broadcast_rho(rho_x, d, N, dtype)
    Rr = broadcast_rho(rho_u, m, N, dtype)
    has_x = project_x is not None and Qr is not None
    has_u = project_u is not None and Rr is not None

    admm_cfg = ADMMConfig(
        max_iter=max_admm_iter, alpha=alpha, tol=tol, anderson_m=anderson_m
    )

    def get_model(x_nom, u_nom):
        if get_Cs is not None:
            return get_Cs(x_nom, u_nom)
        return quad_cost_model(quad_cost.Q, quad_cost.xd, quad_cost.R, x_nom, u_nom)

    def outer_body(carry):
        x_nom, u_nom, cost, it, status, z_x, z_u, l_x, l_u, cost_log = carry
        A, B = get_AB(x_nom, u_nom)
        cts, Cts = get_model(x_nom, u_nom)

        def f_argmin(x, u):
            # augment the quadratic model with the ADMM penalties
            # (delta coordinates around the nominal)
            cts_a, Cts_a = cts, Cts
            if has_x and x is not None:
                xr = x.reshape(N, d)
                cts_a = cts_a.at[:, :d].add(
                    2.0 * jnp.einsum("tij,tj->ti", Qr, x_nom - xr)
                )
                Cts_a = Cts_a.at[:, :d, :d].add(2.0 * Qr)
            if has_u and u is not None:
                ur = u.reshape(N, m)
                cts_a = cts_a.at[:, d:].add(
                    2.0 * jnp.einsum("tij,tj->ti", Rr, u_nom - ur)
                )
                Cts_a = Cts_a.at[:, d:, d:].add(2.0 * Rr)

            K, k = backward(A, B, Cts_a, cts_a)

            def rollout_alpha(a):
                return rollout_closed_loop(
                    f, x_nom[0], K, a * k, x_nom, u_nom, unroll=unroll
                )

            xs_c, us_c = jax.vmap(rollout_alpha)(alphas)
            costs = jax.vmap(cost_fn)(xs_c, us_c)
            costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
            if has_x and x is not None:
                dx = xs_c - x.reshape(N, d)
                costs = costs + jnp.einsum("ati,tij,atj->a", dx, Qr, dx)
            if has_u and u is not None:
                du_ = us_c - u.reshape(N, m)
                costs = costs + jnp.einsum("ati,tij,atj->a", du_, Rr, du_)
            ind = jnp.argmin(costs)
            return xs_c[ind].reshape(-1), us_c[ind].reshape(-1)

        x_x, x_u, _, l_x_n, l_u_n, z_x_n, z_u_n, _info = admm_solve(
            f_argmin, project_x, project_u, (N * d,), (N * m,), admm_cfg,
            z_x_init=z_x, z_u_init=z_u, lmb_x_init=l_x, lmb_u_init=l_u, dtype=dtype,
        )

        x_new = x_x.reshape(N, d)
        u_new = x_u.reshape(N, m)
        cost_new = cost_fn(x_new, u_new)
        cost_log = cost_log.at[it].set(cost_new)

        converged = jnp.abs(cost_new - cost) < outer_tol
        recent = lax.dynamic_slice(
            jnp.concatenate([jnp.full((8,), jnp.inf, dtype), cost_log]), (it + 1,), (8,)
        )
        osc = jnp.abs(jnp.mean(recent[4:]) - jnp.mean(recent[:4])) < osc_tol
        status_new = jnp.where(
            converged,
            SolveStatus.CONVERGED,
            jnp.where(osc, SolveStatus.OSCILLATING, SolveStatus.RUNNING),
        ).astype(jnp.int32)
        return (x_new, u_new, cost_new, it + 1, status_new, z_x_n, z_u_n, l_x_n, l_u_n, cost_log)

    def outer_cond(carry):
        _, _, _, it, status, *_ = carry
        return jnp.logical_and(it < max_iter, status == SolveStatus.RUNNING)

    cost0 = cost_fn(x_nom0, u_nom0)
    if warm is None:
        warm = (
            jnp.zeros((N * d,), dtype), jnp.zeros((N * m,), dtype),
            jnp.zeros((N * d,), dtype), jnp.zeros((N * m,), dtype),
        )
    carry0 = (
        x_nom0, u_nom0, cost0, jnp.int32(0), jnp.int32(SolveStatus.RUNNING),
        warm[0], warm[1], warm[2], warm[3],
        jnp.full((max_iter,), jnp.inf, dtype),
    )
    x_nom, u_nom, cost, it, status, z_x, z_u, l_x, l_u, cost_log = lax.while_loop(
        outer_cond, outer_body, carry0
    )
    status = jnp.where(status == SolveStatus.RUNNING, SolveStatus.MAX_ITER, status).astype(jnp.int32)
    return ILQRADMMResult(
        x_nom=x_nom, u_nom=u_nom, cost=cost, outer_iters=it, status=status,
        cost_log=cost_log, z_x=z_x, z_u=z_u, lmb_x=l_x, lmb_u=l_u,
    )


def ilqr_admm(*args, **kwargs) -> ILQRADMMResult:
    """See `_ilqr_admm_impl`. Traced under HIGHEST matmul precision —
    the lifted solves are too ill-conditioned for reduced-precision
    default f32 matmuls, e.g. TF32 on the GPU (SURVEY §7
    numerical-parity hard part)."""
    with jax.default_matmul_precision("highest"):
        return _ilqr_admm_impl(*args, **kwargs)


ilqr_admm.__wrapped__ = _ilqr_admm_impl


def _rescale_dual(lmb, rho_old, rho_new, dim, N):
    """Scaled-dual transport across a penalty change.

    Scaled form carries lambda = P^{-1} y; keeping the *unscaled* dual y
    continuous across rho_old -> rho_new means
    lambda_new = P_new^{-1} P_old lambda_old (blockwise)."""
    if rho_old is None or rho_new is None:
        return lmb
    P_old = broadcast_rho(rho_old, dim, N, lmb.dtype)
    P_new = broadcast_rho(rho_new, dim, N, lmb.dtype)
    if P_old is None or P_new is None:
        return lmb
    y = jnp.einsum("nij,nj->ni", P_old, lmb.reshape(N, dim))
    return jnp.linalg.solve(P_new, y[..., None])[..., 0].reshape(-1)


def ilqr_admm_continuation(
    f, get_AB, cost_fn, x_nom0, u_nom0, phases, **kwargs
) -> ILQRADMMResult:
    """Penalty-continuation iLQR-ADMM: chain solves over a rho schedule.

    A large rho enforces constraints fast but biases the solution; a
    small rho converges to the tight optimum but slowly. Continuation
    runs a few outer iterations at a coarse rho, then refines at the
    fine rho, warm-starting (z, lambda) with the scaled duals rescaled
    so the *unscaled* duals are continuous across the penalty change
    (same mechanism as the adaptive-rho driver's rescaling). On the
    control-limited car this reaches the reference's golden cost where
    a single fine-rho schedule needs ~2x the iterations (HEADTOHEAD).

    phases: sequence of dicts, each with per-phase overrides — at least
    {'max_iter': ...} plus any of rho_x, rho_u, max_admm_iter, tol,
    outer_tol, osc_tol. Later phases inherit the nominal trajectory and
    rescaled ADMM state of the previous phase. Shared settings go in
    **kwargs (projections, alphas, method, ...). Jit the whole call for
    dispatch-free chaining.
    """
    if not phases:
        raise ValueError("phases must be a non-empty sequence of dicts")
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    res = None
    prev = None
    x_nom, u_nom = x_nom0, u_nom0
    warm = kwargs.pop("warm", None)
    for ph in phases:
        kw = dict(kwargs)
        kw.update(ph)
        if res is not None:
            lmb_x = _rescale_dual(
                res.lmb_x, prev.get("rho_x", kwargs.get("rho_x")),
                kw.get("rho_x", kwargs.get("rho_x")), d, N,
            )
            lmb_u = _rescale_dual(
                res.lmb_u, prev.get("rho_u", kwargs.get("rho_u")),
                kw.get("rho_u", kwargs.get("rho_u")), m, N,
            )
            warm = (res.z_x, res.z_u, lmb_x, lmb_u)
            x_nom, u_nom = res.x_nom, res.u_nom
        res = ilqr_admm(f, get_AB, cost_fn, x_nom, u_nom, warm=warm, **kw)
        prev = kw
    return res
