"""Reference-compatible object facade over the functional core.

`SLS` and `iSLS` mirror the reference public API (`isls/__init__.py:1-4`,
`sls.py`, `isls.py`) so that reference users can switch directly; every
method delegates to the jit/vmap-ready functional solvers in
`ilqr_admm_tpu.solvers`. The facade also smooths the reference's API
drift (SURVEY §2 defect list): `set_cost_variables` ≡
`set_quadratic_cost`, `solve_ilqr(...)` ≡ `solve(...)`, and both
`tol=`/`threshold=` spellings are accepted.

Conventions (same as reference): trajectories are (N, dim); lifted
vectors are flattened row-major; user `forward_model(x, u)` maps a single
state/control pair to the next state (pure JAX); user `cost_function(xs,
us)` maps one trajectory to a scalar (the facade vmaps it over batches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ilqr_admm_tpu.ops.lifted import build_Su, build_Sw
from ilqr_admm_tpu.ops.riccati import quad_cost_model
from ilqr_admm_tpu.ops.rollout import (
    rollout_closed_loop,
    rollout_nonlinear,
    rollout_sls_delta,
)
from ilqr_admm_tpu.problem import ADMMConfig, broadcast_AB
from ilqr_admm_tpu.solvers.ilqr import (
    ILQRState,
    ilqr_iterate_batch,
    ilqr_iterate_dp,
)
from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm as _ilqr_admm
from ilqr_admm_tpu.solvers.isls_admm import isls_admm as _isls_admm
from ilqr_admm_tpu.solvers.lqt import (
    broadcast_rho,
    lqt_solve_batch,
    lqt_solve_dp,
    lqt_solve_sls,
    replan_feedforward,
    replanning_matrix,
    sls_controller,
)
from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_batch, lqt_admm_dp
from ilqr_admm_tpu.solvers.sls_admm import sls_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu.utils.precision import highest_precision


def _dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class _Base:
    """Shared state: dims, stacked dynamics, quadratic cost."""

    def __init__(self, x_dim: int, u_dim: int, N: int):
        self.x_dim = x_dim
        self.u_dim = u_dim
        self.N = N
        self.A = None  # (N, x, x) stacked
        self.B = None  # (N, x, u)
        self.quad_cost = None  # QuadCost
        self._Su = None
        self._Sw = None
        self._stiffness = None  # cached stiffness_ratio of quad_cost

    # -- dynamics ----------------------------------------------------------
    @property
    def AB(self):
        return [self.A, self.B]

    @AB.setter
    def AB(self, value):
        A, B = value[0], value[1]
        self.A, self.B = broadcast_AB(
            jnp.asarray(A, _dtype()), jnp.asarray(B, _dtype()), self.N
        )
        self._Su = None
        self._Sw = None

    @property
    def Su(self):
        """Dense lifted input-response operator (N*x, N*u)."""
        if self._Su is None:
            self._Su = build_Su(self.A, self.B)
        return self._Su

    @property
    def Sw(self):
        """Dense lifted noise/initial-state response operator (N*x, N*x)."""
        if self._Sw is None:
            self._Sw = build_Sw(self.A)
        return self._Sw

    # -- cost --------------------------------------------------------------
    def set_quadratic_cost(self, zs, Qs, seq, u_std):
        """Via-point quadratic cost (reference `base.py:81-89`)."""
        self.zs = jnp.asarray(zs, _dtype())
        self.Qs = jnp.asarray(Qs, _dtype())
        self.seq = np.asarray(seq)
        self.Rt = jnp.eye(self.u_dim, dtype=_dtype()) * u_std
        self.quad_cost = viapoint_cost(self.zs, self.Qs, self.seq, u_std, self.u_dim)
        from ilqr_admm_tpu.utils.precision import stiffness_ratio

        self._stiffness = stiffness_ratio(self.quad_cost.Q, self.quad_cost.R)
        if not jax.config.jax_enable_x64:
            ratio = self._stiffness
            if ratio > 1e7:
                import warnings

                warnings.warn(
                    f"cost weight ratio {ratio:.1e} exceeds float32 capability "
                    "(~1e7); enable float64 "
                    "(ilqr_admm_tpu.utils.precision.use_x64()) or rescale the "
                    "weights, or solvers may fail to improve / NaN.",
                    stacklevel=2,
                )

    # reference notebooks use this older name (SURVEY §2 API drift)
    set_cost_variables = set_quadratic_cost

    def _auto_use_qr(self) -> bool:
        """Pick the square-root (QR) x-update automatically: stiff cost
        under f32 (docs/architecture.md §4). Uses the stiffness ratio
        cached by set_quadratic_cost."""
        if self._stiffness is None:
            from ilqr_admm_tpu.utils.precision import stiffness_ratio

            self._stiffness = stiffness_ratio(self.quad_cost.Q, self.quad_cost.R)
        return (not jax.config.jax_enable_x64) and self._stiffness > 1e5

    @property
    def Q(self):
        return None if self.quad_cost is None else self.quad_cost.lifted_Q()

    @property
    def R(self):
        return None if self.quad_cost is None else self.quad_cost.lifted_R()

    @property
    def xd(self):
        return None if self.quad_cost is None else self.quad_cost.lifted_xd()

    def compute_Rr_Qr(self, rho_x, rho_u, dp: bool = True):
        """ADMM penalty broadcast (reference `base.py:55-79`) — stacked form."""
        del dp  # stacked (N, d, d) is canonical here
        return (
            broadcast_rho(rho_x, self.x_dim, self.N, _dtype()),
            broadcast_rho(rho_u, self.u_dim, self.N, _dtype()),
        )

    @highest_precision
    def compute_cost(self, x, u=None, cost_function=None):
        """Quadratic cost of (batched) lifted or stacked trajectories.

        Reference `sls_base.py:25-44`: accepts (N*d,), (N, d) or
        (batch, N*d) / (batch, N, d) x and optional u.
        """
        if cost_function is not None:
            return cost_function(x=x, u=u)

        def as_stacked(arr, dim, name):
            # stacked if the trailing two dims are exactly (N, dim);
            # lifted if the last dim is exactly N*dim — sized rules, not
            # the old last-dim==dim guess (which dropped the batch axis
            # of an (batch, N*dim) lifted input whenever N*dim == dim)
            arr = jnp.asarray(arr)
            if arr.ndim >= 2 and arr.shape[-2:] == (self.N, dim):
                return arr
            if arr.shape[-1] == self.N * dim:
                return arr.reshape(arr.shape[:-1] + (self.N, dim))
            raise ValueError(
                f"{name} must be stacked (..., {self.N}, {dim}) or lifted "
                f"(..., {self.N * dim}); got shape {arr.shape}"
            )

        xs = as_stacked(x, self.x_dim, "x")
        dx = xs - self.quad_cost.xd
        c = jnp.einsum("...ti,tij,...tj->...", dx, self.quad_cost.Q, dx)
        if u is not None:
            us = as_stacked(u, self.u_dim, "u")
            c = c + jnp.einsum("...ti,tij,...tj->...", us, self.quad_cost.R, us)
        return c

    def _noise(self, shape, noise_scale, rng):
        if noise_scale == 0:
            return None
        rng = np.random.default_rng() if rng is None else rng
        return jnp.asarray(rng.normal(0.0, noise_scale, shape), _dtype())


class SLS(_Base):
    """Linear LQT / SLS solver facade (reference `sls.py:8-454`).

    Methods: `solve` (batch / dp / sls), `ADMM_LQT_Batch`, `ADMM_LQT_DP`,
    `ADMM_SLS`, `controller`, rollout simulators, replanning.
    """

    def __init__(self, x_dim: int, u_dim: int, N: int):
        super().__init__(x_dim, u_dim, N)
        self.PHI_U = None
        self.du = None

    # ------------------------------------------------------------- solves
    def solve(self, x0=None, method: str = "sls"):
        if method == "batch":
            assert x0 is not None, "x0 required for the batch method"
            return self.solve_batch(x0)
        if method == "dp":
            return self.solve_dp()
        if method == "sls":
            return self.solve_sls()
        raise ValueError(f"unknown method {method!r}")

    def solve_batch(self, x0, use_qr=None):
        x0 = jnp.asarray(x0, _dtype())
        if use_qr is None:
            use_qr = self._auto_use_qr()
        return lqt_solve_batch(self.A, self.B, self.quad_cost, x0, use_qr=use_qr)

    def solve_dp(
        self, Qr=None, Rr=None, ur=None, xr=None, return_Qs: bool = False,
        time_parallel=None, fast_inverse: bool = False,
    ):
        """time_parallel: None = sequential scan; 'flat' = associative
        scan; int L = blocked suffix scan (long horizons); fast_inverse:
        adjugate combine inverses (state dim <= 4) on the time-parallel
        paths — see
        `solvers/lqt.py::lqt_solve_dp`."""
        gains = lqt_solve_dp(
            self.A, self.B, self.quad_cost, Qr=Qr, xr=xr, Rr=Rr, ur=ur,
            time_parallel=time_parallel, fast_inverse=fast_inverse,
        )
        if return_Qs:
            return gains.K, gains.k, gains.Quu, gains.Quu_inv, gains.Qux
        return gains.K, gains.k

    def solve_dp_ff(self, K, Quu, Qux, Quu_inv, Qr=None, Rr=None, ur=None, xr=None):
        """Feedforward-only re-sweep with cached DP blocks (reference
        `sls.py:168-202`). Returns k (N, u_dim)."""
        from ilqr_admm_tpu.ops.riccati import DPGains, lqt_backward_ff

        gains = DPGains(
            K=jnp.asarray(K, _dtype()), k=jnp.zeros((self.N, self.u_dim), _dtype()),
            Quu=jnp.asarray(Quu, _dtype()), Quu_inv=jnp.asarray(Quu_inv, _dtype()),
            Qux=jnp.asarray(Qux, _dtype()),
        )
        xr_ = None if xr is None else jnp.asarray(xr, _dtype()).reshape(self.N, self.x_dim)
        ur_ = None if ur is None else jnp.asarray(ur, _dtype()).reshape(self.N, self.u_dim)
        return lqt_backward_ff(
            gains, self.A, self.B, self.quad_cost.Q, self.quad_cost.xd,
            Qr=Qr, xr=xr_, Rr=Rr, ur=ur_,
        )

    def solve_sls(self, verbose: bool = False):
        del verbose
        PHI_U, du = lqt_solve_sls(self.A, self.B, self.quad_cost)
        self.PHI_U, self.du = PHI_U, du
        return PHI_U, du

    def controller(self, PHI_U, du):
        return sls_controller(self.A, self.B, PHI_U, du)

    def initialize_replanning_procedure(self, K):
        self.replan_matrix = replanning_matrix(self.A, self.B, self.quad_cost, K)

    def replan_feedforward(self, k, xd):
        return replan_feedforward(k, self.replan_matrix, jnp.asarray(xd), self.xd)

    # ---------------------------------------------------------- rollouts
    def forward_model(self, x, u):
        """Single-pair linear step using the first-step dynamics."""
        return self.A[0] @ x + self.B[0] @ u

    def u_optimal(self, x0, PHI_U, du):
        return (PHI_U[:, : self.x_dim] @ x0 + du).reshape(self.N, -1)[:-1]

    def x_optimal(self, x0, PHI_X, dx):
        return (PHI_X[:, : self.x_dim] @ x0 + dx).reshape(self.N, -1)

    def _batchify_x0(self, x0):
        x0 = jnp.asarray(x0, _dtype())
        single = x0.ndim == 1
        return (x0[None] if single else x0), single

    @highest_precision
    def get_trajectory_batch(self, x0, us, noise_scale=0, rng=None):
        """Open-loop rollouts for a batch of initial states (`sls_base.py:62-74`)."""
        x0b, single = self._batchify_x0(x0)
        us = jnp.asarray(us, _dtype())
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)

        def one(x0_, ws_):
            # ws_ is always an array here (zeros substituted by the caller)
            def step(x, inp):
                At, Bt, ut, w = inp
                return At @ x + Bt @ ut + w, (x, ut)

            _, (xs, us_) = jax.lax.scan(step, x0_, (self.A, self.B, us, ws_))
            return xs, us_

        xs, us_out = jax.vmap(lambda a, w: one(a, w))(
            x0b, ws if ws is not None else jnp.zeros((x0b.shape[0], self.N, self.x_dim), _dtype())
        )
        if single:
            return xs[0], us_out[0]
        return xs, us_out

    @highest_precision
    def get_trajectory_dp(self, x0, K, k, noise_scale=0, rng=None):
        """Closed-loop per-step-feedback rollouts (`sls_base.py:76-89`)."""
        x0b, single = self._batchify_x0(x0)
        K = jnp.asarray(K, _dtype())
        k = jnp.asarray(k, _dtype())
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)

        def one(x0_, ws_):
            def step(x, inp):
                At, Bt, Kt, kt, w = inp
                u = Kt @ x + kt
                return At @ x + Bt @ u + w, (x, u)

            _, (xs, us) = jax.lax.scan(step, x0_, (self.A, self.B, K, k, ws_))
            return xs, us

        wsb = ws if ws is not None else jnp.zeros((x0b.shape[0], self.N, self.x_dim), _dtype())
        xs, us = jax.vmap(one)(x0b, wsb)
        if single:
            return xs[0], us[0]
        return xs, us

    @highest_precision
    def get_trajectory_sls(self, x0, K, k, noise_scale=0, rng=None):
        """History-feedback rollouts u_t = K[t,0:t] x_{0:t} + k_t (`sls_base.py:91-105`)."""
        x0b, single = self._batchify_x0(x0)
        K = jnp.asarray(K, _dtype())
        k = jnp.asarray(k, _dtype())
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)
        A, B = self.A, self.B

        t_idx = jnp.arange(self.N)

        def lin_f_t(x, u, t):
            return A[t] @ x + B[t] @ u

        def one(x0_, ws_):
            # scan over time with explicit index to pick A_t/B_t
            u_dim, x_dim, N = self.u_dim, self.x_dim, self.N
            K4 = K.reshape(N, u_dim, N, x_dim)
            k2 = k.reshape(N, u_dim)

            def step(carry, inp):
                x, xh, t = carry
                K4t, k2t, w = inp
                xh = jax.lax.dynamic_update_slice(xh, x[None], (t, jnp.int32(0)))
                u = jnp.einsum("unj,nj->u", K4t, xh) + k2t
                x_next = A[t] @ x + B[t] @ u + w
                return (x_next, xh, t + 1), (x, u)

            xh0 = jnp.zeros((N, x_dim), _dtype())
            _, (xs, us) = jax.lax.scan(step, (x0_, xh0, jnp.int32(0)), (K4, k2, ws_))
            return xs, us

        wsb = ws if ws is not None else jnp.zeros((x0b.shape[0], self.N, self.x_dim), _dtype())
        xs, us = jax.vmap(one)(x0b, wsb)
        if single:
            return xs[0], us[0]
        return xs, us

    # ------------------------------------------------------------- ADMM
    def ADMM_LQT_Batch(
        self, x0, project_x=None, project_u=None, max_iter=20, rho_x=None,
        rho_u=None, alpha=1.0, tol=1e-3, verbose=False, log=False,
        use_qr=None, anderson_m=0,
    ):
        """Constrained LQT, batch x-update (reference `sls.py:252-293`).

        anderson_m > 0 enables safeguarded type-II Anderson acceleration
        of the consensus iteration (ADMMConfig.anderson_m; not in the
        reference — plain ADMM throughout).

        Returns (x_flat, u_flat[, logs]).
        """
        project_x = project_x or None
        project_u = project_u or None
        cfg = ADMMConfig(max_iter=max_iter, alpha=alpha, tol=tol, log=log,
                         anderson_m=anderson_m)
        if use_qr is None:
            use_qr = self._auto_use_qr()
        x, u, info = lqt_admm_batch(
            self.A, self.B, self.quad_cost, jnp.asarray(x0, _dtype()),
            project_x, project_u, rho_x, rho_u, cfg, use_qr=use_qr,
        )
        if verbose:
            print(
                f"ADMM status {int(info.status)} after {int(info.iters)} iters; "
                f"residuals {float(info.prim_res):.2e} / {float(info.dual_res):.2e}"
            )
        if log:
            return x, u, np.asarray(info.logs[: int(info.iters)])
        return x, u

    def ADMM_LQT_DP(
        self, x0, project_x=None, project_u=None, max_iter=2000, rho_x=None,
        rho_u=None, alpha=1.0, tol=1e-3, verbose=False, log=False,
        anderson_m=0,
    ):
        """Constrained LQT, DP x-update (reference `sls.py:298-317`).

        Returns (x_flat, u_flat, K, k[, logs]).
        """
        project_x = project_x or None
        project_u = project_u or None
        cfg = ADMMConfig(max_iter=max_iter, alpha=alpha, tol=tol, log=log,
                         anderson_m=anderson_m)
        x, u, aux, info = lqt_admm_dp(
            self.A, self.B, self.quad_cost, jnp.asarray(x0, _dtype()),
            project_x, project_u, rho_x, rho_u, cfg,
        )
        K, k = aux
        if verbose:
            print(
                f"ADMM status {int(info.status)} after {int(info.iters)} iters; "
                f"residuals {float(info.prim_res):.2e} / {float(info.dual_res):.2e}"
            )
        if log:
            return x, u, K, k, np.asarray(info.logs[: int(info.iters)])
        return x, u, K, k

    def ADMM_SLS(
        self, project_x=None, project_u=None, max_iter=5000, rho_x=0.0,
        rho_u=0.0, alpha=1.0, tol=1e-3, verbose=False, log=False,
        robust_dim=None, anderson_m=0,
    ):
        """Robust SLS-ADMM (reference `sls.py:319-454`).

        Returns (du, phi_u[, logs]).
        """
        project_x = project_x or None
        project_u = project_u or None
        cfg = ADMMConfig(max_iter=max_iter, alpha=alpha, tol=tol, stall_tol=1e-2, log=log,
                         anderson_m=anderson_m)
        du, phi_u, info = sls_admm(
            self.A, self.B, self.quad_cost, project_x, project_u, rho_x, rho_u,
            robust_dim=robust_dim, cfg=cfg,
        )
        if verbose:
            print(
                f"ADMM status {int(info.status)} after {int(info.iters)} iters; "
                f"residuals {float(info.prim_res):.2e} / {float(info.dual_res):.2e}"
            )
        if log:
            return du, phi_u, np.asarray(info.logs[: int(info.iters)])
        return du, phi_u

    def reset(self):
        self.PHI_U = None
        self.du = None


class iSLS(_Base):
    """Nonlinear iLQR / robust iSLS solver facade (reference `isls.py:8-712`)."""

    def __init__(self, x_dim: int, u_dim: int, N: int):
        super().__init__(x_dim, u_dim, N)
        self._forward_model = None
        self._cost_function = None
        self.alphas = 10.0 ** np.linspace(0.0, -5.0, 50)
        self.x_nom = None
        self.u_nom = None
        self._cost = None
        self.cost_log = []
        self._K = None
        self._k = None

    # -------------------------------------------------- user plant / cost
    @property
    def forward_model(self):
        return self._forward_model

    @forward_model.setter
    def forward_model(self, fn):
        """fn(x (x_dim,), u (u_dim,)) -> next state — a pure JAX function."""
        self._forward_model = fn

    @property
    def cost_function(self):
        if self._cost_function is None:
            return lambda xs, us: self.compute_cost(xs, us)
        return self._cost_function

    @cost_function.setter
    def cost_function(self, fn):
        """fn(xs (N, x_dim), us (N, u_dim)) -> scalar — single trajectory."""
        self._cost_function = fn

    # ------------------------------------------------------ nominal state
    @property
    def nominal_values(self):
        return self.x_nom, self.u_nom

    @nominal_values.setter
    def nominal_values(self, value):
        self.x_nom = jnp.asarray(value[0], _dtype())
        self.u_nom = jnp.asarray(value[1], _dtype())
        self._cost = float(self.cost_function(self.x_nom, self.u_nom))
        self.cost_log.append(self._cost)

    @property
    def cost(self):
        """Scalar cost of the current nominal (reference `isls_base.py:98-103`)."""
        return self._cost

    @cost.setter
    def cost(self, value):
        self._cost = value

    @property
    def K(self):
        return self._K

    @property
    def k(self):
        return self._k

    def reset(self):
        self.x_nom = None
        self.u_nom = None
        self._cost = None
        self.cost_log = []
        self._K = None
        self._k = None

    # ------------------------------------------------------------ helpers
    def _get_Cs_or_quad(self, get_Cs):
        if get_Cs is not None:
            return get_Cs
        quad = self.quad_cost
        return lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def _cost_fn(self):
        fn = self.cost_function
        return fn

    # ------------------------------------------------------------- solves
    def solve(
        self, get_AB, get_Cs=None, is_dynamics_linear=False, is_cost_quadratic=False,
        method="dp", max_iter=100, max_line_search_iter=25, tol_fun=1e-5,
        tol_grad=1e-4, verbose=False, riccati="chol",
    ):
        """iLQR outer loop (reference `isls.py:54-132`).

        Host-side loop with jitted per-iteration step so `cost_log` /
        verbose printing match the reference workflow. For a fully jitted
        while_loop solve (batching over instances), use
        `ilqr_admm_tpu.solvers.ilqr_solve`.
        """
        del is_dynamics_linear, is_cost_quadratic  # jit hoists invariants
        f = self._forward_model
        cost_fn = self._cost_fn()
        get_Cs_fn = self._get_Cs_or_quad(get_Cs)
        alphas = jnp.asarray(self.alphas[:max_line_search_iter], _dtype())
        from ilqr_admm_tpu.solvers.ilqr import ilqr_iterate_sls

        # method='sls' completes the triple the reference leaves
        # unimplemented (`isls.py:121-122`): response-map synthesis +
        # history-feedback line search each outer iteration.
        iterates = {
            "dp": ilqr_iterate_dp,
            "batch": ilqr_iterate_batch,
            "sls": ilqr_iterate_sls,
        }
        if method not in iterates:
            raise ValueError(
                f"unknown method {method!r}; expected one of {sorted(iterates)}"
            )
        iterate = iterates[method]

        @jax.jit
        def step(state):
            if method == "dp":
                return iterate(f, get_AB, get_Cs_fn, cost_fn, state, alphas,
                               riccati=riccati)
            return iterate(f, get_AB, get_Cs_fn, cost_fn, state, alphas)

        state = ILQRState(
            x_nom=self.x_nom, u_nom=self.u_nom,
            cost=jnp.asarray(self._cost, _dtype()),
            prev_cost=jnp.asarray(np.inf, _dtype()),
            iteration=jnp.int32(0), status=jnp.int32(0),
        )
        aux = None
        for i in range(max_iter):
            state, accept, aux = step(state)
            accept = bool(accept)
            if accept:
                self.x_nom, self.u_nom = state.x_nom, state.u_nom
                self._cost = float(state.cost)
                self.cost_log.append(self._cost)
            if verbose:
                print(f"iteration {i}: cost {float(state.cost):.6e} accept={accept}")
            if not accept:
                print(f"Forward pass failed, cannot improve anymore at iteration {i + 1}.")
                break
            if abs(state.cost - state.prev_cost) < tol_fun:
                print(f"Cost change is too low, cannot improve anymore at iteration {i + 1}.")
                break
            if i == max_iter - 1:
                print("Maximum iterations reached.")
        if method == "dp" and aux is not None:
            self._K, self._k = aux
        elif method == "sls" and aux is not None:
            # lifted history-feedback gains (Nm, Nd) / (Nm,) in delta
            # coordinates — usable directly with get_trajectory_sls.
            self._K_sls, self._k_sls = aux
        # store the final linearization (reference `isls.py:93-100` sets
        # self.A/self.B or self.AB every iteration) so controller()/Su/Sw
        # work after solve instead of crashing on A=None / using stale
        # pre-solve dynamics
        self.AB = get_AB(self.x_nom, self.u_nom)
        return self

    def solve_ilqr(self, get_AB, get_Cs=None, max_ilqr_iter=100,
                   max_line_search_iter=25, dp=True, verbose=False, **kw):
        """Notebook-era alias of `solve` (SURVEY §2 API drift)."""
        return self.solve(
            get_AB, get_Cs=get_Cs, method="dp" if dp else "batch",
            max_iter=max_ilqr_iter, max_line_search_iter=max_line_search_iter,
            verbose=verbose, **kw,
        )

    def solve_boxddp(self, get_AB, u_lower, u_upper, get_Cs=None,
                     max_iter=100, tol_fun=1e-7, riccati="seq"):
        """Control-limited DDP: bounds inside the Riccati recursion.

        First-class DP alternative to `ilqr_admm` for box-on-u problems
        (no penalty tuning; every iterate exactly feasible). See
        `solvers/boxddp.py`. riccati='parallel' selects the
        exactness-certified time-parallel backward (O(log N) depth,
        warm-started active sets — the long-horizon option, at the same
        optimum as the sequential pass). Updates the
        nominal values in place.
        """
        from ilqr_admm_tpu.problem import ILQRConfig
        from ilqr_admm_tpu.solvers.boxddp import boxddp_init, boxddp_solve

        f = self._forward_model
        cost_fn = self._cost_fn()
        get_Cs_fn = self._get_Cs_or_quad(get_Cs)
        st0 = boxddp_init(f, cost_fn, self.x_nom[0], self.u_nom, u_lower, u_upper)
        out = jax.jit(
            lambda st: boxddp_solve(
                f, get_AB, get_Cs_fn, cost_fn, st, u_lower, u_upper,
                cfg=ILQRConfig(max_iter=max_iter, tol_fun=tol_fun),
                riccati=riccati,
            )
        )(st0)
        self.x_nom, self.u_nom = out.x_nom, out.u_nom
        self._cost = float(out.cost)
        self.cost_log.append(self._cost)
        self.AB = get_AB(self.x_nom, self.u_nom)
        return out

    def solve_al(self, get_AB, ineq=None, eq=None, get_Cs=None, max_iter=40,
                 tol_fun=1e-9, n_al=10, mu0=1.0, mu_factor=5.0, tol_con=1e-6):
        """Augmented-Lagrangian iLQR over general stagewise constraints
        (`solvers/al_ilqr.py::al_ilqr_solve`): ineq(x,u[,t]) <= 0,
        eq(x,u[,t]) = 0; handles state constraints and infeasible
        initial controls. Updates the nominal values in place and
        returns the ALResult (check `.max_violation`)."""
        from ilqr_admm_tpu.problem import ILQRConfig
        from ilqr_admm_tpu.solvers.al_ilqr import al_ilqr_solve

        f = self._forward_model
        cost_fn = self._cost_fn()
        get_Cs_fn = self._get_Cs_or_quad(get_Cs)
        out = jax.jit(
            lambda x0, u0: al_ilqr_solve(
                f, get_AB, get_Cs_fn, cost_fn, x0, u0, ineq=ineq, eq=eq,
                cfg=ILQRConfig(max_iter=max_iter, tol_fun=tol_fun),
                n_al=n_al, mu0=mu0, mu_factor=mu_factor, tol_con=tol_con,
            )
        )(self.x_nom[0], self.u_nom)
        self.x_nom, self.u_nom = out.x_nom, out.u_nom
        self._cost = float(out.cost)
        self.cost_log.append(self._cost)
        self.AB = get_AB(self.x_nom, self.u_nom)
        return out

    def solve_barrier(self, get_AB, barrier, get_Cs=None, max_iter=40,
                      tol_fun=1e-9, mu0=1.0, mu_factor=5.0, n_barrier=6):
        """Interior-point iLQR over stagewise cones (see
        `solvers/barrier_ilqr.py::barrier_ilqr_solve`; build `barrier`
        with `make_barrier(ineq=..., soc=...)`). The current nominal
        controls must roll out strictly feasibly."""
        from ilqr_admm_tpu.problem import ILQRConfig
        from ilqr_admm_tpu.solvers.barrier_ilqr import barrier_ilqr_solve

        f = self._forward_model
        cost_fn = self._cost_fn()
        get_Cs_fn = self._get_Cs_or_quad(get_Cs)
        out = jax.jit(
            lambda x0, u0: barrier_ilqr_solve(
                f, get_AB, get_Cs_fn, cost_fn, x0, u0, barrier,
                cfg=ILQRConfig(max_iter=max_iter, tol_fun=tol_fun),
                mu0=mu0, mu_factor=mu_factor, n_barrier=n_barrier,
            )
        )(self.x_nom[0], self.u_nom)
        self.x_nom, self.u_nom = out.x_nom, out.u_nom
        self._cost = float(out.cost)
        self.cost_log.append(self._cost)
        self.AB = get_AB(self.x_nom, self.u_nom)
        return out

    # ------------------------------------------------------------ rollouts
    @highest_precision
    def rollout_batch(self, x0, us):
        """Batched open-loop rollouts; x0 (b, d) or (d,), us (b, N, m).

        Reference `isls.py:135-154` (accepts the notebook's x0[None] style).
        """
        f = self._forward_model
        x0 = jnp.asarray(x0, _dtype())
        us = jnp.asarray(us, _dtype())
        if x0.ndim == 1 and us.ndim == 2:
            xs = rollout_nonlinear(f, x0, us)
            return xs, us
        x0b = x0 if x0.ndim == 2 else jnp.broadcast_to(x0, (us.shape[0],) + x0.shape)
        xs = jax.vmap(lambda a, u: rollout_nonlinear(f, a, u))(x0b, us)
        return xs, us

    @highest_precision
    def get_trajectory_batch(self, x0, us, noise_scale=0, rng=None):
        x0 = jnp.asarray(x0, _dtype())
        us = jnp.asarray(us, _dtype())
        single = x0.ndim == 1
        x0b = x0[None] if single else x0
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)
        f = self._forward_model

        if ws is None:
            xs = jax.vmap(lambda a: rollout_nonlinear(f, a, us))(x0b)
        else:
            xs = jax.vmap(lambda a, w: rollout_nonlinear(f, a, us, w))(x0b, ws)
        usb = jnp.broadcast_to(us, (x0b.shape[0],) + us.shape)
        if single:
            return xs[0], us
        return xs, usb

    @highest_precision
    def get_trajectory_dp(self, x0, K, k, noise_scale=0, rng=None):
        """Closed-loop rollouts around the nominal (reference `isls_base.py:59-71`).

        u = K (x - x_nom) + k + u_nom with the *nonlinear* plant.
        """
        x0 = jnp.asarray(x0, _dtype())
        single = x0.ndim == 1
        x0b = x0[None] if single else x0
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)
        f = self._forward_model
        K = jnp.asarray(K, _dtype())
        k = jnp.asarray(k, _dtype())
        x_nom, u_nom = self.x_nom, self.u_nom

        def one(a, w):
            return rollout_closed_loop(f, a, K, k, x_nom, u_nom, w)

        if ws is None:
            xs, us = jax.vmap(lambda a: rollout_closed_loop(f, a, K, k, x_nom, u_nom))(x0b)
        else:
            xs, us = jax.vmap(one)(x0b, ws)
        if single:
            return xs[0], us[0]
        return xs, us

    @highest_precision
    def get_trajectory_sls(self, x0, K, k, noise_scale=0, rng=None):
        """History-feedback rollouts around the nominal (`isls_base.py:28-42`)."""
        x0 = jnp.asarray(x0, _dtype())
        single = x0.ndim == 1
        x0b = x0[None] if single else x0
        ws = self._noise((x0b.shape[0], self.N, self.x_dim), noise_scale, rng)
        f = self._forward_model
        K = jnp.asarray(K, _dtype())
        k = jnp.asarray(k, _dtype())
        x_nom, u_nom = self.x_nom, self.u_nom

        if ws is None:
            xs, us = jax.vmap(
                lambda a: rollout_sls_delta(f, a, K, k, x_nom, u_nom)
            )(x0b)
        else:
            xs, us = jax.vmap(
                lambda a, w: rollout_sls_delta(f, a, K, k, x_nom, u_nom, w)
            )(x0b, ws)
        if single:
            return xs[0], us[0]
        return xs, us

    def controller(self, PHI_U, du):
        """Recover (K, k) from a response map around the nominal.

        Uses the *current* linearization (reference `sls.py:235-242` via
        inherited state).
        """
        return sls_controller(self.A, self.B, jnp.asarray(PHI_U, _dtype()), jnp.asarray(du, _dtype()))

    # --------------------------------------------------------------- ADMM
    def ilqr_admm(
        self, get_AB, get_Cs=None, project_x=None, project_u=None,
        max_iter=20, max_line_search_iter=20, max_admm_iter=20, rho_x=None,
        rho_u=None, alpha=1.0, tol=1e-3, verbose=False, log=False,
        k_max=None, threshold=None, max_line_search=None,
        method="batch", riccati="chol", line_search="inner",
        anderson_m=0,
    ):
        """Constrained iLQR-ADMM (reference `isls.py:379-501`).

        Accepts both current and notebook-era keyword spellings
        (`k_max`/`threshold`/`max_line_search`).

        line_search='outer' (batch method only) selects the SQP-style
        variant: the inner ADMM iterates on the linearized trajectory
        prediction with no rollouts, and one nonlinear line search per
        outer step globalizes the result — the fastest-at-golden-quality
        configuration on the control-limited car benchmark
        (benchmarks/bench_outer_ls.py).
        """
        max_iter = k_max if k_max is not None else max_iter
        tol = threshold if threshold is not None else tol
        max_line_search_iter = (
            max_line_search if max_line_search is not None else max_line_search_iter
        )
        f = self._forward_model
        cost_fn = self._cost_fn()
        quad = None if get_Cs is not None else self.quad_cost
        alphas = jnp.asarray(self.alphas[:max_line_search_iter], _dtype())
        res = _ilqr_admm(
            f, get_AB, cost_fn, self.x_nom, self.u_nom,
            get_Cs=get_Cs, quad_cost=quad,
            project_x=project_x or None, project_u=project_u or None,
            rho_x=rho_x, rho_u=rho_u, max_iter=max_iter,
            max_admm_iter=max_admm_iter, alphas=alphas, alpha=alpha, tol=tol,
            method=method, riccati=riccati, line_search=line_search,
            anderson_m=anderson_m,
        )
        self.x_nom, self.u_nom = res.x_nom, res.u_nom
        # store the linearization at the solution (see solve())
        self.AB = get_AB(self.x_nom, self.u_nom)
        self._cost = float(res.cost)
        finite = np.asarray(res.cost_log)[: int(res.outer_iters)]
        self.cost_log.extend([float(c) for c in finite])
        if verbose:
            print(
                f"ilqr_admm: {int(res.outer_iters)} outer iterations, "
                f"final cost {self._cost:.6e}, status {int(res.status)}"
            )
        if log:
            return finite
        return res

    def isls_admm(
        self, dim, get_AB, get_Cs=None, project_x=None, project_u=None,
        max_admm_iter=20, k_max=20, max_line_search=20, rho_x=None, rho_u=None,
        alpha=1.0, threshold=1e-3, verbose=False, log=False, anderson_m=0,
    ):
        """Robust iSLS-ADMM (reference `isls.py:503-712`).

        Returns (du, phi_u) like the reference.
        """
        f = self._forward_model
        cost_fn = self._cost_fn()
        quad = None if get_Cs is not None else self.quad_cost
        alphas = jnp.asarray(self.alphas[:max_line_search], _dtype())
        res = _isls_admm(
            f, get_AB, cost_fn, self.x_nom, self.u_nom, robust_dim=dim,
            get_Cs=get_Cs, quad_cost=quad,
            project_x=project_x or None, project_u=project_u or None,
            rho_x=rho_x, rho_u=rho_u, k_max=k_max, max_admm_iter=max_admm_iter,
            alphas=alphas, alpha=alpha, tol=threshold, anderson_m=anderson_m,
        )
        self.x_nom, self.u_nom = res.x_nom, res.u_nom
        self._cost = float(res.cost)
        finite = np.asarray(res.cost_log)[: int(res.outer_iters)]
        self.cost_log.extend([float(c) for c in finite])
        # store the linearization at the solution for controller()
        self.AB = get_AB(self.x_nom, self.u_nom)
        if verbose:
            print(
                f"isls_admm: {int(res.outer_iters)} outer iterations, "
                f"final cost {self._cost:.6e}, status {int(res.status)}"
            )
        return res.du, res.phi_u

