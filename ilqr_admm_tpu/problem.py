"""Problem and solver-state pytrees.

Everything the solvers consume is a pytree of arrays plus static config
dataclasses, so every solver is jit-able, vmap-able over problem
instances, and shard_map-able over a device mesh.

Reference parity: these structures replace the mutable attributes of the
reference's `Base`/`SLSBase`/`iSLSBase` classes (`base.py:11-29`,
`sls_base.py:10-23`, `isls_base.py:5-24`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree (all fields are leaves)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def static_dataclass(cls):
    """A frozen, hashable dataclass used as a static (compile-time) config."""
    return dataclasses.dataclass(frozen=True)(cls)


# --------------------------------------------------------------------------
# Cost / dynamics specs
# --------------------------------------------------------------------------


@pytree_dataclass
class QuadCost:
    """Per-timestep quadratic tracking cost.

    cost(x, u) = sum_t (x_t - xd_t)^T Q_t (x_t - xd_t) + u_t^T R_t u_t

    (no 1/2 factor — matches the reference convention, `sls_base.py:25-44`).

    Q:  (N, x_dim, x_dim)
    xd: (N, x_dim)
    R:  (N, u_dim, u_dim)
    """

    Q: jax.Array
    xd: jax.Array
    R: jax.Array

    @property
    def N(self) -> int:
        return self.Q.shape[0]

    @property
    def x_dim(self) -> int:
        return self.Q.shape[-1]

    @property
    def u_dim(self) -> int:
        return self.R.shape[-1]

    def __call__(self, xs: jax.Array, us: jax.Array) -> jax.Array:
        """Evaluate the cost of (possibly batched) trajectories.

        xs: (..., N, x_dim); us: (..., N, u_dim). Returns (...,).
        """
        # Expanded broadcast-multiply-sum quadratic forms: cost drives
        # line-search accept decisions, and at stiff weights (arm: 1e6)
        # product noise from a reduced-precision einsum lowering is
        # 1e-4-scale on candidate comparisons, enough to stall the f32
        # arm solve. The expanded form is exact elementwise f32 (dims
        # here are tiny).
        dx = xs - self.xd
        Qdx = jnp.sum(self.Q * dx[..., :, None, :], axis=-1)
        Rus = jnp.sum(self.R * us[..., :, None, :], axis=-1)
        cx = jnp.sum(dx * Qdx, axis=(-2, -1))
        cu = jnp.sum(us * Rus, axis=(-2, -1))
        return cx + cu

    def lifted_Q(self) -> jax.Array:
        """Dense (N*x, N*x) block-diagonal lifted Q (for batch/SLS paths)."""
        N, d = self.Q.shape[0], self.Q.shape[-1]
        out = jnp.zeros((N * d, N * d), self.Q.dtype)
        idx = jnp.arange(N)
        return out.at[
            idx[:, None, None] * d + jnp.arange(d)[None, :, None],
            idx[:, None, None] * d + jnp.arange(d)[None, None, :],
        ].set(self.Q)

    def lifted_R(self) -> jax.Array:
        N, m = self.R.shape[0], self.R.shape[-1]
        out = jnp.zeros((N * m, N * m), self.R.dtype)
        idx = jnp.arange(N)
        return out.at[
            idx[:, None, None] * m + jnp.arange(m)[None, :, None],
            idx[:, None, None] * m + jnp.arange(m)[None, None, :],
        ].set(self.R)

    def lifted_xd(self) -> jax.Array:
        return self.xd.reshape(-1)


@pytree_dataclass
class LQTProblem:
    """Linear(ized) quadratic tracking problem.

    A: (N, x_dim, x_dim) — x_{t+1} = A_t x_t + B_t u_t
    B: (N, x_dim, u_dim)
    cost: QuadCost
    """

    A: jax.Array
    B: jax.Array
    cost: QuadCost

    @property
    def N(self) -> int:
        return self.A.shape[0]

    @property
    def x_dim(self) -> int:
        return self.A.shape[-1]

    @property
    def u_dim(self) -> int:
        return self.B.shape[-1]


def broadcast_AB(A: jax.Array, B: jax.Array, N: int):
    """Accept (x,x)/(N,x,x) A and (x,u)/(N,x,u) B, return (N, ., .) arrays.

    Mirrors the reference's acceptance of 2-D or 3-D A/B (`base.py:104-106`).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    if A.ndim == 2:
        A = jnp.broadcast_to(A, (N,) + A.shape)
    if B.ndim == 2:
        B = jnp.broadcast_to(B, (N,) + B.shape)
    return A, B


# --------------------------------------------------------------------------
# Static solver configs (hashable → usable as jit static args)
# --------------------------------------------------------------------------


@static_dataclass
class ADMMConfig:
    """Config for the generic two-block scaled ADMM driver.

    Mirrors the reference tunables (`admm.py:6-8`): max_iter, relaxation
    alpha, absolute tolerance, and the relative-stall tolerance used for
    the "can't improve anymore" stop (`admm.py:78-85`).
    """

    max_iter: int = 20
    alpha: float = 1.0
    tol: float = 1e-3
    stall_tol: Optional[float] = None  # defaults to tol when None
    log: bool = False
    # Residual-balancing adaptive penalty (Boyd et al. 2011, §3.4.1):
    # scale all rho's by tau when the primal residual exceeds mu x the
    # dual residual, and divide when the reverse holds; scaled duals are
    # rescaled accordingly. f_argmin must then accept a third rho_scale
    # argument. Not in the reference (fixed rho throughout) — cuts
    # iteration counts on badly-scaled problems.
    adaptive_rho: bool = False
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    rho_freq: int = 4  # balance every rho_freq iterations
    # stop adapting after this many iterations: each penalty change
    # perturbs the scaled duals and restarts the linear-convergence tail,
    # so late adaptation trades a settled tail for no benefit (Boyd
    # §3.4.1 notes convergence proofs assume rho eventually fixed).
    rho_freeze_after: int = 100
    rho_scale_min: float = 1e-3
    rho_scale_max: float = 1e3
    # Nesterov-accelerated ADMM with adaptive restart (Goldstein,
    # O'Donoghue, Setzer & Baraniuk 2014, "Fast ADMM", Alg. 8):
    # momentum on (z, lambda), monitored by the rho-weighted combined
    # residual c_k = ||lambda_k - lambda_hat||^2_rho + ||z_k - z_hat||^2_rho;
    # a restart (revert momentum, reset step to 1) fires whenever
    # c_k >= accel_eta * c_{k-1}. Goldstein's eta=0.999 (strict decay)
    # degenerates to plain ADMM at half speed whenever the problem's
    # linear rate is slower than eta — the monitor then rejects even
    # momentum-free steps, so every other iteration reverts-and-recomputes
    # the same point. eta slightly above 1 tolerates the slow-rate regime
    # (measured on the control-bounds LQT with rho 1000x too small:
    # eta=0.999 never converges in 2000 iters; eta=1.02 converges in ~650
    # vs 20,000+ plain). Not in the reference (plain ADMM throughout).
    # Mutually exclusive with adaptive_rho (momentum assumes a fixed
    # penalty).
    accel: bool = False
    accel_eta: float = 1.02
    # Type-II Anderson acceleration (Walker & Ni 2011; safeguarded as in
    # SCS 3.0 / A2DR) on the ADMM fixed-point map v = (z, lambda) ->
    # T(v): keep the last anderson_m successive differences of iterates
    # and residuals, solve a small regularized least-squares for the
    # extrapolation weights, and restart the memory whenever the
    # fixed-point residual exceeds anderson_safeguard x the best residual
    # since the last restart (plain ADMM step on restart). Convergence is
    # only ever declared on a *plain* step's residuals, and the returned
    # (x, z, lambda) always come from a plain evaluation, so accepted
    # solutions carry the same certificates as unaccelerated ADMM.
    # Targets the slow linear tail of consensus ADMM (the reference runs
    # plain ADMM throughout). Mutually exclusive with accel/adaptive_rho.
    anderson_m: int = 0  # memory depth; 0 = off
    anderson_reg: float = 1e-10  # relative Tikhonov reg of the LS coefficients
    anderson_safeguard: float = 10.0  # restart threshold vs best-since-restart

    @property
    def stall(self) -> float:
        return self.tol if self.stall_tol is None else self.stall_tol


@static_dataclass
class ILQRConfig:
    """Config for the iLQR outer loop (reference `isls.py:54-55`)."""

    max_iter: int = 100
    max_line_search_iter: int = 50
    tol_fun: float = 1e-5
    tol_grad: float = 1e-4
    # line-search grid alphas = 10^linspace(0, alpha_min_exp, n) — reference
    # `isls_base.py:10-11` uses 10^linspace(0, -5, 50).
    alpha_min_exp: float = -5.0


class SolveStatus(enum.IntEnum):
    """Structured solver statuses (replaces reference print-based stops,

    `admm.py:72-97`, `isls.py:125-132`)."""

    RUNNING = 0
    CONVERGED = 1
    STALLED = 2
    MAX_ITER = 3
    LINE_SEARCH_FAILED = 4
    OSCILLATING = 5


def line_search_alphas(cfg: ILQRConfig, dtype=jnp.float32) -> jax.Array:
    """The parallel line-search step grid (reference `isls_base.py:10-11`)."""
    n = cfg.max_line_search_iter
    return 10.0 ** jnp.linspace(0.0, cfg.alpha_min_exp, 50, dtype=dtype)[:n]
