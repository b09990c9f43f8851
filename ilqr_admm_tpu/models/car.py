"""2D car plants (two dynamics variants) + the car-parking cost.

Reference seeds (behavioral parity, re-derived in JAX):
- `CarFrontWheel`: front-wheel kinematic car of the Tutorial / DDP-replicate
  notebooks (`Tutorial.ipynb` cell 8) — the Tassa/Todorov control-limited
  DDP car-parking plant. State [x, y, heading, front-wheel velocity],
  control [front-wheel angle, acceleration].
- `CarSimple`: simple kinematic car with steering-rate control
  (`Car/Iterative LQR with control constraints.ipynb` cell 6), which has
  closed-form Jacobians in the reference — here both variants get exact
  Jacobians from `jax.jacfwd` and an analytic path for cross-checking.
- `CarParkingCost`: pseudo-Huber parking cost (`Tutorial.ipynb` cell 14).

Derivatives come from JAX autodiff (replacing the reference's autograd
user-side glue, SURVEY §2.2), vmap-batched over the horizon.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class CarFrontWheel:
    """Front-axle kinematic car; s = [x, y, theta, v], u = [wheel_angle, accel]."""

    x_dim = 4
    u_dim = 2

    def __init__(self, dt: float = 0.03, dist: float = 2.0):
        self.dt = dt
        self.dist = dist

    def step(self, s: jax.Array, u: jax.Array) -> jax.Array:
        dt, dist = self.dt, self.dist
        w, a = u[0], u[1]
        x, y, o, v = s[0], s[1], s[2], s[3]
        f = dt * v  # front-wheel rolling distance
        ins = dist**2 - (jnp.sin(w) * f) ** 2
        b = f * jnp.cos(w) + dist - jnp.sqrt(ins)  # back-wheel rolling distance
        do = jnp.arcsin(jnp.sin(w) * f / dist)
        return jnp.stack([x + b * jnp.cos(o), y + b * jnp.sin(o), o + do, v + a * dt])

    def __call__(self, s, u):
        return self.step(s, u)

    def get_AB(self, xs: jax.Array, us: jax.Array):
        """(A, B) Jacobians along a trajectory: (N, 4, 4), (N, 4, 2)."""
        jac = jax.vmap(jax.jacfwd(self.step, argnums=(0, 1)))
        A, B = jac(xs, us)
        return A, B


class CarSimple:
    """Kinematic car with steering-rate input; x=[x,y,theta,v], u=[steer, dv].

    x3 wraps modulo 2*pi as in the reference plant. The wrap is excluded
    from the Jacobian (reference closed-form `get_AB` differentiates the
    unwrapped dynamics).
    """

    x_dim = 4
    u_dim = 2

    def __init__(self, dt: float = 0.03):
        self.dt = dt

    def step_unwrapped(self, x, u):
        """Dynamics without the theta wrap — the differentiable twin.

        The reference's closed-form `get_AB` differentiates exactly this
        (the mod is cosmetic, keeping theta in [0, 2pi) for plotting),
        and its executed trajectories never cross the wrap boundary.
        Prefer this for solves: the wrap's discontinuity makes line-
        search candidates that momentarily dip theta below 0 jump by
        2pi and blow up the feedback rollout. Reproduces the notebook's
        unconstrained golden 0.687658 exactly.
        """
        dt = self.dt
        return jnp.stack([
            x[0] + dt * x[3] * jnp.cos(x[2]),
            x[1] + dt * x[3] * jnp.sin(x[2]),
            x[2] + dt * x[3] * u[0],
            x[3] + dt * u[1],
        ])

    # back-compat alias
    _step_nowrap = step_unwrapped

    def step(self, x: jax.Array, u: jax.Array) -> jax.Array:
        s = self._step_nowrap(x, u)
        return s.at[2].set(s[2] % (2.0 * jnp.pi))

    def __call__(self, x, u):
        return self.step(x, u)

    def get_AB(self, xs: jax.Array, us: jax.Array):
        """Analytic Jacobians (match reference closed-form `get_AB`)."""
        N = xs.shape[0]
        dt = self.dt
        A = jnp.broadcast_to(jnp.eye(4, dtype=xs.dtype), (N, 4, 4))
        A = A.at[:, 0, 2].set(-dt * xs[:, 3] * jnp.sin(xs[:, 2]))
        A = A.at[:, 1, 2].set(dt * xs[:, 3] * jnp.cos(xs[:, 2]))
        A = A.at[:, 0, 3].set(dt * jnp.cos(xs[:, 2]))
        A = A.at[:, 1, 3].set(dt * jnp.sin(xs[:, 2]))
        A = A.at[:, 2, 3].set(dt * us[:, 0])
        B = jnp.zeros((N, 4, 2), xs.dtype)
        B = B.at[:, 2, 0].set(dt * xs[:, 3])
        B = B.at[:, 3, 1].set(dt)
        return A, B

    def get_AB_autodiff(self, xs, us):
        jac = jax.vmap(jax.jacfwd(self._step_nowrap, argnums=(0, 1)))
        return jac(xs, us)


def pseudo_huber(x, p):
    """Smooth absolute value: sqrt(x^2 + p^2) - p."""
    return jnp.sqrt(x**2 + p**2) - p


class CarParkingCost:
    """Car-parking cost: control quadratic + pseudo-Huber final/running terms.

    cost(xs (N,4), us (N,2)) -> scalar. Defaults reproduce the
    control-limited-DDP car-parking setup (`Tutorial.ipynb` cell 14).
    """

    def __init__(
        self,
        cu=(1e-2, 1e-4),
        cf=(0.1, 0.1, 1.0, 0.3),
        pf=(0.01, 0.01, 0.01, 1.0),
        cx=(1e-3, 1e-3),
        px=(0.1, 0.1),
    ):
        self.cu = jnp.asarray(cu)
        self.cf = jnp.asarray(cf)
        self.pf = jnp.asarray(pf)
        self.cx = jnp.asarray(cx)
        self.px = jnp.asarray(px)

    def stage(self, x: jax.Array, u: jax.Array, is_final) -> jax.Array:
        lu = jnp.sum(self.cu * u**2)
        lx = jnp.sum(self.cx * pseudo_huber(x[:2], self.px))
        lf = jnp.sum(self.cf * pseudo_huber(x, self.pf))
        return lu + lx + jnp.where(is_final, lf, 0.0)

    def __call__(self, xs: jax.Array, us: jax.Array) -> jax.Array:
        N = xs.shape[-2]
        is_final = jnp.arange(N) == N - 1
        c = jax.vmap(self.stage)(
            xs.reshape(-1, xs.shape[-1]),
            us.reshape(-1, us.shape[-1]),
            jnp.broadcast_to(is_final, xs.shape[:-1]).reshape(-1),
        ).reshape(xs.shape[:-1])
        total = jnp.sum(c, axis=-1)
        # NaN guard: the reference substitutes 1e6 (`Tutorial.ipynb` cell
        # 14); +inf guarantees NaN trajectories never win a line search.
        return jnp.where(jnp.isnan(total), jnp.inf, total)

    def get_Cs(self, xs: jax.Array, us: jax.Array):
        """Taylor blocks (cts (N, x+u), Cts (N, x+u, x+u)) around a nominal.

        Gradients/Hessians of the *stage* cost w.r.t. [x; u], symmetrized,
        NaNs zeroed — the `get_Cs` interface (`Tutorial.ipynb` cell 16).
        """
        N = xs.shape[0]
        is_final = jnp.arange(N) == N - 1

        def stage_xu(xu, fin):
            return self.stage(xu[:4], xu[4:], fin)

        xu = jnp.concatenate([xs, us], axis=-1)
        cts = jax.vmap(jax.grad(stage_xu))(xu, is_final)
        Cts = jax.vmap(jax.hessian(stage_xu))(xu, is_final)
        Cts = 0.5 * (Cts + jnp.swapaxes(Cts, -1, -2))
        cts = jnp.where(jnp.isnan(cts), 0.0, cts)
        Cts = jnp.where(jnp.isnan(Cts), 0.0, Cts)
        return cts, Cts
