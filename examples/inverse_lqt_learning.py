"""Inverse optimal control through the constrained solver.

Differentiable ADMM (IFT fixed-point VJP, `solvers/implicit.py`) lets
gradients flow through the *constrained* LQT solution. This demo:

1. generates a demonstration trajectory from a control-bounded LQT
   problem with a hidden control bound and a hidden via-point target;
2. recovers both by gradient descent on the squared trajectory mismatch
   — gradients computed through the ADMM fixed point, not by unrolling.

Capability beyond the reference (pure NumPy, no autodiff — SURVEY §5
"none of this exists in the reference but it is the natural JAX payoff").

Run: python examples/inverse_lqt_learning.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")  # tiny problem: no accelerator needed
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers import lqt_admm_implicit
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def main():
    N = 40
    di = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = di.x_dim, di.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = di.AB(N)
    proj_u = lambda v, p: project_bound(v, -p, p)

    def solve(target, bound):
        theta = dict(
            Q=quad.Q, R=quad.R, xd=quad.xd.at[-1, 0].set(target),
            x0=jnp.zeros(d), pu=bound,
        )
        return lqt_admm_implicit(A, B, theta, project_u=proj_u, rho_u=1e-1)

    true_target, true_bound = 0.7, 2.5
    xs_demo, us_demo = solve(true_target, true_bound)
    print(f"demonstration: max|u| = {float(jnp.abs(us_demo).max()):.4f} "
          f"(hidden bound {true_bound}), final pos = {float(xs_demo[-1, 0]):.4f} "
          f"(hidden target {true_target})")

    def loss(params):
        xs, us = solve(params["target"], params["bound"])
        return jnp.sum((xs - xs_demo) ** 2) + jnp.sum((us - us_demo) ** 2)

    import optax

    grad = jax.jit(jax.grad(loss))
    # note: d(loss)/d(bound) is exactly zero wherever the bound is slack
    # (correct IFT behavior) — initialize inside the active region
    params = dict(target=jnp.asarray(0.2), bound=jnp.asarray(3.0))
    opt = optax.adam(5e-2)
    opt_state = opt.init(params)
    for i in range(150):
        g = grad(params)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        if i % 30 == 0:
            print(f"iter {i:3d}: target={float(params['target']):.4f} "
                  f"bound={float(params['bound']):.4f} loss={float(loss(params)):.3e}")

    print(f"recovered: target={float(params['target']):.4f} (true {true_target}), "
          f"bound={float(params['bound']):.4f} (true {true_bound})")
    assert abs(float(params["target"]) - true_target) < 5e-3
    assert abs(float(params["bound"]) - true_bound) < 5e-2
    print("OK")


if __name__ == "__main__":
    main()
