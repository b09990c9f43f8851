"""Fleet solves-to-tolerance: plain early-stop vs per-instance Anderson.

The certified headline (bench.py) measures iterations/s at a FIXED
schedule; this benchmark measures the other serving quantity — wall
clock for a whole fleet to reach a residual tolerance (default config:
f32, serving tolerance 5e-4). Anderson pays off when plain ADMM needs
many iterations — tight-tolerance x64 fleets (JAX_ENABLE_X64=1, or see
tests/test_batched_admm.py::test_batched_anderson_matches_plain); at
f32 serving tolerances the secant differences of near-converged
instances approach the matmul noise floor. On the GPU: not measured.

Run: python benchmarks/bench_fleet_anderson.py [batch]
"""

import os

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost


def main(batch=16384):
    N = 100
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    f32 = jnp.float32
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(f32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(f32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(f32), B.astype(f32)
    proj = lambda u: project_bound(u, -5.0, 5.0)

    rng = np.random.default_rng(0)
    # mixed-difficulty fleet (the early-exit study's shape): 1/8 of the
    # instances at 10x the initial-state spread
    x0s = rng.normal(0, 0.1, size=(batch, d))
    x0s[: batch // 8] *= 10.0
    x0s = jnp.asarray(x0s, f32)

    TOL = 5e-4  # above the f32 dual-residual floor (~3e-4)
    CAP = 400
    variants = {
        "plain early-stop": dict(),
        "anderson m=5": dict(anderson_m=5),
    }
    results = {}
    for name, kw in variants.items():
        solve = make_batched_lqt_admm(
            A, B, cost, project_u=proj, rho_u=1e-1, n_iters=CAP, tol=TOL, **kw
        )
        x, u = solve(x0s)
        jax.block_until_ready(u)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            x, u = solve(x0s)
        jax.block_until_ready(u)
        dt = (time.perf_counter() - t0) / reps
        viol = float(jnp.max(jnp.abs(u))) - 5.0
        results[name] = (dt, u)
        print(f"{name:18s}: {dt * 1e3:7.2f} ms for {batch} instances to "
              f"tol {TOL:g}  ({batch / dt:,.0f} solves/s), "
              f"max bound violation {viol:+.2e}")
    d_plain = results["plain early-stop"][0]
    d_aa = results["anderson m=5"][0]
    diff = float(jnp.max(jnp.abs(results["anderson m=5"][1]
                                 - results["plain early-stop"][1])))
    print(f"speedup {d_plain / d_aa:.2f}x; max cross-variant solution "
          f"difference {diff:.2e}")


if __name__ == "__main__":
    main(batch=int(sys.argv[1]) if len(sys.argv) > 1 else 16384)
