"""Certified wide-problem fleet bench: Nm = 512 batched LQT-ADMM.

A d=8 / m=4 double integrator at N=128 (so the in-loop response GEMM is
512x512), 8192 instances, with the same certificate machinery as
bench.py — feasibility == 0, converged_frac >= 0.99 at the reference
primal tolerance, and max f64 L-BFGS-B oracle cost gap <= 1e-4 on a
subsample.

The path is chosen by width (`ops/pallas_admm.py::kernel_fits`): the
fused kernel keeps the (Nm x Nm) operator on chip only up to a padded
Nm of 128, so this fleet runs the XLA GEMM path (`solvers/batched.py`).
Runs on the GPU only. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    import jax.numpy as jnp

    import bench
    from benchmarks._certify import (
        device_info, enable_compile_cache, median_iqr, timed_windows,
    )
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.ops.pallas_admm import kernel_fits
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    enable_compile_cache()
    dev = device_info(require="gpu")

    N = 128
    BATCH = 8192
    ADMM_ITERS = 100

    # 4 independent positions, 2 derivatives each: d = 8, m = 4 -> the
    # in-loop response GEMM is (N*m)^2 = 512^2
    plant = DoubleIntegrator(4, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    assert N * m == 512
    target = jnp.asarray([1.0, 0.5, -0.5, 0.8] + [0.0] * 4, jnp.float32)
    zs = jnp.stack([jnp.zeros(d, jnp.float32), target])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A = A.astype(jnp.float32)
    B = B.astype(jnp.float32)

    path = "pallas" if kernel_fits(N * m) else "xla"
    solve = bench.make_solver(path, A, B, cost, n_iters=ADMM_ITERS)
    x0s = bench.initial_states(BATCH, d)
    u, z_u = solve(x0s)
    cert = bench.certify(A, B, cost, x0s, u, z_u, oracle_n=32)

    med, q1, q3 = median_iqr(timed_windows(lambda: solve(x0s), 10, 5))
    print(json.dumps({
        "metric": "wide_admm_iterations_per_s_Nm512",
        "value": BATCH * ADMM_ITERS / med,
        "unit": "ADMM iterations/s (Nm=512, d=8, m=4, batch 8192)",
        "path": path,
        "ms_per_solve_median": med * 1e3,
        "ms_per_solve_iqr": [q1 * 1e3, q3 * 1e3],
        **cert,
        **dev,
    }))


if __name__ == "__main__":
    main()
