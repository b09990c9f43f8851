"""Per-tile early exit on a mixed-difficulty fleet.

`make_pallas_lqt_admm(stop_tol=...)` adds per-program early exit to the
fused kernel: a batch tile stops once every instance in it has max-abs
primal residual below stop_tol (checked every `check_every`
iterations). Heterogeneous fleets (MPC warm starts, multi-start sweeps)
otherwise run the converged majority for the full schedule while a few
stragglers finish.

This bench builds a mixed fleet — 7/8 of instances at the nominal x0
spread, 1/8 at 10x the spread — SORTS it by the |x0| difficulty proxy so
stragglers share tiles, and compares throughput and solution quality of
the fixed schedule vs early exit. Quality gate: identical feasibility
(0 violation); the converged fractions are reported side by side.
Runs on the GPU only. Prints one JSON line.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import bench
    from benchmarks._certify import (
        device_info, enable_compile_cache, median_iqr, timed_windows,
    )
    from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm

    enable_compile_cache()
    dev = device_info(require="gpu")

    BATCH = 16384
    ADMM_ITERS = 200  # generous cap: the easy 7/8 converge far sooner
    A, B, cost = bench.lqt_box_problem(bench.N)
    d = A.shape[-1]

    kw = dict(u_lower=-bench.U_BOUND, u_upper=bench.U_BOUND,
              rho_u=bench.RHO_U, n_iters=ADMM_ITERS,
              batch_tile=bench.BATCH_TILE)
    solve_fix = make_pallas_lqt_admm(A, B, cost, **kw)
    solve_exit = make_pallas_lqt_admm(A, B, cost, stop_tol=1e-4, **kw)

    # mixed fleet: 7/8 nominal spread, 1/8 at 10x; sorted by |x0| so
    # stragglers share tiles and easy tiles exit early
    rng = np.random.default_rng(0)
    x0s = rng.normal(0.0, 0.1, size=(BATCH, d))
    hard = rng.choice(BATCH, BATCH // 8, replace=False)
    x0s[hard] *= 10.0
    order = np.argsort(np.linalg.norm(x0s, axis=1))
    x0s = jnp.asarray(x0s[order], jnp.float32)

    out_f = solve_fix(x0s)
    out_e = solve_exit(x0s)
    jax.block_until_ready((out_f, out_e))

    for tag, (_, u, zu) in (("fixed", out_f), ("early", out_e)):
        viol = float(jnp.max(jnp.maximum(jnp.abs(zu) - bench.U_BOUND, 0.0)))
        assert viol == 0.0, (tag, viol)
    r_f = np.asarray(jnp.linalg.norm(out_f[1] - out_f[2], axis=-1))
    r_e = np.asarray(jnp.linalg.norm(out_e[1] - out_e[2], axis=-1))
    du = float(jnp.max(jnp.abs(out_f[1] - out_e[1])))

    t_f = median_iqr(timed_windows(lambda: solve_fix(x0s), 10, 5))
    t_e = median_iqr(timed_windows(lambda: solve_exit(x0s), 10, 5))
    print(json.dumps({
        "metric": "pallas_early_exit_speedup_mixed_fleet",
        "value": t_f[0] / t_e[0],
        "unit": "x (fixed-schedule time / early-exit time, 16k mixed fleet)",
        "fixed_ms_median_iqr": [t * 1e3 for t in t_f],
        "early_ms_median_iqr": [t * 1e3 for t in t_e],
        "converged_frac_fixed": float((r_f < 1e-4).mean()),
        "converged_frac_early": float((r_e < 1e-4).mean()),
        "max_u_diff": du,
        **dev,
    }))


if __name__ == "__main__":
    main()
