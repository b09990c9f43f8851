"""Certified batched boxDDP solves/s on the control-limited car-parking task.

Reference headline for this problem: `ilqr_admm` on the car with control
bounds runs 17.4 s for ONE solve (BASELINE.md, DDP-replicate c21; the
reference has no first-class boxDDP at all — Tassa's original MATLAB
reports ~seconds too). Here the full boxDDP solve (box-QP backward pass
inside the Riccati scan + clipped parallel line search) is vmapped over
a fleet of perturbed initial states on one chip.

Certificates (bench.py-grade):
- feasibility: max |u|/bound <= 1 asserted over the whole fleet;
- f64 oracle: bounded L-BFGS-B polish (CPU x64 subprocess,
  benchmarks/_oracles.py) from each reported solution on a subsample —
  the polish must not find meaningfully lower cost (local-optimality
  certificate; the task is nonconvex so a global gate would be wrong);
- `block_until_ready` timing windows, median (`_certify.timed_rate`).

Prints one JSON line. Run: python benchmarks/bench_boxddp.py [batch] [max_iter]
"""

import json
import os

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from benchmarks._certify import gaps, run_oracle, timed_rate
from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.problem import ILQRConfig
from ilqr_admm_tpu.solvers.boxddp import boxddp_init, boxddp_solve

BASELINE_SOLVES_PER_S = 1.0 / 17.4  # reference ilqr_admm, car control bounds


def main(batch=256, max_iter=150, qp_iters=8, oracle_n=8):
    N = 500
    DT = 15.0 / N
    car = CarFrontWheel(dt=DT)
    cost = CarParkingCost()
    lo = jnp.asarray([-0.5, -2.0], jnp.float32)
    hi = jnp.asarray([0.5, 2.0], jnp.float32)
    cfg = ILQRConfig(max_iter=max_iter, tol_fun=1e-8)

    rng = np.random.default_rng(0)
    u0 = jnp.asarray(rng.normal(size=(N, 2)) * 0.1, jnp.float32)

    def solve_one(x0):
        st0 = boxddp_init(car.step, cost, x0, u0, lo, hi)
        out = boxddp_solve(
            car.step, car.get_AB, cost.get_Cs, cost, st0,
            u_lower=lo, u_upper=hi, cfg=cfg, qp_iters=qp_iters,
        )
        return out.cost, out.u_nom

    solve = jax.jit(jax.vmap(solve_one))
    x0s = jnp.asarray(
        np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
        + rng.normal(0, 0.05, (batch, 4)),
        jnp.float32,
    )

    costs, us = solve(x0s)
    jax.block_until_ready(costs)

    # --- certificates ---------------------------------------------------
    max_viol = float(jnp.max(jnp.abs(us) / jnp.asarray([0.5, 2.0]))) - 1.0
    mean_cost = float(jnp.mean(costs))
    assert max_viol <= 1e-5, f"bound violation {max_viol}"

    orc = run_oracle("boxddp_polish", {
        "dt": DT, "lo": np.asarray(lo), "hi": np.asarray(hi),
        "x0s": np.asarray(x0s[:oracle_n], np.float64),
        "us": np.asarray(us[:oracle_n], np.float64),
    })
    gap_med, gap_max = gaps(orc["j_ours"], orc["j_star"])

    # --- throughput (median of block_until_ready windows) ---------------
    rate, dt_win = timed_rate(lambda: solve(x0s)[1], batch, K=5, reps=3)

    out = {
        "metric": "boxddp_car_solves_per_s",
        "value": round(rate, 2),
        "unit": f"boxDDP car-parking solves/s (N=500, {max_iter} iters, batch {batch})",
        "vs_baseline": round(rate / BASELINE_SOLVES_PER_S, 1),
        "mean_cost": round(mean_cost, 4),
        "single_instance_golden": 1.905,
        "max_bound_violation": max(max_viol, 0.0),
        "cost_gap_median": float(f"{gap_med:.3g}"),
        "cost_gap_max": float(f"{gap_max:.3g}"),
        "oracle": f"f64 bounded L-BFGS-B polish, {oracle_n} instances",
    }
    # local-optimality gate: at max_iter=150/tol_fun=1e-8 the f64 polish
    # finds <= 7e-4 lower cost (measured sweep: max_iter=60 left 2-8 %
    # on the table and one instance off its local optimum — the old
    # uncertified config over-reported throughput on suboptimal solves)
    assert gap_max <= 1e-3, f"polish found {gap_max:.2%} lower cost"
    print(json.dumps(out))


if __name__ == "__main__":
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    max_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 150
    main(batch=batch, max_iter=max_iter)
