"""boxDDP vs iLQR-ADMM on the control-limited car-parking task.

The reference reaches Tassa's control-limited DDP benchmark only through
ADMM splitting (`Car/Replicate of control-limited ddp car example.ipynb`);
this example runs the *first-class* DP treatment — the box-QP backward
pass (`solvers/boxddp.py`) — against the ADMM path on the same problem,
and a barrier interior-point solve with a per-stage SOC on the controls
(an input cone the reference cannot express at all).

Run: python examples/boxddp_car_parking.py [--animate [out.gif]]
--animate renders the boxDDP parking maneuver to a GIF (reference
parity: DDP-replicate notebook cell 22's animation).
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.problem import ILQRConfig
from ilqr_admm_tpu.solvers.barrier_ilqr import barrier_ilqr_solve, make_barrier
from ilqr_admm_tpu.solvers.boxddp import boxddp_init, boxddp_solve
from ilqr_admm_tpu.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu.problem import SolveStatus


def main():
    N = 500
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost()
    rng = np.random.default_rng(0)
    u0 = jnp.asarray(rng.normal(size=(N, 2)) * 0.1)
    x0 = jnp.asarray([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
    lo = jnp.asarray([-0.5, -2.0])
    hi = jnp.asarray([0.5, 2.0])
    cfg = ILQRConfig(max_iter=100, tol_fun=1e-7)

    st_u = ilqr_solve(
        car.step, car.get_AB, cost.get_Cs, cost,
        ilqr_init(car.step, cost, x0, u0), cfg=cfg,
    )
    print(f"unconstrained iLQR: cost {float(st_u.cost):.4f} "
          f"(reference ~0.93), status {SolveStatus(int(st_u.status)).name}")

    st_b = boxddp_solve(
        car.step, car.get_AB, cost.get_Cs, cost,
        boxddp_init(car.step, cost, x0, u0, lo, hi),
        u_lower=lo, u_upper=hi, cfg=cfg,
    )
    us = np.asarray(st_b.u_nom)
    print(f"boxDDP |u1|<=0.5 |u2|<=2: cost {float(st_b.cost):.4f} "
          f"(reference ADMM path 1.903), max|u| {np.abs(us / np.asarray([0.5, 2.0])).max():.6f} "
          f"of bound, status {SolveStatus(int(st_b.status)).name}")

    # r4: the exactness-certified time-parallel backward — same optimum,
    # O(log N) backward depth
    st_p = boxddp_solve(
        car.step, car.get_AB, cost.get_Cs, cost,
        boxddp_init(car.step, cost, x0, u0, lo, hi),
        u_lower=lo, u_upper=hi,
        cfg=ILQRConfig(max_iter=250, tol_fun=1e-7),  # each iteration is
        # O(log N) deep, so a larger cap still wins the wall clock
        riccati="parallel",
    )
    print(f"boxDDP parallel backward: cost {float(st_p.cost):.4f} "
          f"(sequential optimum 1.9053), "
          f"status {SolveStatus(int(st_p.status)).name}")

    # input cone: ||W u_t|| <= 1 with W = diag(1/0.5, 1/2.0) — a smooth
    # coupling of steering and acceleration authority
    W = jnp.asarray([2.0, 0.5])
    barrier = make_barrier(
        soc=lambda x, u: [(jnp.asarray(1.0, u.dtype), W * u)]
    )
    st_c = barrier_ilqr_solve(
        car.step, car.get_AB, cost.get_Cs, cost, x0, 0.0 * u0, barrier,
        cfg=ILQRConfig(max_iter=60, tol_fun=1e-9),
        mu0=1.0, mu_factor=6.0, n_barrier=8,
    )
    nrm = np.linalg.norm(np.asarray(st_c.u_nom) * np.asarray(W), axis=-1)
    print(f"barrier SOC ||W u||<=1: cost {float(st_c.cost):.4f}, "
          f"max||W u|| {nrm.max():.6f}, status {SolveStatus(int(st_c.status)).name}")
    return st_b


if __name__ == "__main__":
    st = main()
    if "--animate" in sys.argv:
        from ilqr_admm_tpu.viz import animate_car

        idx = sys.argv.index("--animate")
        out = (sys.argv[idx + 1] if len(sys.argv) > idx + 1
               and not sys.argv[idx + 1].startswith("-") else "car_parking.gif")
        path = animate_car(
            np.asarray(st.x_nom), np.asarray(st.u_nom), out,
            xlim=(-3, 3), ylim=(-3, 3), stride=10, fps=12,
        )
        print(f"animation written to {path}")
