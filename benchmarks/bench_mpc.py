"""Certified constrained-MPC serving throughput: device-resident vs per-tick.

Every single solve pays a host dispatch and a result copy, so an MPC
served by one host call per control tick is dispatch-bound once the
kernels are fast. The persistent-program pattern avoids that: the WHOLE closed
loop (controller x-update, ADMM projections, plant simulation) is one
`lax.scan` on device (`solvers/mpc.py::run_mpc`), so M ticks cost one
dispatch. A fleet of controllers additionally vmaps the tick.

Three measurements on the constrained car MPC (H=40, iLQR-ADMM per tick,
control bounds, duals warm-started across ticks — no reference analogue;
its replanning is linear/unconstrained only, `sls.py:244-248`):

1. per-tick dispatch: Python loop over the jitted tick; each tick's
   timing closes on the SCALAR READBACK of u (a real control loop needs
   u on the host);
2. device-resident: `run_mpc` scan, M ticks / dispatch, window closed by
   readback of the final controls;
3. fleet: vmapped tick inside the scan, K controllers at once.

Certificates: every measured path asserts max|u| <= U_MAX + 1e-4 and the
device-resident rollout must park the car (final position within 0.05 of
the target). Prints one JSON line.
"""

import json
import os

# persistent compile cache: JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from ilqr_admm_tpu.models.car import CarSimple
from ilqr_admm_tpu.ops.riccati import quad_cost_model
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.mpc import (
    make_mpc_step_constrained, mpc_constrained_init, run_mpc,
)
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

U_MAX = 0.6
TARGET = (2.0, 1.0)


def build(H=40):
    car = CarSimple(dt=0.1)
    d, m = 4, 2
    target = jnp.asarray([TARGET[0], TARGET[1], 0.0, 0.0], jnp.float32)
    zs = jnp.stack([target, target])
    Qs = jnp.stack([
        jnp.diag(jnp.asarray([1.0, 1.0, 0.0, 0.1])),
        jnp.diag(jnp.asarray([20.0, 20.0, 0.0, 1.0])),
    ]).astype(jnp.float32)
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def cost_fn(xs, us):
        dx = xs - quad.xd
        return (
            jnp.einsum("ti,tij,tj->", dx, quad.Q, dx)
            + jnp.einsum("ti,tij,tj->", us, quad.R, us)
        )

    def mk(**kw):
        return make_mpc_step_constrained(
            car.step, car.get_AB, cost_fn, get_Cs=get_Cs,
            project_u=lambda u: project_bound(u, -U_MAX, U_MAX),
            rho_u=1.0, n_outer_iters=2, n_admm_iters=5, **kw,
        )

    # default reference-semantics dp tick + the SQP serving tick
    # (rollout-free inner ADMM, one line search per outer step; same
    # tracking error and exact bounds)
    return car, mk(), mk(method="batch", line_search="outer"), d, m


def main(H=40, n_ticks=100, fleet=256):
    car, step, step_sqp, d, m = build(H)
    x0 = jnp.asarray([0.0, 0.0, 0.5, 0.0], jnp.float32)
    state = mpc_constrained_init(car.step, x0, jnp.zeros((H, m), jnp.float32))

    # --- 1. per-tick dispatch (the serving floor) -----------------------
    # Timed region = controller latency INCLUDING the u readback (a real
    # control loop consumes u on the host each tick); the plant advance
    # runs outside the timer.
    plant_step = jax.jit(car.step)
    u, st = step(state, x0)  # compile
    _ = float(np.asarray(u).ravel()[0])  # compile + warm up
    x, st = x0, state
    t_host = 0.0
    u_max_host = 0.0
    for _ in range(n_ticks):
        t0 = time.perf_counter()
        u, st = step(st, x)
        um = float(jnp.max(jnp.abs(u)))  # scalar readback closes the tick
        t_host += time.perf_counter() - t0
        u_max_host = max(u_max_host, um)
        x = plant_step(x, u)
    t_host /= n_ticks

    # --- 2. device-resident closed loop (one dispatch for all ticks) ----
    loop = jax.jit(
        lambda st, x0: run_mpc(car.step, step, st, x0, n_ticks)
    )
    xs, us, _ = loop(state, x0)
    jax.block_until_ready(us)
    reps = 5
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        xs, us, _ = loop(state, x0)
        _ = float(np.asarray(us[-1]).ravel()[0])  # readback closes window
        best = min(best, time.perf_counter() - t0)
    t_dev = best / n_ticks
    u_max_dev = float(jnp.max(jnp.abs(us)))
    final = np.asarray(xs[-1])

    # --- 3. fleet: K controllers per tick, still one dispatch -----------
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(0, 0.3, size=(fleet, d)), jnp.float32)
    states = jax.vmap(
        lambda a: mpc_constrained_init(car.step, a, jnp.zeros((H, m), jnp.float32))
    )(x0s)
    vstep = jax.vmap(step)

    def fleet_loop(sts, xs0):
        def scan_step(carry, _):
            x, st = carry
            u, st = vstep(st, x)
            return (jax.vmap(car.step)(x, u), st), u

        (_, sts), us = jax.lax.scan(scan_step, (xs0, sts), None, length=n_ticks)
        return us

    floop = jax.jit(fleet_loop)
    us_f = floop(states, x0s)
    jax.block_until_ready(us_f)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        us_f = floop(states, x0s)
        _ = float(np.asarray(us_f[-1]).ravel()[0])  # readback closes window
        best = min(best, time.perf_counter() - t0)
    t_fleet = best / n_ticks  # per fleet-tick
    u_max_fleet = float(jnp.max(jnp.abs(us_f)))

    # --- 4. SQP serving tick (device-resident + fleet) ------------------
    loop_sqp = jax.jit(
        lambda st, x0: run_mpc(car.step, step_sqp, st, x0, n_ticks)
    )
    xs_q, us_q, _ = loop_sqp(state, x0)
    jax.block_until_ready(us_q)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        xs_q, us_q, _ = loop_sqp(state, x0)
        _ = float(np.asarray(us_q[-1]).ravel()[0])
        best = min(best, time.perf_counter() - t0)
    t_sqp = best / n_ticks
    u_max_sqp = float(jnp.max(jnp.abs(us_q)))
    final_sqp = np.asarray(xs_q[-1])
    track_sqp = float(np.linalg.norm(final_sqp[:2] - np.asarray(TARGET)))

    vstep_q = jax.vmap(step_sqp)

    def fleet_loop_sqp(sts, xs0):
        def scan_step(carry, _):
            x, st = carry
            u, st = vstep_q(st, x)
            return (jax.vmap(car.step)(x, u), st), u

        (_, sts), us = jax.lax.scan(scan_step, (xs0, sts), None, length=n_ticks)
        return us

    floop_q = jax.jit(fleet_loop_sqp)
    us_fq = floop_q(states, x0s)
    jax.block_until_ready(us_fq)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        us_fq = floop_q(states, x0s)
        _ = float(np.asarray(us_fq[-1]).ravel()[0])
        best = min(best, time.perf_counter() - t0)
    t_fleet_sqp = best / n_ticks
    u_max_fleet_sqp = float(jnp.max(jnp.abs(us_fq)))

    # --- certificates ---------------------------------------------------
    track_err = float(np.linalg.norm(final[:2] - np.asarray(TARGET)))
    assert u_max_host <= U_MAX + 1e-4, f"host path max|u| {u_max_host}"
    assert u_max_dev <= U_MAX + 1e-4, f"device path max|u| {u_max_dev}"
    assert u_max_fleet <= U_MAX + 1e-4, f"fleet path max|u| {u_max_fleet}"
    assert track_err <= 0.05, f"car missed the target by {track_err}"
    assert u_max_sqp <= U_MAX + 1e-4, f"sqp path max|u| {u_max_sqp}"
    assert u_max_fleet_sqp <= U_MAX + 1e-4
    assert track_sqp <= 0.05, f"sqp tick missed the target by {track_sqp}"

    out = {
        "metric": "mpc_controller_ticks_per_s_fleet",
        "value": round(fleet / t_fleet, 1),
        "unit": f"controller-ticks/s (fleet {fleet}, H={H}, 2x5 ADMM iters/tick)",
        "host_dispatch_ms_per_tick": round(t_host * 1e3, 2),
        "device_resident_ms_per_tick": round(t_dev * 1e3, 3),
        "device_resident_speedup": round(t_host / t_dev, 1),
        "fleet_ms_per_fleet_tick": round(t_fleet * 1e3, 3),
        "max_u_over_paths": round(max(u_max_host, u_max_dev, u_max_fleet), 4),
        "u_max_bound": U_MAX,
        "tracking_error": float(f"{track_err:.3g}"),
        "sqp_tick": {
            "device_resident_ms_per_tick": round(t_sqp * 1e3, 3),
            "speedup_vs_dp_tick": round(t_dev / t_sqp, 2),
            "fleet_controller_ticks_per_s": round(fleet / t_fleet_sqp, 1),
            "max_u": round(max(u_max_sqp, u_max_fleet_sqp), 4),
            "tracking_error": float(f"{track_sqp:.3g}"),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
