"""Multi-chip weak-scaling harness: ADMM iterations/s/chip vs mesh size.

One command emits the iters/s/chip-vs-mesh-size curve (SURVEY §2.3
multi-host row; BASELINE.json north star: >=80 % linear scaling vs
1 chip). The workload is the headline metric's workload (bench.py): the
batched box-constrained LQT-ADMM at N=100 with a fixed per-chip batch
(weak scaling — each chip always solves PER_CHIP instances), sharded
over a ('data',) mesh via shard_map; there is no cross-instance
communication, so efficiency measures runtime/compiler overheads, not
algorithmic ones.

Usage:
    python benchmarks/bench_scaling.py                    # LQT-ADMM workload
    python benchmarks/bench_scaling.py --workload boxddp  # nonlinear DP fleet
    python benchmarks/bench_scaling.py --cpu8             # 8 virtual CPU devs

On a host with several GPUs run it as-is: it sweeps every power-of-two
mesh size the runtime exposes and prints one JSON line with the curve +
the measured scaling efficiency. Without GPUs use --cpu8 to validate the
harness on the virtual CPU mesh — the CPU efficiency numbers are NOT the
claim (8 virtual devices share the host's cores, so 'perfect' is
unreachable by construction); the harness running end-to-end is.
"""

import json
import sys

import numpy as np


def _lqt_workload(admm_iters: int):
    import jax.numpy as jnp

    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.projections import project_bound
    from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    N = 100
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    solve = make_batched_lqt_admm(
        A.astype(jnp.float32), B.astype(jnp.float32), cost,
        project_u=lambda u: project_bound(u, -5.0, 5.0),
        rho_u=1e-1, n_iters=admm_iters,
    )
    def sample(rng, n):
        return jnp.asarray(rng.normal(0.0, 0.1, size=(n, d)), jnp.float32)

    return solve, sample, admm_iters, "weak_scaling_admm_iters_per_s_per_chip_N100"


def _boxddp_workload(max_iter: int = 30):
    """Nonlinear fleet workload: full boxDDP car solves (N=100)."""
    import jax
    import jax.numpy as jnp

    from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
    from ilqr_admm_tpu.problem import ILQRConfig
    from ilqr_admm_tpu.solvers.boxddp import boxddp_init, boxddp_solve

    N = 100
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost()
    lo = jnp.asarray([-0.5, -2.0], jnp.float32)
    hi = jnp.asarray([0.5, 2.0], jnp.float32)
    u0 = jnp.zeros((N, 2), jnp.float32)
    cfg = ILQRConfig(max_iter=max_iter, tol_fun=1e-6)

    def solve(x0s):
        def one(x0):
            st0 = boxddp_init(car.step, cost, x0, u0, lo, hi)
            out = boxddp_solve(car.step, car.get_AB, cost.get_Cs, cost,
                               st0, lo, hi, cfg=cfg)
            return out.cost, out.u_nom

        return jax.vmap(one)(x0s)

    def sample(rng, n):
        base = np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
        return jnp.asarray(base + rng.normal(0, 0.05, (n, 4)), jnp.float32)

    return solve, sample, max_iter, "weak_scaling_boxddp_solve_iters_per_s_per_chip_N100"


def main(per_chip: int = 2048, admm_iters: int = 100, workload: str = "lqt"):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from benchmarks._certify import enable_compile_cache, timed_windows

    enable_compile_cache()
    if workload == "boxddp":
        per_chip = min(per_chip, 256)  # full DP solves are ~1000x heavier
        solve, sample, admm_iters, metric = _boxddp_workload()
    else:
        solve, sample, admm_iters, metric = _lqt_workload(admm_iters)

    devices = jax.devices()
    sizes = [k for k in (1, 2, 4, 8, 16, 32, 64, 128) if k <= len(devices)]
    rng = np.random.default_rng(0)

    rows = []
    for k in sizes:
        mesh = Mesh(np.asarray(devices[:k]), ("data",))
        sharded = jax.jit(
            jax.shard_map(
                solve, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
                check_vma=False,
            )
        )
        x0s = sample(rng, per_chip * k)
        jax.block_until_ready(sharded(x0s))  # compile + warm up
        dt = float(np.median(timed_windows(lambda: sharded(x0s), 10, 3)))
        iters_per_s = per_chip * k * admm_iters / dt
        rows.append(
            {
                "mesh": k,
                "batch": per_chip * k,
                "iters_per_s": round(iters_per_s, 1),
                "iters_per_s_per_chip": round(iters_per_s / k, 1),
            }
        )

    base = rows[0]["iters_per_s_per_chip"]
    for r in rows:
        r["efficiency"] = round(r["iters_per_s_per_chip"] / base, 4)
    print(
        json.dumps(
            {
                "metric": metric,
                "backend": jax.default_backend(),
                "per_chip_batch": per_chip,
                "admm_iters": admm_iters,
                "curve": rows,
                "efficiency_at_max_mesh": rows[-1]["efficiency"],
            }
        )
    )


if __name__ == "__main__":
    _wl = "boxddp" if "--workload" in sys.argv and \
        sys.argv[sys.argv.index("--workload") + 1] == "boxddp" else "lqt"
    if "--cpu8" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import os

        # must be set before backend init; harmless if already set
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
        )
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    main(workload=_wl)
