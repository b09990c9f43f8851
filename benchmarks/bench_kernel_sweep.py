"""Launch-parameter sweep of the two fused Triton kernels vs XLA.

At chip_smoke's P1 and P2 widths (bench.py's 16,384 x N=100 LQT box
fleet, 100 iterations; the 1,024 x N=100 robust SLS diamond fleet, 200
iterations) it times the XLA path once and each kernel configuration:
in-loop product precision ("tf32x3", "ieee") x (batch_tile, Triton
warps per program, set through `ops/pallas_admm.py::NUM_WARPS`) in
CONFIGS. For each it prints the time per solve (median and IQR of
`block_until_ready` windows), the max difference from the XLA iterate
and, for P1, the converged share; a configuration the compiler refuses
(e.g. shared memory over the card's limit) is printed as refused.
PERF.md keeps the readings that chose the kernels' defaults.

Usage: python benchmarks/bench_kernel_sweep.py   (one GPU)
Prints one line per configuration, then one JSON line.
"""

import json
import os
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

PRECISIONS = ("tf32x3", "ieee")
CONFIGS = ((16, 8), (16, 4), (32, 8))  # (batch_tile, num_warps)


def _time_ms(solve, arg, calls=5, windows=3):
    from benchmarks._certify import median_iqr, timed_windows

    return [t * 1e3 for t in median_iqr(timed_windows(lambda: solve(arg),
                                                       calls, windows))]


def main():
    import jax
    import jax.numpy as jnp

    import bench
    import chip_smoke
    from benchmarks._certify import device_info, enable_compile_cache
    from ilqr_admm_tpu.ops import pallas_admm
    from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
    from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm
    from ilqr_admm_tpu.projections import project_weighted_l1
    from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm

    enable_compile_cache()
    dev = device_info(require="gpu")
    print(f"card: {dev['card']}", flush=True)
    rows = []

    def record(phase, name, build, arg, ref, conv=None):
        try:
            solve = build()
            out = jax.block_until_ready(solve(arg))
        except Exception as e:  # a refused configuration is a result
            print(f"{phase} {name}: refused ({type(e).__name__}: "
                  f"{str(e).splitlines()[0][:200]})", flush=True)
            rows.append({"phase": phase, "config": name, "refused": True})
            return
        ms = _time_ms(solve, arg)
        row = {"phase": phase, "config": name, "ms_median_iqr": ms}
        if ref is not None:
            row["max_abs_diff_vs_xla"] = float(jnp.max(jnp.abs(out[0] - ref)))
        if conv is not None:
            row["converged_frac"] = conv(out)
        print(f"{phase} {name}: {row}", flush=True)
        rows.append(row)

    # P1: the LQT box fleet; compare u (first output of the lambdas)
    A, B, cost = bench.lqt_box_problem(bench.N)
    x0s = bench.initial_states(bench.BATCH)
    conv = lambda o: float(jnp.mean(jnp.linalg.norm(o[0] - o[1], axis=-1)
                                    < 1e-4))
    xla = bench.make_solver("xla", A, B, cost)
    u_ref = jax.block_until_ready(xla(x0s))[0]
    record("P1", "xla", lambda: xla, x0s, None, conv)
    default_warps = pallas_admm.NUM_WARPS
    for prec in PRECISIONS:
        for tile, warps in CONFIGS:
            pallas_admm.NUM_WARPS = warps  # read when a kernel is built

            def build(prec=prec, tile=tile):
                s = make_pallas_lqt_admm(
                    A, B, cost, u_lower=-bench.U_BOUND, u_upper=bench.U_BOUND,
                    rho_u=bench.RHO_U, n_iters=bench.ADMM_ITERS,
                    batch_tile=tile, precision=prec)
                return jax.jit(lambda x: s(x)[1:])
            record("P1", f"{prec} tile {tile} warps {warps}", build, x0s,
                   u_ref, conv)

    # P2: the robust SLS diamond fleet; compare the slab iterate U
    A, B, cost, c, bounds = chip_smoke.sls_problem(1024, 100)
    w = jnp.asarray([1.0, c], jnp.float32)
    xla = make_batched_sls_admm(
        A, B, cost, project_u=lambda y, b: project_weighted_l1(y, w, b[:, None]),
        rho_u=1.0, robust_dim=1, n_iters=200)
    take_U = lambda s: jax.jit(lambda b: (s(b)[2],))
    U_ref = jax.block_until_ready(xla(bounds))[2]
    record("P2", "xla", lambda: take_U(xla), bounds, None)
    for prec in PRECISIONS:
        for tile, warps in CONFIGS:
            pallas_admm.NUM_WARPS = warps
            build = lambda prec=prec, tile=tile: take_U(make_pallas_sls_admm(
                A, B, cost, (), (), (), rho_u=1.0, robust_dim=1, n_iters=200,
                batch_tile=tile, precision=prec, z_update="diamond",
                diamond_w=(1.0, c)))
            record("P2", f"{prec} tile {tile} warps {warps}", build, bounds,
                   U_ref)
    pallas_admm.NUM_WARPS = default_warps
    print(json.dumps({"metric": "kernel_launch_sweep", "rows": rows, **dev}))


if __name__ == "__main__":
    main()
