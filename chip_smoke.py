"""On-card smoke test of the library's main paths, at full width.

    python chip_smoke.py               # one GPU: P0-P3
    python chip_smoke.py --four-cards  # four GPUs: the sharded fleet only

P0  device: a GPU or exit non-zero; print versions, flags and the card.
P1  LQT box fleet, bench.py's problem: 16,384 x N=100, 100 ADMM
    iterations, through the XLA path (`solvers/batched.py`) and the fused
    Triton kernel (`ops/pallas_admm.py`); bench.py's gates on both, and
    kernel-vs-XLA agreement.
P2  robust SLS scenario fleet: 1,024 x N=100, 200 iterations, exact
    diamond row set, through `solvers/batched_sls.py` +
    `project_weighted_l1` and the fused kernel (`ops/pallas_sls.py`);
    exact-diamond primal residual, f64 QP oracle on 8 scenarios, and
    kernel-vs-XLA agreement.
P3  nonlinear single-shot: car-parking iLQR and bounded-car iLQR-ADMM at
    N=500 in f32 against their reference goldens.
--four-cards: `__graft_entry__.dryrun_multichip(4)` with compiled
    kernels, and P1's fleet sharded over a 4-card ("data",) mesh on both
    paths, each compared with its single-card result.

Each phase is a function of its sizes and an explicit `interpret` flag
(the CPU tests run them small through the Pallas interpreter); any
failure raises. The last line of a passing run is one JSON object.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import bench
from benchmarks._certify import (
    card_name_and_power_limit,
    device_info,
    enable_compile_cache,
    median_iqr,
    run_oracle,
    timed_windows,
)

# in-kernel product precision on the card: TF32x3 (CPU runs pass "ieee")
PRECISION = "tf32x3"
# kernel vs XLA: same algorithm, same start, same update order; they
# differ by f32 rounding (the kernel folds two products into one
# precomputed operator), which ADMM carries but does not amplify
AGREE_ATOL = 1e-3


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    """A gate: raise (also under `python -O`) unless `ok`."""
    if not ok:
        raise AssertionError(what)


def phase_device(require: str = "gpu"):
    """P0: fail unless JAX's first device is a `require` device."""
    import jax

    try:
        info = device_info(require)
    except RuntimeError as e:
        raise SystemExit(f"P0: {e}; there is no fallback") from None
    log(f"P0 jax {jax.__version__}; devices {info['device_count']} x "
        f"{info['device_kind']}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"P0 nvidia-smi: {card_name_and_power_limit()}")
    return jax.devices()[0]


def _timing_line(tag, solve, args, calls, windows):
    """Log the compiled program's memory analysis and, with `windows`,
    the time per call on the card (with its name and power limit)."""
    compiled = solve.lower(*args).compile()
    log(f"{tag} memory_analysis: {compiled.memory_analysis()}")
    if not windows:
        return None
    med, q1, q3 = median_iqr(
        timed_windows(lambda: solve(*args), calls, windows))
    card = card_name_and_power_limit().splitlines()[0]
    log(f"{tag} time per solve: median {med * 1e3:.4f} ms, IQR "
        f"[{q1 * 1e3:.4f}, {q3 * 1e3:.4f}] ms ({windows} windows x "
        f"{calls} calls; card {card})")
    return med


def phase_lqt_fleet(batch=bench.BATCH, N=bench.N, n_iters=bench.ADMM_ITERS,
                    batch_tile=bench.BATCH_TILE, precision=PRECISION,
                    oracle_n=64, windows=5, interpret=False):
    """P1: the LQT box fleet through the XLA path and the kernel."""
    import jax.numpy as jnp

    A, B, cost = bench.lqt_box_problem(N)
    x0s = bench.initial_states(batch)
    out, times = {}, {}
    for path in ("xla", "pallas"):
        solve = bench.make_solver(path, A, B, cost, n_iters=n_iters,
                                  batch_tile=batch_tile, precision=precision,
                                  interpret=interpret)
        u, z_u = solve(x0s)
        cert = bench.certify(A, B, cost, x0s, u, z_u, oracle_n=oracle_n)
        log(f"P1 {path}: {cert}")
        times[path] = _timing_line(f"P1 {path}", solve, (x0s,), 5, windows)
        out[path] = (u, z_u)
    du = float(jnp.max(jnp.abs(out["pallas"][0] - out["xla"][0])))
    dz = float(jnp.max(jnp.abs(out["pallas"][1] - out["xla"][1])))
    log(f"P1 kernel vs XLA ({precision}): max|du| {du:.3e}, max|dz| {dz:.3e} "
        f"(atol {AGREE_ATOL})")
    check(du <= AGREE_ATOL and dz <= AGREE_ATOL, f"P1 agreement {du}, {dz}")
    return out, times


def sls_problem(batch, N, seed=0):
    """bench_pallas_sls.py's scenario fleet: 95% chance level, sigma 0.1,
    per-scenario bounds ~ U(2, 4)."""
    import jax.numpy as jnp
    from scipy.stats import norm

    A, B, cost = bench.lqt_box_problem(N)
    c_coef = float(norm.ppf(0.95)) * 0.1
    rng = np.random.default_rng(seed)
    bounds = jnp.asarray(rng.uniform(2.0, 4.0, batch), jnp.float32)
    return A, B, cost, c_coef, bounds


def phase_sls_fleet(batch=1024, N=100, n_iters=200, batch_tile=16,
                    precision=PRECISION, oracle_n=8, windows=5,
                    interpret=False):
    """P2: the robust SLS diamond fleet through the XLA path and the
    kernel."""
    import jax
    import jax.numpy as jnp

    from benchmarks._oracles import _project_diamond
    from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm
    from ilqr_admm_tpu.projections import project_weighted_l1
    from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm

    A, B, cost, c_coef, bounds = sls_problem(batch, N)
    w = jnp.asarray([1.0, c_coef], jnp.float32)
    solvers = {
        "xla": make_batched_sls_admm(
            A, B, cost,
            project_u=lambda y, b: project_weighted_l1(y, w, b[:, None]),
            rho_u=1.0, robust_dim=1, n_iters=n_iters),
        "pallas": make_pallas_sls_admm(
            A, B, cost, (), (), (), rho_u=1.0, robust_dim=1,
            n_iters=n_iters, batch_tile=batch_tile, precision=precision,
            z_update="diamond", diamond_w=(1.0, c_coef),
            interpret=interpret),
    }
    b_np = np.asarray(bounds, np.float64)
    Us = {path: np.asarray(jax.block_until_ready(solve(bounds)[2]), np.float64)
          for path, solve in solvers.items()}
    # the f64 QP oracle on `oracle_n` scenarios of each path, two per CPU
    # subprocess, all at once (trust-constr takes seconds per scenario)
    idx = np.linspace(0, batch - 1, oracle_n).astype(int)
    data = {"A": np.asarray(A, np.float64), "B": np.asarray(B, np.float64),
            "Q": np.asarray(cost.Q, np.float64),
            "R": np.asarray(cost.R, np.float64),
            "xd": np.asarray(cost.lifted_xd(), np.float64), "c": c_coef}
    jobs = [(path, chunk) for path in Us
            for chunk in np.array_split(idx, max(1, oracle_n // 2))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        orcs = list(pool.map(lambda job: run_oracle("sls_qp", dict(
            data, bounds=b_np[job[1]], U=Us[job[0]][job[1]])), jobs))
    times = {}
    for path, solve in solvers.items():
        U = Us[path]
        check(np.all(np.isfinite(U)), f"P2 {path}: non-finite iterate")
        prim = np.array([
            np.linalg.norm(U[i] - _project_diamond(U[i], c_coef, b_np[i]))
            for i in range(batch)
        ])
        g = np.concatenate([(o["j_z"] - o["j_star"]) / np.abs(o["j_star"])
                            for (p, _), o in zip(jobs, orcs) if p == path])
        cert = {"prim_max": float(prim.max()),
                "converged_frac": float(np.mean(prim < 5e-3)),
                "cost_gap_median": float(np.median(g)),
                "cost_gap_max": float(np.max(g))}
        log(f"P2 {path}: {cert}")
        # bench_pallas_sls.py's gates
        check(cert["converged_frac"] >= 0.99
              and cert["cost_gap_median"] <= 1e-4
              and cert["cost_gap_max"] <= 1e-3, f"P2 {path} gates: {cert}")
        times[path] = _timing_line(f"P2 {path}", solve, (bounds,), 5, windows)
    dU = float(np.max(np.abs(Us["pallas"] - Us["xla"])))
    log(f"P2 kernel vs XLA ({precision}): max|dU| {dU:.3e} (atol {AGREE_ATOL})")
    check(dU <= AGREE_ATOL, f"P2 agreement {dU}")
    return Us, times


def phase_nonlinear(N=500, ilqr_iters=100, admm_outer=60, gates=True):
    """P3: car-parking iLQR and bounded-car iLQR-ADMM through the public
    solvers, in f32 (no kernel runs here). Goldens: 0.9283 and 1.9055;
    tolerances as tests/test_ilqr.py and tests/test_ilqr_admm.py."""
    import jax.numpy as jnp

    from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
    from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
    from ilqr_admm_tpu.problem import ILQRConfig
    from ilqr_admm_tpu.solvers.ilqr import ilqr_init, ilqr_solve
    from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm

    f32 = jnp.float32
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost()
    x0 = jnp.asarray([1.0, 1.0, 3.0 * np.pi / 2, 0.0], f32)

    u0 = jnp.asarray(np.random.default_rng(42).normal(size=(N, 2)) * 0.1, f32)
    t0 = time.perf_counter()
    st = ilqr_solve(car.step, car.get_AB, cost.get_Cs, cost,
                    ilqr_init(car.step, cost, x0, u0),
                    ILQRConfig(max_iter=ilqr_iters, max_line_search_iter=40,
                               tol_fun=1e-5), method="dp")
    c_ilqr = float(st.cost)
    log(f"P3 car iLQR: cost {c_ilqr:.5f} (golden 0.9283, test bound < 1.1; "
        f"{time.perf_counter() - t0:.1f} s incl. compile)")

    u0 = jnp.asarray(np.random.default_rng(3).normal(size=(N, 2)) * 0.1, f32)
    lo = jnp.asarray([-0.5, -2.0], f32)
    hi = jnp.asarray([0.5, 2.0], f32)
    t0 = time.perf_counter()
    res = ilqr_admm(
        car.step, car.get_AB, cost, rollout_nonlinear(car.step, x0, u0), u0,
        get_Cs=cost.get_Cs,
        project_u=lambda u: jnp.clip(u.reshape(N, 2), lo, hi).reshape(-1),
        rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], f32)),
        max_iter=admm_outer, max_admm_iter=8,
        alphas=10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=f32)[:40],
        tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
    )
    us = np.asarray(res.u_nom)
    c_admm = float(res.cost)
    viol = float(max(np.max(np.abs(us[:, 0])) - 0.5,
                     np.max(np.abs(us[:, 1])) - 2.0, 0.0))
    log(f"P3 car iLQR-ADMM: cost {c_admm:.5f} (golden 1.9055, test bounds "
        f"(0.9, 1.92)), max bound violation {viol:.2e} (test bound 1e-3; "
        f"{time.perf_counter() - t0:.1f} s incl. compile)")
    check(np.isfinite(c_ilqr) and np.isfinite(c_admm), "P3 non-finite cost")
    if gates:
        check(c_ilqr < 1.1, f"P3 iLQR cost {c_ilqr}")
        check(0.9 < c_admm < 1.92 and viol <= 1e-3,
              f"P3 iLQR-ADMM cost {c_admm}, violation {viol}")
    return c_ilqr, c_admm


def phase_four_cards(n_cards=4, batch=bench.BATCH, N=bench.N,
                     n_iters=bench.ADMM_ITERS, batch_tile=bench.BATCH_TILE,
                     precision=PRECISION, interpret=False):
    """The multi-card path: the dry run with compiled kernels, then P1's
    fleet sharded over an (n_cards,) ("data",) mesh on both paths, each
    compared with its single-card result."""
    import jax
    from jax.sharding import Mesh

    import __graft_entry__
    from ilqr_admm_tpu.parallel.batch import sharded_instance_solve

    if len(jax.devices()) < n_cards:
        raise SystemExit(f"needs {n_cards} devices, found {len(jax.devices())}")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_cards, interpret=interpret)
    log(f"4C dryrun_multichip({n_cards}) passed "
        f"({time.perf_counter() - t0:.1f} s)")

    A, B, cost = bench.lqt_box_problem(N)
    x0s = bench.initial_states(batch)
    mesh = Mesh(np.asarray(jax.devices()[:n_cards]), ("data",))
    # a card's shard is solved exactly as a single-card run of those
    # instances would be, but the setup GEMMs see a smaller batch and
    # may round differently, and u = u_base + s @ W cancels large terms:
    # agreement to AGREE_ATOL, as between the two paths
    atol = AGREE_ATOL
    for path in ("xla", "pallas"):
        solve = bench.make_solver(path, A, B, cost, n_iters=n_iters,
                                  batch_tile=batch_tile, precision=precision,
                                  interpret=interpret)
        u1, z1 = jax.block_until_ready(solve(x0s))
        u4, z4 = jax.block_until_ready(
            sharded_instance_solve(solve, mesh, x0s))
        shards = {s.device for s in u4.addressable_shards}
        err = max(float(np.max(np.abs(np.asarray(u4) - np.asarray(u1)))),
                  float(np.max(np.abs(np.asarray(z4) - np.asarray(z1)))))
        log(f"4C {path}: sharded over {len(shards)} cards vs one card: "
            f"max abs diff {err:.3e} (atol {atol})")
        check(len(shards) == n_cards, f"4C {path}: shards on {shards}")
        check(err <= atol, f"4C {path}: sharded vs one card {err}")
        bench.certify(A, B, cost, x0s, u4, z4)


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card smoke test.")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded fleet phase")
    args = ap.parse_args(argv)

    import jax

    enable_compile_cache()
    dev = phase_device("gpu")
    if args.four_cards:
        phase_four_cards(4)
    else:
        phase_lqt_fleet()
        phase_sls_fleet()
        phase_nonlinear()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())
