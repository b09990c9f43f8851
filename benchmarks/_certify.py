"""Shared measurement and certification helpers for the benchmarks.

Every quoted number comes from (a) `timed_windows`: windows of calls
closed by `block_until_ready`, reported as median and IQR, on a device
named by `device_info`, and (b) a solution-quality certificate
(feasibility, convergence fraction, f64 oracle cost gap) — the same
machinery as bench.py.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(env=None) -> str:
    """`JAX_COMPILATION_CACHE_DIR` if set, else `<repo>/.jax_cache`."""
    env = os.environ if env is None else env
    return env.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir()`."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one line
    each (the process stays off JAX, so it opens no card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_info(require: str = "gpu") -> dict:
    """Platform, kind and count of JAX's devices, plus the card's name
    and power limit. Raises unless the platform is `require`: a
    measurement that finds no card fails, it does not fall back."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != require:
        raise RuntimeError(
            f"needs a {require} device; JAX found {dev.platform} "
            f"({dev.device_kind})"
        )
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name_and_power_limit().splitlines()[0],
    }


def timed_windows(run_once, calls: int = 10, windows: int = 5):
    """Seconds per call over `windows` windows of `calls` calls each.

    run_once() returns the device arrays of one call; each window ends
    with `block_until_ready` on the last call's result (the device runs
    calls in order). One untimed window warms the dispatch pipeline.
    Returns a (windows,) array; report its median and IQR."""
    import jax

    times = []
    for w in range(windows + 1):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = run_once()
        jax.block_until_ready(out)
        if w:
            times.append((time.perf_counter() - t0) / calls)
    return np.asarray(times)


def timed_rate(run_once, n_per_call: int, K: int = 10, reps: int = 3):
    """(n_per_call / median seconds per call, median seconds per call)
    over `reps` windows of K calls (`timed_windows`)."""
    t = float(np.median(timed_windows(run_once, K, reps)))
    return n_per_call / t, t


def median_iqr(times):
    """(median, q1, q3) of a sample of times."""
    q1, med, q3 = np.percentile(np.asarray(times), [25, 50, 75])
    return float(med), float(q1), float(q3)


def run_oracle(task: str, data: dict) -> dict:
    """Run a f64 CPU oracle (benchmarks/_oracles.py) in a subprocess.

    The child runs with JAX_PLATFORMS=cpu, so it never opens the card
    the parent holds. Data roundtrips via npz."""
    with tempfile.TemporaryDirectory() as td:
        f_in = os.path.join(td, "in.npz")
        f_out = os.path.join(td, "out.npz")
        np.savez(f_in, **data)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        # CPU entries embed host code: keep the child off the shared cache
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
        subprocess.run(
            [sys.executable, os.path.join(REPO, "benchmarks", "_oracles.py"),
             task, f_in, f_out],
            check=True, cwd=REPO, env=env, timeout=3600,
        )
        return dict(np.load(f_out))


def gaps(j_ours, j_star):
    """Relative cost excess of ours over the oracle, (median, max)."""
    j_ours = np.asarray(j_ours, np.float64)
    j_star = np.asarray(j_star, np.float64)
    g = (j_ours - j_star) / np.maximum(np.abs(j_star), 1e-12)
    return float(np.median(g)), float(np.max(g))
