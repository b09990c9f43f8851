"""Probe: per-iteration cost of lax.while_loop vs lax.scan on the
current backend.

On the GPU, XLA evaluates a while_loop's predicate on the host each
iteration (a device-to-host copy) unless it can turn the loop into a
fixed-trip one; a scan has a static trip count. The body is identical
(one small GEMM + elementwise), trip count varied, so slope =
per-iteration cost.

Run: python benchmarks/bench_while_vs_scan.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import jax
import jax.numpy as jnp
from jax import lax

D = 64


def body(c):
    return jnp.tanh(c @ c) * 0.5 + 0.5


def make_while(n):
    def f(x):
        def cond(carry):
            i, _ = carry
            return i < n

        def step(carry):
            i, c = carry
            return i + 1, body(c)

        return lax.while_loop(cond, step, (jnp.int32(0), x))[1]

    return jax.jit(f)


def make_scan(n):
    def f(x):
        def step(c, _):
            return body(c), None

        return lax.scan(step, x, None, length=n)[0]

    return jax.jit(f)


def measure(f, x):
    jax.block_until_ready(f(x))  # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3


x = jnp.full((D, D), 0.01, jnp.float32)

for n in (100, 400, 1600):
    tw = measure(make_while(n), x)
    tsn = measure(make_scan(n), x)
    print(
        f"n={n:5d}: while {tw:8.2f} ms ({tw / n * 1e3:6.1f} us/iter)   "
        f"scan {tsn:8.2f} ms ({tsn / n * 1e3:6.1f} us/iter)",
        flush=True,
    )
