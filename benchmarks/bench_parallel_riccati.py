"""Sequential scan vs associative-scan (parallel) Riccati at long horizons.

Both passes trace under HIGHEST matmul precision (true-f32 accuracy:
~5e-6 relative gain error; reduced-precision products, e.g. the GPU's
TF32 default, lose accuracy in the dual-element composition).

Time-axis parallelism showcase (SURVEY §2.3): the sequential backward
pass has O(N) dependent steps; the associative scan runs O(log N) rounds
of batched d×d solves. Crossover appears at long horizons / small
batches where the scan's latency dominates.
"""

import os

# persistent compile cache: JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from ilqr_admm_tpu.ops.parallel_riccati import lqt_backward_parallel
from ilqr_admm_tpu.ops.riccati import lqt_backward
from ilqr_admm_tpu.utils.cost_assembly import get_double_integrator_AB


def main():
    d, m = 4, 2
    A2, B2 = get_double_integrator_AB(2, 2, dt=0.01)
    for N in [100, 1000, 10000]:
        A = jnp.broadcast_to(A2, (N, d, d)).astype(jnp.float32)
        B = jnp.broadcast_to(B2, (N, d, m)).astype(jnp.float32)
        Q = jnp.broadcast_to(jnp.eye(d) * 1e2, (N, d, d)).astype(jnp.float32)
        xd = jnp.zeros((N, d), jnp.float32).at[-1, 0].set(1.0)
        R = jnp.broadcast_to(jnp.eye(m) * 1e-2, (N, m, m)).astype(jnp.float32)

        def _seq():
            with jax.default_matmul_precision("highest"):
                return lqt_backward(A, B, Q, xd, R)

        def _par():
            with jax.default_matmul_precision("highest"):
                return lqt_backward_parallel(A, B, Q, xd, R)

        def _blk():
            with jax.default_matmul_precision("highest"):
                return lqt_backward_parallel(A, B, Q, xd, R, block_size=128)

        def _par_f():
            with jax.default_matmul_precision("highest"):
                return lqt_backward_parallel(A, B, Q, xd, R, fast_inverse=True)

        def _blk_f():
            with jax.default_matmul_precision("highest"):
                return lqt_backward_parallel(
                    A, B, Q, xd, R, block_size=128, fast_inverse=True
                )

        seq = jax.jit(_seq)
        g_s = seq()
        jax.block_until_ready(g_s.K)
        kscale = float(jnp.max(jnp.abs(g_s.K)))

        def timeit(fn, reps=10):
            out = fn()
            jax.block_until_ready(out.K)
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn()
            jax.block_until_ready(out.K)
            return (time.perf_counter() - t0) / reps

        t_s = timeit(seq)
        line = f"N={N:>6}: sequential {t_s * 1e3:8.2f} ms"
        variants = [
            ("flat", _par), ("flat-fastinv", _par_f),
            ("blk128", _blk), ("blk128-fastinv", _blk_f),
        ]
        if N >= 10000:
            # the flat scan's log-depth program takes minutes to compile
            # at N=10k; bench only the blocked variants there
            variants = variants[2:]
        for name, f in variants:
            fn = jax.jit(f)
            g = fn()
            err = float(jnp.max(jnp.abs(g_s.K - g.K))) / max(kscale, 1e-30)
            t = timeit(fn)
            line += f" | {name} {t * 1e3:7.2f} ms ({t_s / t:5.2f}x, err {err:.1e})"
        print(line)


if __name__ == "__main__":
    main()
