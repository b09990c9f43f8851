"""iLQR car-parking row: sequential vs time-parallel backward pass.

The HEADTOHEAD iLQR car row (N=500, d=4, ~100 outers) spends each outer
iteration on get_AB + a sequential Riccati scan + a 20-candidate rollout
batch. `riccati='parallel'` (associative-scan backward,
ops/parallel_riccati.py) may shave the scan at this N/d regime.

Run: python benchmarks/bench_car_parallel_riccati.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import numpy as np
import jax
import jax.numpy as jnp

from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.problem import ILQRConfig
from ilqr_admm_tpu.solvers.ilqr import ilqr_init, ilqr_solve

f32 = jnp.float32
Ncar = 500
car = CarFrontWheel(dt=15.0 / Ncar)
ccost = CarParkingCost()
rng = np.random.default_rng(0)
u0 = jnp.asarray(rng.normal(size=(Ncar, 2)) * 0.1, f32)
x0c = jnp.asarray([1.0, 1.0, 3 * np.pi / 2, 0.0], f32)
def solve(x0_, u0_, riccati, nls=40):
    cfg = ILQRConfig(max_iter=100, max_line_search_iter=nls)
    with jax.default_matmul_precision("highest"):
        s0 = ilqr_init(car.step, ccost, x0_, u0_)
        out = ilqr_solve(
            car.step, car.get_AB, ccost.get_Cs, ccost, s0, cfg, riccati=riccati
        )
        return out.cost, out.iteration


fns = {r: jax.jit(lambda x, u, r=r: solve(x, u, r))
       for r in ("chol", "parallel", "parallel_fast")}
fns["parallel_fast-ls25"] = jax.jit(lambda x, u: solve(x, u, "parallel_fast", 25))
fns["parallel-ls25"] = jax.jit(lambda x, u: solve(x, u, "parallel", 25))
# warm compiles
for name, f in fns.items():
    t0 = time.perf_counter()
    c, it = f(x0c, u0)
    c = float(c)
    print(f"{name}: compile+run {time.perf_counter()-t0:.1f}s cost={c:.4f}", flush=True)

for name, f in fns.items():
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        c, it = f(x0c, u0)
        c = float(c)
        ts.append(time.perf_counter() - t0)
    print(f"{name}: {min(ts)*1e3:.1f} ms  cost={c:.4f} iters={int(it)}", flush=True)
