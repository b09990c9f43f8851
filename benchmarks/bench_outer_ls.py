"""SQP-style outer line search study on the control-limited car.

Compares `ilqr_admm(line_search='outer')` — one nonlinear rollout batch
per outer step, inner ADMM on the linearized prediction — against the
reference-semantics 'inner' mode (rollouts every inner iteration,
`isls.py:456-478`) on the N=500 control-limited car golden
(BASELINE.md: reference cost 1.903 in 17.4 s).

Run:  python benchmarks/bench_outer_ls.py --backend cpu   (f64 quality)
      python benchmarks/bench_outer_ls.py --backend gpu   (f32 timing)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

p = argparse.ArgumentParser()
p.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
p.add_argument("--variants", default="ABCD", help="subset of ABCD to run")
args = p.parse_args()

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)

import jax

if args.backend == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu.solvers.ilqr_admm import ilqr_admm, ilqr_admm_continuation

dtype = jnp.float64 if args.backend == "cpu" else jnp.float32

Ncar = 500
car = CarFrontWheel(dt=15.0 / Ncar)
ccost = CarParkingCost()
rng = np.random.default_rng(0)
u0 = jnp.asarray(rng.normal(size=(Ncar, 2)) * 0.1, dtype)
x0c = jnp.asarray([1.0, 1.0, 3 * np.pi / 2, 0.0], dtype)
lo = jnp.asarray([-0.5, -2.0], dtype)
hi = jnp.asarray([0.5, 2.0], dtype)


def proj_uc(u):
    return jnp.clip(u.reshape(Ncar, 2), lo, hi).reshape(-1)


x_nom_c = rollout_nonlinear(car.step, x0c, u0)
alphas = (10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=dtype))[:20]


def run(name, fn):
    f = jax.jit(fn)
    t0 = time.perf_counter()
    r = f()
    jax.block_until_ready(r)
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = f()
        jax.block_until_ready(r)
        ts.append(time.perf_counter() - t0)
    ms = min(ts) * 1e3
    u = r.u_nom.reshape(Ncar, 2)
    viol = float(jnp.maximum(jnp.max(u - hi), jnp.max(lo - u)).clip(0))
    print(
        f"{name}: cost={float(r.cost):.4f} outers={int(r.outer_iters)} "
        f"time={ms:.1f} ms (compile {compile_s:.1f} s) max_viol={viol:.2e}"
    )
    return r


# A. current shipped config: rho continuation, inner line search
if "A" in args.variants: run(
    "A inner+continuation (shipped)",
    lambda: ilqr_admm_continuation(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc,
        phases=[
            dict(rho_u=jnp.diag(jnp.asarray([1e-1, 1e-2], dtype)),
                 max_iter=20, max_admm_iter=5, outer_tol=1e-4, osc_tol=1e-4),
            dict(rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], dtype)),
                 max_iter=30, max_admm_iter=8, outer_tol=1e-5, osc_tol=1e-5),
        ],
        alphas=alphas, tol=1e-3,
    ),
)

# B. outer line search + continuation (same schedule, cheap inner iters)
if "B" in args.variants: run(
    "B outer+continuation (same sched)",
    lambda: ilqr_admm_continuation(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc, line_search="outer",
        phases=[
            dict(rho_u=jnp.diag(jnp.asarray([1e-1, 1e-2], dtype)),
                 max_iter=20, max_admm_iter=5, outer_tol=1e-4, osc_tol=1e-4),
            dict(rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], dtype)),
                 max_iter=30, max_admm_iter=8, outer_tol=1e-5, osc_tol=1e-5),
        ],
        alphas=alphas, tol=1e-3,
    ),
)

# C. outer line search, deeper inner ADMM (iterations are rollout-free,
# so converge the consensus tighter per outer step)
if "C" in args.variants: run(
    "C outer+continuation deep-inner",
    lambda: ilqr_admm_continuation(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc, line_search="outer",
        phases=[
            dict(rho_u=jnp.diag(jnp.asarray([1e-1, 1e-2], dtype)),
                 max_iter=20, max_admm_iter=30, outer_tol=1e-4, osc_tol=1e-4),
            dict(rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], dtype)),
                 max_iter=30, max_admm_iter=50, outer_tol=1e-5, osc_tol=1e-5),
        ],
        alphas=alphas, tol=1e-3,
    ),
)

# D. outer line search, single phase (no continuation)
if "D" in args.variants: run(
    "D outer single-phase",
    lambda: ilqr_admm(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc, line_search="outer",
        rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], dtype)),
        max_iter=60, max_admm_iter=30,
        alphas=alphas, tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
    ),
)

# E. outer, looser outer_tol (fewer outers)
if "E" in args.variants: run(
    "E outer tol1e-4",
    lambda: ilqr_admm(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc, line_search="outer",
        rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], dtype)),
        max_iter=60, max_admm_iter=30,
        alphas=alphas, tol=1e-3, outer_tol=1e-4, osc_tol=1e-4,
    ),
)

# F. outer, shallower inner ADMM
if "F" in args.variants: run(
    "F outer inner10",
    lambda: ilqr_admm(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc, line_search="outer",
        rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], dtype)),
        max_iter=60, max_admm_iter=10,
        alphas=alphas, tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
    ),
)

# G. outer, slightly coarser rho (faster consensus, single phase)
if "G" in args.variants: run(
    "G outer rho3e-2",
    lambda: ilqr_admm(
        car.step, car.get_AB, ccost, x_nom_c, u0, get_Cs=ccost.get_Cs,
        project_u=proj_uc, line_search="outer",
        rho_u=jnp.diag(jnp.asarray([3e-2, 3e-3], dtype)),
        max_iter=60, max_admm_iter=30,
        alphas=alphas, tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
    ),
)
