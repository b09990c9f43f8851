import os

# persistent compile cache: JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache"),
)
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))
import time, numpy as np, jax, jax.numpy as jnp
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.problem import ADMMConfig
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_dp
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

N=100; ITERS=100
plant = DoubleIntegrator(1,2,dt=1.0/N)
d,m = plant.x_dim, plant.u_dim
zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.,0.])]).astype(jnp.float32)
Qs = jnp.stack([jnp.zeros((d,d)), jnp.eye(d)*1e3]).astype(jnp.float32)
seq = np.zeros(N,dtype=np.int32); seq[-1]=1
cost = viapoint_cost(zs,Qs,seq,1e-2,m)
A,B = plant.AB(N); A=A.astype(jnp.float32); B=B.astype(jnp.float32)
proj = lambda u: project_bound(u,-5.,5.)

for BATCH in [4096, 16384, 65536]:
    solve = make_batched_lqt_admm(A,B,cost,project_u=proj,rho_u=1e-2,n_iters=ITERS)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(0,0.1,size=(BATCH,d)),jnp.float32)
    x,u = solve(x0s); jax.block_until_ready(u)
    t0=time.perf_counter(); reps=5
    for _ in range(reps): x,u = solve(x0s)
    jax.block_until_ready(u)
    dt=(time.perf_counter()-t0)/reps
    print(f"GEMM batch={BATCH}: {dt*1e3:.2f} ms → {BATCH*ITERS/dt/1e6:.2f}M iters/s")
