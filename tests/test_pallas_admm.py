"""Fused Pallas (Triton) ADMM kernel vs the XLA GEMM path.

The kernel runs through the Pallas interpreter on CPU (interpret=True,
in-kernel products at "ieee" precision — the CPU has no TF32). Its
lowering to Triton for the GPU is checked by cross-lowering for the
"cuda" platform, which needs no card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.pallas_admm import (
    MAX_KERNEL_NM,
    NUM_WARPS,
    kernel_fits,
    make_pallas_lqt_admm,
    next_pow2,
)
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

# the Pallas interpreter at IEEE f32 products (XLA:CPU has no TF32)
CPU = dict(interpret=True, precision="ieee")
# sharded vs whole-batch solve, as kernel vs XLA: XLA:CPU rounds the
# f32 setup products differently at batch 16 and 128, and the kernel
# carries that into u (max |du| 4.6e-4, |dx| 2.0e-5 in the shard_map
# test below)
WHOLE_BATCH_ATOL = 1e-3


def _problem(N=40):
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    return plant, A.astype(jnp.float32), B.astype(jnp.float32), cost


def _x0s(n, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, scale, size=(n, 2)), jnp.float32)


def test_pallas_u_only_matches_xla():
    """Same warm start, same update order: the kernel reproduces the XLA
    path's iterates up to f32 rounding (the kernel folds the two x-update
    products into one precomputed operator)."""
    N = 40
    plant, A, B, cost = _problem(N)
    solve_p = make_pallas_lqt_admm(
        A, B, cost, u_lower=-5.0, u_upper=5.0, rho_u=1e-2,
        n_iters=50, batch_tile=16, **CPU,
    )
    solve_x = make_batched_lqt_admm(
        A, B, cost, project_u=lambda u: project_bound(u, -5.0, 5.0),
        rho_u=1e-2, n_iters=50,
    )
    x0s = _x0s(32)
    x_p, u_p, zu = solve_p(x0s)
    x_r, u_r = solve_x(x0s)
    assert float(jnp.max(jnp.abs(u_p - u_r))) < 1e-3
    assert float(jnp.max(jnp.abs(x_p - x_r))) < 1e-3  # post-loop Wx recovery
    assert float(jnp.max(jnp.abs(zu))) <= 5.0  # z feasible by construction


@pytest.mark.parametrize("path", ["u_only", "u_only_early_exit"])
def test_pallas_ragged_batch_pads_and_slices(path):
    """A batch that is not a multiple of the tile is padded, and N·m,
    N·d are padded to powers of two; padded columns carry zero operator
    rows/columns and [0, 0] bounds, so they stay exactly zero, and the
    sliced outputs equal those of the same instances in a full batch
    (also when a tile of padded rows exits early)."""
    N = 20  # N·m = 20 -> 32, N·d = 40 -> 64
    _, A, B, cost = _problem(N)
    solve = make_pallas_lqt_admm(
        A, B, cost, u_lower=-5.0, u_upper=5.0, rho_u=1e-1,
        n_iters=30, batch_tile=16,
        stop_tol=1e-4 if path == "u_only_early_exit" else 0.0, **CPU,
    )
    x0s = _x0s(32, seed=2)
    full = solve(x0s)
    ragged = solve(x0s[:20])
    padded = solve.padded(x0s[:20])
    assert [o.shape for o in ragged] == [(20, 40), (20, 20), (20, 20)]
    assert [o.shape for o in padded] == [(32, 64), (32, 32), (32, 32)]
    for out_r, out_f in zip(ragged, full):
        np.testing.assert_allclose(np.asarray(out_r), np.asarray(out_f[:20]),
                                   rtol=0, atol=1e-6)
    x_p, u_p, zu_p = padded
    for arr, used in ((x_p, 2 * N), (u_p, N), (zu_p, N)):
        assert float(jnp.max(jnp.abs(arr[:, used:]))) == 0.0


def test_pallas_builder_rejects_bounds_without_rho():
    """Bounds without a (nonzero) rho would make the kernel return the
    unconstrained optimum while looking feasible."""
    _, A, B, cost = _problem(16)
    with pytest.raises(ValueError, match="rho_u"):
        make_pallas_lqt_admm(A, B, cost, u_lower=-1.0, u_upper=1.0)
    with pytest.raises(ValueError, match="rho_u"):
        make_pallas_lqt_admm(A, B, cost, u_lower=-1.0, u_upper=1.0, rho_u=0.0)


@pytest.mark.parametrize("kw, match", [
    (dict(u_lower=None, u_upper=None), "control bounds required"),
    (dict(batch_tile=8), "batch_tile"),
    (dict(batch_tile=24), "batch_tile"),
    (dict(precision="bf16"), "precision"),
    (dict(n_iters=0), "n_iters"),
])
def test_pallas_builder_rejects_bad_config(kw, match):
    _, A, B, cost = _problem(16)
    kw = dict(dict(u_lower=-1.0, u_upper=1.0, rho_u=0.1), **kw)
    with pytest.raises(ValueError, match=match):
        make_pallas_lqt_admm(A, B, cost, **kw)


def test_pallas_refuses_compiled_kernel_on_cpu():
    """Without interpret=True the kernel compiles for the GPU only: on a
    CPU backend the call raises; nothing switches to the interpreter."""
    _, A, B, cost = _problem(16)
    solve = make_pallas_lqt_admm(A, B, cost, u_lower=-1.0, u_upper=1.0,
                                 rho_u=0.1, batch_tile=16)
    with pytest.raises(Exception, match="interpret"):
        solve(_x0s(16))


def test_kernel_path_choice_by_width():
    """The kernel keeps the (Nm x Nm) operator on chip up to a padded
    N·m of MAX_KERNEL_NM; wider fleets (bench_wide_certified.py's
    Nm = 512) run the XLA path, and the builder refuses them."""
    assert MAX_KERNEL_NM == 128
    assert [next_pow2(n) for n in (1, 16, 17, 100, 128, 129)] == [
        16, 16, 32, 128, 128, 256]
    assert kernel_fits(100) and kernel_fits(128)
    assert not kernel_fits(129) and not kernel_fits(512)
    _, A, B, cost = _problem(130)  # N·m = 130 (m = 1)
    with pytest.raises(ValueError, match="does not fit"):
        make_pallas_lqt_admm(A, B, cost, u_lower=-1.0, u_upper=1.0, rho_u=0.1)


@pytest.mark.parametrize("precision", ["ieee", "tf32x3"])
@pytest.mark.parametrize("variant", ["u_only", "u_only_early_exit"])
def test_pallas_lowers_to_triton_for_gpu(variant, precision):
    """Cross-lower the compiled (non-interpreted) kernel for the "cuda"
    platform: the Pallas -> Triton lowering (power-of-two blocks, one-axis
    reductions, supported primitives, dot precision) runs here without a
    card; only Triton's own compile to the card is left for the chip."""
    N = 100  # the benchmark width: N·m = 100 -> 128
    _, A, B, cost = _problem(N)
    solve = make_pallas_lqt_admm(
        A, B, cost, u_lower=-5.0, u_upper=5.0, rho_u=0.1,
        batch_tile=16, precision=precision,
        stop_tol=1e-4 if variant == "u_only_early_exit" else 0.0,
    )
    text = jax.jit(solve.padded).trace(_x0s(48)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
    assert f"num_warps = {NUM_WARPS} " in text


def test_pallas_u_only_early_exit_matches_full_schedule():
    """stop_tol > 0 (per-tile early exit) returns the same solution as
    the fixed-iteration schedule on an easy fleet: a tile exits only
    once its primal residual and z-motion are under stop_tol."""
    N = 40
    plant, A, B, cost = _problem(N)
    # n_iters = 15 chunks x 8 + the final iteration: a tile that never
    # exits runs exactly the fixed schedule
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-2, n_iters=121,
              batch_tile=16, **CPU)
    solve_full = make_pallas_lqt_admm(A, B, cost, **kw)
    solve_exit = make_pallas_lqt_admm(A, B, cost, stop_tol=1e-5, **kw)
    x0s = _x0s(32, seed=1)
    x_f, u_f, zu_f = solve_full(x0s)
    x_e, u_e, zu_e = solve_exit(x0s)
    np.testing.assert_allclose(np.asarray(u_e), np.asarray(u_f), atol=2e-4)
    np.testing.assert_allclose(np.asarray(x_e), np.asarray(x_f), atol=2e-4)
    assert float(jnp.max(jnp.abs(zu_e))) <= 5.0
    r_f = jnp.max(jnp.abs(u_f - zu_f), axis=1)
    r_e = jnp.max(jnp.abs(u_e - zu_e), axis=1)
    np.testing.assert_allclose(np.asarray(r_e), np.asarray(r_f), atol=2e-4)


def test_pallas_fleet_shard_map_matches_single_device():
    """shard_map over ('data',) wrapping the fused kernel. Each shard
    must equal a single-device replay of those instances exactly: pure
    instance parallelism, so the result cannot depend on which device
    owns the shard. The whole batch solved at once must agree to
    WHOLE_BATCH_ATOL: the per-solve setup products before the kernel
    (x0 -> u_base, u0, x_base) are XLA matmuls whose f32 rounding may
    depend on the batch size they see, and u = u_base + s @ W cancels
    large terms. Mirrors the `dryrun_multichip` section in
    `__graft_entry__.py`."""
    from jax.sharding import Mesh, PartitionSpec as P

    N = 40
    plant, A, B, cost = _problem(N)
    solve_p = make_pallas_lqt_admm(
        A, B, cost, u_lower=-5.0, u_upper=5.0, rho_u=1e-1,
        n_iters=40, batch_tile=16, **CPU,
    )
    n_dev = jax.device_count()
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    sharded = jax.jit(jax.shard_map(
        solve_p, mesh=mesh, in_specs=(P("data"),),
        out_specs=(P("data"),) * 3, check_vma=False,
    ))
    x0s = _x0s(16 * n_dev, seed=3)
    # cache-loaded multi-device programs can hard-abort on this
    # jaxlib's XLA:CPU runtime (see conftest) — compile fresh
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        out_s = sharded(x0s)
        replay = [solve_p(x) for x in jnp.split(x0s, n_dev)]
        out_r = [jnp.concatenate(o) for o in zip(*replay)]
        out_w = solve_p(x0s)
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
    for s, r, w in zip(out_s, out_r, out_w):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(r))
        np.testing.assert_allclose(np.asarray(s), np.asarray(w),
                                   rtol=0, atol=WHOLE_BATCH_ATOL)
    assert float(jnp.max(jnp.abs(out_s[2]))) <= 5.0
