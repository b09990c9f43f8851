"""chip_smoke.py on CPU: each phase at a tiny size through the Pallas
interpreter, P0's refusal of a machine without a GPU, the compile-cache
choice, and one card-only check (marker `gpu`, run on the card)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from benchmarks import _certify  # noqa: E402

# the Pallas interpreter at IEEE f32 products (XLA:CPU has no TF32)
CPU = dict(interpret=True, precision="ieee")


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no fallback"):
        chip_smoke.phase_device("gpu")


def test_chip_smoke_exits_nonzero_without_gpu():
    """The script as the driver runs it: no card -> non-zero exit, and no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "P0: needs a gpu device" in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("set_env", [False, True])
def test_compile_cache_dir(set_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if set_env else {}
    want = str(tmp_path) if set_env else os.path.join(REPO, ".jax_cache")
    assert _certify.compile_cache_dir(env) == want


def test_phase_lqt_fleet_tiny():
    """P1 at N=100 (the gates need the benchmark's horizon) on 40
    instances: both paths pass bench.py's gates and agree."""
    out, _ = chip_smoke.phase_lqt_fleet(
        batch=40, n_iters=100, oracle_n=4, windows=0, **CPU)
    assert out["pallas"][0].shape == (40, 100)


def test_phase_sls_fleet_tiny():
    out, _ = chip_smoke.phase_sls_fleet(
        batch=20, N=20, n_iters=200, oracle_n=2, windows=0, **CPU)
    assert out["pallas"].shape == (20, 20, 2)


def test_phase_nonlinear_tiny():
    """P3's code path at N=60 and few iterations (the goldens hold at
    N=500 only, so the gates stay off here)."""
    c_ilqr, c_admm = chip_smoke.phase_nonlinear(
        N=60, ilqr_iters=20, admm_outer=5, gates=False)
    assert c_ilqr > 0.0 and c_admm > 0.0


def test_four_cards_phase_shard_map_on_cpu_mesh():
    """--four-cards rehearsed on four virtual CPU devices: the dry run
    with interpreted kernels, then P1's fleet sharded over a ('data',)
    mesh on both paths against the single-device result."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import chip_smoke as cs;"
        "cs.phase_four_cards(4, batch=64, n_iters=100, precision='ieee',"
        " interpret=True); print('FOUR_OK')"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert "FOUR_OK" in out.stdout, out.stdout[-3000:] + out.stderr[-3000:]
    assert "4C pallas: sharded over 4 cards" in out.stdout


@pytest.mark.gpu
def test_kernels_compile_and_pass_gates_on_card(gpu):
    """Both kernels compiled for the card (TF32x3 products) at the
    benchmark width on a 1,024-instance fleet: gates and agreement."""
    chip_smoke.phase_lqt_fleet(batch=1024, oracle_n=8, windows=0)
    chip_smoke.phase_sls_fleet(batch=256, oracle_n=2, windows=0)
    print(json.dumps({"card": _certify.card_name_and_power_limit(),
                      "kind": gpu.device_kind}))
