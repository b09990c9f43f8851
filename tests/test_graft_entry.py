"""Driver-entry smoke tests (subprocess-isolated: own jax config)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
@pytest.mark.slow
def test_dryrun_multichip_subprocess():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import __graft_entry__ as g; g.dryrun_multichip(8, interpret=True); print('DRYRUN_OK')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert "DRYRUN_OK" in out.stdout, out.stdout + out.stderr


@pytest.mark.slow
@pytest.mark.slow
def test_entry_compiles_subprocess():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "import __graft_entry__ as g;"
         "fn, args = g.entry();"
         "o = jax.jit(fn)(*args); jax.block_until_ready(o); print('ENTRY_OK')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert "ENTRY_OK" in out.stdout, out.stdout + out.stderr
