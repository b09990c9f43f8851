"""Test configuration: CPU backend with a virtual 8-device mesh, f64 on.

Tests run on CPU (per the multi-host test strategy, SURVEY §4): an
8-device virtual platform validates the sharding/mesh code paths without
accelerator hardware, and float64 gives tight numeric oracles against
the math.

The one exception is the card-only selection, `python -m pytest -o
addopts="" -m gpu tests/` (README): it runs the tests marked `gpu` on
the GPU, which skip anywhere else (`gpu` fixture).
"""

import os
import sys

_CARD_RUN = any(
    a == "-m" and b == "gpu" for a, b in zip(sys.argv, sys.argv[1:])
)

if not _CARD_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _CARD_RUN:
    # A pytest plugin may import jax before this conftest runs, in which
    # case the env var above is read too late; backends initialize
    # lazily, so forcing the platform through the config still works.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# Persistent compile cache: the suite's long tail on a small box is XLA
# CPU compile time (~140 jitted tests); with the cache warm a rerun skips
# nearly all of it. JAX_COMPILATION_CACHE_DIR wins when set. Otherwise
# CPU entries, which embed host-AOT machine code, get their own
# directory fingerprinted by host CPU features (the loader itself warns
# a feature mismatch "could lead to execution errors such as SIGILL").
import hashlib  # noqa: E402
import platform  # noqa: E402


def _cpu_fingerprint() -> str:
    # x86 spells the ISA-feature line "flags", ARM spells it "Features" —
    # a bare platform.machine() fallback would let e.g. two aarch64 hosts
    # with different feature sets share host-AOT entries, which is the
    # exact hazard this fingerprint exists to prevent
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return platform.machine()


jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".jax_cache_cpu",
        _cpu_fingerprint(),
    ),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# Tests whose executables contain CROSS-DEVICE COLLECTIVES must not use
# the persistent cache at all: on this jaxlib (0.9.0, XLA:CPU thunk
# runtime) EXECUTING a cache-loaded multi-device collective program is
# flakily broken — some participant threads never reach the all_gather
# rendezvous, XLA waits 40 s, then hard-aborts the whole process
# ("Exiting to ensure a consistent program state"). Reproduced ~50% on
# cache hits (fresh same-machine entries included) and 0/8 with the
# cache disabled; the compile-every-time cost for these modules is a few
# seconds each.
_COLLECTIVE_TEST_MODULES = {
    "test_consensus_parallel",
    "test_distributed",
    "test_parallel",
    "test_time_sharded",
    "test_graft_entry",
}


import pytest as _pytest  # noqa: E402


def pytest_xdist_auto_num_workers(config):
    """Resolve `-n auto` (pytest.ini): 2 workers only on >=4-core hosts.

    On a 2-core box a worker executing an 8-device collective program
    hard-aborts (XLA:CPU rendezvous 40 s spin-wait) whenever the other
    worker's XLA compile pegs both cores — reproduced 3x on the same
    test in r5 full-suite runs, 0x serial or in isolation.
    """
    return 2 if (os.cpu_count() or 1) >= 4 else 1


def pytest_collection_modifyitems(config, items):
    """Serialize cross-device-collective tests onto ONE xdist worker.

    XLA:CPU's collective rendezvous spin-waits for all participants; on
    a low-core host two concurrently executing 8-device collective
    programs (or one plus a heavy compile) can starve each other past
    the 40 s rendezvous timeout, hard-aborting the worker ("Exiting to
    ensure a consistent program state" — observed twice in r5 full-suite
    runs after a shard_map test was added outside the collective
    modules). With --dist loadgroup (pytest.ini) this mark routes every
    collective test to the same worker so at most one multi-device
    program executes at a time; ungrouped tests still load-balance.
    """
    for item in items:
        mod = getattr(getattr(item, "module", None), "__name__", "")
        if mod in _COLLECTIVE_TEST_MODULES or "shard_map" in item.name:
            item.add_marker(_pytest.mark.xdist_group("collectives"))


_TESTS_RUN = [0]


@_pytest.fixture(autouse=True)
def _periodic_jax_cache_clear():
    """Bound per-process accumulated XLA state (r5 stability fix).

    Running the full combined suite (~240 tests) in one long-lived
    worker on this jaxlib's XLA:CPU eventually hard-crashes: a
    rendezvous abort in a late collective test (4/4 reproductions,
    fixed by subprocess isolation) and then a SEGFAULT inside a plain
    single-device associative scan at ~85% of the combined run — both
    only ever late in a long process, never in isolation. Clearing
    jax's in-memory executable caches every 40 tests bounds the
    accumulation; the persistent disk cache keeps the recompiles cheap.
    """
    yield
    _TESTS_RUN[0] += 1
    if _TESTS_RUN[0] % 40 == 0:
        jax.clear_caches()


@_pytest.fixture
def gpu():
    """The GPU, for tests marked `gpu`; skips where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _pytest.skip(f"needs a GPU (JAX found {dev.platform}); run on the "
                     "card: python -m pytest -o addopts=\"\" -m gpu tests/")
    return dev


@_pytest.fixture(autouse=True)
def _no_compile_cache_for_collective_tests(request):
    mod = getattr(request, "module", None)
    name = getattr(mod, "__name__", "")
    if name in _COLLECTIVE_TEST_MODULES:
        prev = jax.config.jax_enable_compilation_cache
        jax.config.update("jax_enable_compilation_cache", False)
        yield
        jax.config.update("jax_enable_compilation_cache", prev)
    else:
        yield

if not _CARD_RUN:
    assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
    assert jax.device_count() >= 8, "tests expect an 8-device virtual CPU platform"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
