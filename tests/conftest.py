"""Test configuration: a LOCAL 8-device CPU mesh.

Tests run on the CPU backend with virtual devices, so sharding logic is
exercised without accelerators; Pallas kernels run in interpret mode,
passed explicitly by each test. Float64 is enabled to match the
reference's Julia Float64 semantics for golden/parity tests; the GPU runs
f32 (see bench.py and chip_smoke.py).

Tests that need the card carry the ``chip`` marker and take the ``gpu``
fixture, which decides at run time (never at import) whether a GPU is
present and skips otherwise. On a machine with a card, run them with
``python -m pytest -m chip -p no:randomly tests/`` in a process where JAX
may use the GPU (the platform forcing below yields to
``ADAPROX_TEST_GPU=1``).
"""

import os

os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

if os.environ.get("ADAPROX_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compilation cache: recompiles across pytest runs are pure cache
# hits. JAX_COMPILATION_CACHE_DIR, when set, is the only cache used (JAX
# reads it itself). Otherwise CPU entries are kept in a per-host-arch dir:
# XLA:CPU caches AOT machine code keyed without the host's CPU features,
# and loading entries compiled on a different host logs "machine type ...
# doesn't match ... could lead to SIGILL".
import zlib

try:
    with open("/proc/cpuinfo") as _fh:
        _src = "".join(ln for ln in _fh if ln.startswith("flags"))[:10000]
except OSError:
    import platform

    _src = platform.processor() or "cpu"
_arch = zlib.crc32(_src.encode()) & 0xFFFFFFFF
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(__file__), "..", f".jax_cache_cpu_{_arch:08x}"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. Decided
    here, at run time, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest -m chip` on the card "
                    "(the CPU run covers the same kernels in interpret mode)")
    return jax.devices()[0]


# Every XLA:CPU executable mmaps several regions and the suite compiles
# thousands of distinct graphs; near ~480 tests the process crosses the
# kernel's vm.max_map_count (default 65530) and the NEXT compilation-cache
# load SEGFAULTS inside the AOT deserializer instead of erroring (observed
# at 65149 maps, exit 139, in tests/test_sweep_sharding.py — the victim is
# whichever test compiles next, not the culprit). Dropping live executables
# periodically keeps the map table bounded; re-requests hit the persistent
# compile cache, so the cost is small.
_CLEAR_EVERY = 80
_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _bound_live_executable_maps():
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()
