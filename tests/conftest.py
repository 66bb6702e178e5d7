"""Test harness config: force the CPU platform with a virtual 8-device mesh so
multi-device sharding paths are testable without accelerators (SURVEY.md §4).

The platform is switched via jax.config as well as the environment, which
also works when jax was imported before this file runs; XLA_FLAGS is set
before the CPU backend first initializes.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    A full-suite run compiles several hundred XLA:CPU programs in one
    process; past ~85% of the suite the accumulated JIT code memory
    deterministically crashes the NEXT big compile inside
    backend_compile_and_load (SIGSEGV/SIGABRT with no Python error —
    reproduced at the same test across runs, not reproducible for any
    subset). Dropping the executable caches at module boundaries keeps the
    in-process code footprint bounded; shared graphs recompile on first
    use in a later module, which costs ~10-20% suite wall time.
    """
    yield
    jax.clear_caches()
