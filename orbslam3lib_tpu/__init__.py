"""orbslam3lib_tpu — a JAX visual(-inertial) SLAM engine for the GPU.

Brand-new JAX/XLA implementation of the capabilities of Lynx-MR/orbslam3lib
(ORB-SLAM3 with a Hexagon-DSP front end). See SURVEY.md at the repo root for
the structural map of the reference this build follows.
"""

__version__ = "0.1.0"

# SLAM geometry (triangulation, pose/BA normal equations, Sim3 solves) is
# numerically fragile in reduced-precision matmul passes (TF32 on the GPU's
# tensor cores keeps ~10 mantissa bits): mono initialization fails outright
# at DEFAULT precision and works at HIGHEST. Exact-integer descriptor paths
# (Hamming bit dots, BoW descent) pin precision=DEFAULT locally — 0/1 bit
# counts <= 256 are exact in bf16 — so this global only upgrades the
# precision-critical math.
import os as _os

import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache, so repeated runs skip the big compiles. JAX
# reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the
# package pick the fixed <repo>/.jax_cache (the path is part of the cache
# key, so it must not move). CPU is EXCLUDED: XLA:CPU AOT cache entries
# record host machine features and reload with mismatches (observed
# "+prefer-no-scatter not supported" warnings followed by wrong numerics
# under pytest).
if _os.environ.get("ORBSLAM3_TPU_NO_COMPILE_CACHE") != "1" \
        and _os.environ.get("JAX_PLATFORMS", "") != "cpu":
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _os.path.abspath(
            _os.path.join(_os.path.dirname(__file__), _os.pardir,
                          ".jax_cache")))
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
