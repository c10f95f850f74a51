"""visual_odometry_tpu — a monocular visual-odometry framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
lucanunz/Visual-odometry (C++17/Eigen3): 8-point epipolar initialization,
mid-point triangulation, projective-ICP pose tracking, appearance-based data
association, landmark-map maintenance, dataset I/O and offline evaluation —
plus what the reference lacks: fully-jitted scan-over-frames pipelines, a
Pallas kernel for the frame loop, and sharded multi-device matching, bundle
adjustment and batched tracking.
"""

__version__ = "0.6.0"

import os as _os

import jax as _jax

# Precision policy: geometry estimation needs true float32 matmuls. On a
# GPU the default lets float32 matmuls run in TF32 (~10 mantissa bits),
# which breaks the epipolar and Gauss-Newton numerics (pixel coordinates
# are O(600)). Stages that tolerate reduced precision opt back in locally
# with an explicit ``precision=`` argument.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache. Where JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it itself and nothing is set here. Otherwise the cache lives at one
# fixed path inside the checkout, so every process run from it shares it.
#
# Not under forced CPU (JAX_PLATFORMS=cpu: the tests, the multi-device
# dry runs): XLA:CPU executable (de)serialization is not reliable — the
# serialized AOT result bakes in the build-time codegen target's features,
# the cache key does not include the runtime host's, and loading an entry
# whose features the host lacks SIGSEGVs inside deserialization (observed
# across long pytest runs).
_forced_cpu = _os.environ.get("JAX_PLATFORMS", "").strip().lower().startswith(
    "cpu"
)
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ and not _forced_cpu:
    _cache_dir = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )
    try:
        _os.makedirs(_cache_dir, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except OSError:  # a read-only checkout: run without the cache
        pass

from . import models, ops, parallel, utils  # noqa: F401,E402
