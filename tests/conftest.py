"""Test harness config: run on a virtual 8-device CPU mesh (SURVEY.md §4).

Must set the env vars BEFORE jax initializes its backends, hence at conftest
import time. ``JAX_PLATFORMS`` defaults to the CPU; the tests marked
``gpu`` run on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the live-executable population of a long suite run.

    A full suite compiles many hundreds of 8-virtual-device XLA:CPU
    programs into one process; ~30 minutes in, the NEXT large compile
    sporadically segfaults inside backend_compile_and_load (observed at
    whatever test happens to compile around the 85% mark — moving the
    suspect test to a subprocess just moved the crash to its neighbour).
    Each live executable holds thunk-runtime/thread resources; dropping
    the jit caches between modules keeps the accumulation bounded.
    Per-module, not per-test: module-scoped fixtures reuse compiled
    programs within a file, and recompiles across files are rare."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def reference_data_dir(tmp_path_factory):
    """A dataset in the reference's format and shape, made from seed 0
    (utils/dataset_gen.generate_reference_shaped): 121 frames, 1000
    landmarks, <= 115 measurements per frame. Accuracy tests compare
    against its ground truth."""
    from visual_odometry_tpu.utils import dataset_gen

    d = str(tmp_path_factory.mktemp("reference_shaped"))
    dataset_gen.generate_reference_shaped(d, seed=0)
    return d


@pytest.fixture
def gpu():
    """Skip unless a GPU is present: tests of compiled kernels run on the
    card (``python -m pytest -m gpu`` there) and skip everywhere else."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")
