"""Test configuration: run everything on a virtual 8-device CPU platform so
multi-device sharding paths are exercised without an accelerator.

Tests marked `gpu` need a real GPU and are skipped unless RTGRFF_GPU_TESTS=1.
With it set, the platform is left alone (JAX picks the GPU) and only the
`gpu` tests run; whether a GPU is really there is decided by the `gpu_device`
fixture when a test asks for it, never at import. Usage on a GPU machine:

    RTGRFF_GPU_TESTS=1 python -m pytest -m gpu tests/ -q

(chip_smoke.py runs the same selection in-process.)
"""

import os

import pytest

GPU_MODE = os.environ.get("RTGRFF_GPU_TESTS", "") == "1"

if not GPU_MODE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a real GPU (run with RTGRFF_GPU_TESTS=1)")


def pytest_collection_modifyitems(config, items):
    if GPU_MODE:
        skip = pytest.mark.skip(reason="GPU mode runs only gpu tests")
        for item in items:
            if "gpu" not in item.keywords:
                item.add_marker(skip)
    else:
        skip = pytest.mark.skip(reason="needs RTGRFF_GPU_TESTS=1 and a GPU")
        for item in items:
            if "gpu" in item.keywords:
                item.add_marker(skip)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; fails (does not skip) when the run asked for
    GPU tests and JAX found none."""
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.fail(f"RTGRFF_GPU_TESTS=1 but JAX found no GPU "
                    f"(default backend {jax.default_backend()!r})")
    return devs[0]


@pytest.fixture(scope="session")
def cpu_device():
    """The host CPU device used as the reference backend for parity."""
    import jax
    try:
        return jax.devices("cpu")[0]
    except RuntimeError as e:
        pytest.fail(f"the CPU backend is absent: {e}")
