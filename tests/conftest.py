"""Test configuration.

Run the suite on the CPU with `JAX_PLATFORMS=cpu`: the Pallas kernels then
run in the interpreter (`fa2_jax.utils.use_interpreter`) and the sharding
tests use 8 virtual CPU devices. Tests that need a GPU carry the `gpu`
marker (registered in pyproject.toml) and run on the card with
`pytest -m gpu` or through `python chip_smoke.py`; the fixture below skips
them elsewhere. Whether there is a GPU is decided per test, at run time,
never while a module is imported.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: run `pytest -m gpu` on the card")
