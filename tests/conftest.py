"""Test harness: force JAX onto 8 virtual CPU devices so multi-device
sharding paths compile and execute without a GPU (tests that need the card
carry the `gpu` marker and skip here)."""

import os

# Must happen before any jax *use*: tests run hermetically on an 8-device
# virtual CPU mesh. Only an explicit JAX_PLATFORMS=cuda (the `gpu`-marked
# tests, run on the card) keeps the GPU.
if os.environ.get("JAX_PLATFORMS") != "cuda":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped: every test draws the same deterministic sequence
    # regardless of collection order
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)")
    return devices[0]
