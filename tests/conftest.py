"""Test configuration.

Runs JAX on the CPU backend with 8 virtual devices so multi-device
sharding tests run anywhere (SURVEY.md §4 "multi-chip tests runnable on
CPU via fake-device meshes"). Both settings are read when JAX first
starts a backend, so they are set before anything imports jax.

Tests that need the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when no GPU is present; run
them on the card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m
gpu``.
"""
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures():
    return FIXTURES


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none. Decided
    here, at run time, never while test modules are imported."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with -m gpu on the card)")
    return devs[0]


def fixture_bytes(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()
