"""Hermetic test setup.

Mirrors the reference's TESTING-shim philosophy (reference tests.py:8-9:
set env *before importing the app*): here the env flags force an
8-virtual-device CPU backend so mesh sharding and collectives run for
real without TPUs, and TESTING swaps heavy compute for deterministic
stand-ins while the control plane stays live.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # the session env pins a TPU platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # 8 virtual devices time-slice ONE core here: a >5 s per-device
    # program between two collectives makes the slowest participant miss
    # XLA:CPU's default 40 s rendezvous deadline, which KILLS the process
    # ("Termination timeout ... Exiting to ensure a consistent program
    # state" — observed on the 64k sharded-IVF k-means).  Raise it; real
    # meshes run participants in parallel and never get near it.
    flags = (
        flags + " --xla_cpu_collective_call_terminate_timeout_seconds=900"
    ).strip()
os.environ["XLA_FLAGS"] = flags
os.environ["TESTING"] = "True"
os.environ.setdefault("DATABASE_URL", ":memory:")

# pytest's own startup imports jax before this file runs, so the env vars
# above are too late for jax's config module — override post-import too.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture()
def rng():
    import numpy as np

    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)"
    )
