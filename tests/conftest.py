"""Test configuration: force the CPU backend with 8 virtual devices.

This mirrors how the reference tests multi-node behaviour without a
cluster (``mpirun -np 2 --oversubscribe``,
/root/reference/tests/test_functional.py:70-76): we substitute a virtual
8-device CPU mesh for real accelerators.  Must run before jax initialises.

``-m gpu`` selects the card-only checks (tests/test_on_card.py) and
leaves JAX on its default backend for them; every other run is pinned
to the CPU.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


def pytest_configure(config):
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")
