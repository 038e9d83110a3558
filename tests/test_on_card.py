"""Checks that need the card: the ns2 window at full widths against the
dense referee, and the four-card m-mesh against one card.

Marked ``gpu``; they skip on any other backend, deciding inside the
fixture.  The default test run pins the CPU (tests/conftest.py), so on
a card run them with ``python -m pytest tests/test_on_card.py -m gpu``,
or run the same phases as one process with ``python chip_smoke.py``
(and ``--four-cards``)."""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_devices():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; the default backend is {devices[0].platform}")
    return devices


def test_ns2_window_matches_referee(gpu_devices):
    line = chip_smoke.phase_ns2()
    assert line["retained_modes"] >= 1


def test_four_card_mesh(gpu_devices):
    if len(gpu_devices) < 4:
        pytest.skip(f"needs 4 GPUs, found {len(gpu_devices)}")
    line = chip_smoke.phase_four_cards(gpu_devices)
    assert line["evals_allclose"]
