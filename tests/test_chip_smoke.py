"""chip_smoke.py: its contract off the card, and its phases at tiny widths.

The script proves the pipeline on a GPU; here (CPU backend) it must
refuse to run and print no result, and each phase's code runs on a tiny
polarised cylinder with the KL cut lowered to what such an instrument
retains (its eigenvalues sit near 1e-2, where the 0.1 production cut
keeps nothing)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(
    num_freq=8, freq_start=400.0, freq_end=450.0, freq_mode="edge",
    num_cylinders=2, cylinder_width=4.0, num_feeds=4, feed_spacing=1.0,
    tsys=50.0, single_precision=True,
)
TINY_CUT = 1e-3


def test_device_gate_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu([])


def test_ok_line_shape():
    line = json.loads(chip_smoke.ok_line(jax.devices()))
    assert line == {
        "ok": True,
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
    }


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("alone", [False, True])
def test_fails_without_a_card_or_the_repo(tmp_path, alone):
    """No GPU, or no program beside the script: non-zero exit, no ok line."""
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    else:
        script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    res = _run(cwd, script)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    if not alone:
        assert "needs a GPU" in res.stderr


def test_ns2_phase_with_referee(capsys):
    line = chip_smoke.phase_ns2(
        tel_params=TINY, window=(12, 16), nbands=3, cut=TINY_CUT
    )
    assert line["retained_modes"] >= 1
    assert line["precision_overrides"] == {
        "sht": None, "topband_filter": None, "fisher": None
    }
    phases = [json.loads(x)["phase"] for x in capsys.readouterr().out.splitlines()]
    assert phases == ["referee", "ns2"]


def test_four_card_mesh_matches_one_device(capsys):
    """The --four-cards path on four virtual CPU devices."""
    devices = jax.devices()
    assert len(devices) >= 4
    line = chip_smoke.phase_four_cards(
        devices[:4], tel_params=TINY, window=(12, 20), nbands=3, cut=TINY_CUT
    )
    assert line["evals_allclose"]
    assert line["fisher_rel_err"] <= chip_smoke.MESH_RTOL


def _good_window():
    import numpy as np

    evals = np.array([[0.0, 0.05, 0.3], [0.0, 0.2, 0.4]])
    fish = np.array([[2.0, 0.5 + 0.1j], [0.5 - 0.1j, 1.0]])
    return evals, fish


@pytest.mark.parametrize(
    "breakage, match",
    [
        (None, None),
        ("nan_eval", "non-finite KL"),
        ("nothing_retained", "no KL mode"),
        ("nan_fisher", "non-finite Fisher"),
        ("not_hermitian", "not Hermitian"),
        ("negative_diag", "diagonal not positive"),
    ],
)
def test_check_window(breakage, match):
    """The ns2 phase's output checks accept a sound window and reject
    each kind of broken one."""
    import numpy as np

    evals, fish = _good_window()
    if breakage == "nan_eval":
        evals[0, 1] = np.nan
    elif breakage == "nothing_retained":
        evals[:] = 0.01
    elif breakage == "nan_fisher":
        fish[0, 0] = np.nan
    elif breakage == "not_hermitian":
        fish[0, 1] = 0.9
    elif breakage == "negative_diag":
        fish[1, 1] = -1.0
    if match is None:
        facts = chip_smoke.check_window(evals, fish)
        assert facts["retained_modes"] == 3
        assert facts["fisher_diag"] == [2.0, 1.0]
    else:
        with pytest.raises(RuntimeError, match=match):
            chip_smoke.check_window(evals, fish)


def test_ns2_refuses_precision_overrides(monkeypatch):
    """A per-stage matmul-precision override stops the ns2 phase before
    any work: the referee tolerances assume full f32 everywhere."""
    from driftscan_tpu.parallel import mstep

    monkeypatch.setattr(mstep, "_FISHER_PRECISION", "high")
    with pytest.raises(RuntimeError, match="overrides set"):
        chip_smoke.phase_ns2(tel_params=TINY, window=(12, 16), nbands=3)
