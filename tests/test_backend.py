"""Path routing and device facts (driftscan_tpu.backend).

No probe may turn a backend that failed to start into silent CPU
semantics: the device record raises instead."""

import os

import jax
import pytest

from driftscan_tpu import backend


@pytest.mark.parametrize(
    "value, want",
    [
        (None, False),
        ("", False),
        ("0", False),
        ("false", False),
        ("False", False),
        ("1", True),
        ("true", True),
    ],
)
def test_split_complex_switch(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("DRIFTSCAN_TPU_SPLIT_COMPLEX", raising=False)
    else:
        monkeypatch.setenv("DRIFTSCAN_TPU_SPLIT_COMPLEX", value)
    assert backend.split_complex() is want


def test_device_record_names_the_device():
    rec = backend.device_record()
    dev = jax.devices()[0]
    assert rec == {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def test_device_record_raises_when_backend_fails(monkeypatch):
    class Unavailable(RuntimeError):
        pass

    def boom(*args, **kwargs):
        raise Unavailable("UNAVAILABLE: backend failed to start")

    monkeypatch.setattr(jax, "devices", boom)
    with pytest.raises(Unavailable):
        backend.device_record()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    seen = {}
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: seen.__setitem__(name, value)
    )
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert backend.use_compile_cache() == str(tmp_path)
        assert seen == {}  # JAX reads the variable itself; nothing else is set
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(backend.REPO_ROOT, ".jax_cache")
        assert backend.use_compile_cache() == want
        assert seen == {"jax_compilation_cache_dir": want}
        assert os.path.isfile(os.path.join(backend.REPO_ROOT, "chip_smoke.py"))
