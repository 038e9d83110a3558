"""The entry point's jittable product step, on either complex path."""

import jax
import numpy as np
import pytest


@pytest.mark.parametrize("split", ["0", "1"])
def test_entry_step_runs(monkeypatch, split):
    import __graft_entry__ as g

    monkeypatch.setenv("DRIFTSCAN_TPU_SPLIT_COMPLEX", split)
    fn, args = g.entry()
    assert len(args) == (6 if split == "1" else 5)
    out = jax.jit(fn)(*args)
    evals = np.asarray(out.evals)
    beam = args[0]
    assert evals.shape == (beam.shape[0], beam.shape[1] * min(8, beam.shape[2]))
    assert np.isfinite(evals).all()
