"""Batched KL writer must survive a degenerate padded/genuine zero cluster.

The factored pencil's zero eigenvalue is degenerate between the
svcut/ragged padding directions and genuine zero-signal modes, so eigh
may return an arbitrarily mixed basis for that cluster (observed at
mid scale, where split-complex f32 widens the cluster).  With a
positive subset threshold the batched writer must classify only the
above-threshold columns — never falling back to the per-m path, which
costs a recompile per m on the device — and still report a correct
full-spectrum diagnostic.

Reference contract: subset/threshold semantics of
/root/reference/drift/core/kltransform.py:357-477 (evals_full +
above-threshold evals/evecs per m file).
"""

import h5py
import numpy as np
import pytest

from driftscan_tpu.core import manager

CONFIG = """
config:
    beamtransfers:      Yes
    kltransform:        Yes
    psfisher:           No
    output_directory:   "{outdir}"
    truncate:           false

telescope:
    type:               UnpolarisedCylinder
    num_freq:           3
    freq_start:         100.0
    freq_end:           110.0
    freq_mode:          edge
    num_cylinders:      2
    cylinder_width:     2.0
    num_feeds:          2
    feed_spacing:       1.5
    tsys:               40.0

kltransform:
    -   type:           KLTransform
        name:           kl
"""


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    base = tmp_path_factory.mktemp("kl_ambig")
    cfile = str(base / "params.yaml")
    with open(cfile, "w") as f:
        f.write(CONFIG.format(outdir=f"{base}/testdir"))
    m = manager.ProductManager.from_config(cfile)
    m.generate()
    return m


def _read_ev(kl, mi):
    with h5py.File(kl._evfile % mi, "r") as f:
        return f["evals_full"][:], f["evals"][:], f["evecs"][:]


def _as_lazy(w, v):
    """Wrap mutated (w, v) numpy results in the writer's lazy handle."""
    from driftscan_tpu.ops import projections

    return projections.KLSolveLazy(
        len(w),
        np.asarray(w),
        projections.LazyComplex(
            "split",
            np.ascontiguousarray(np.asarray(v).real),
            np.ascontiguousarray(np.asarray(v).imag),
        ),
    )


def test_mixed_zero_cluster_classified_without_fallback(products, monkeypatch):
    from driftscan_tpu.core import kltransform as klmod

    kl = products.kltransforms["kl"]
    assert kl.subset and kl.threshold > 0

    nm = products.telescope.mmax + 1
    chunk = list(range(min(kl.mbatch, nm)))
    ref = {mi: _read_ev(kl, mi) for mi in chunk}

    real = klmod.projections.kl_factored_batched
    mixed_ms = []

    def mixing(*args, **kwargs):
        kwargs = dict(kwargs, lazy=False)
        w, v = real(*args, **kwargs)
        w = np.asarray(w)
        v = np.asarray(v)
        for i in range(w.shape[0]):
            # Rotate one padded-like column (support off the compact
            # axes) into one genuine-like sub-threshold column by 45
            # degrees: both then fail the 0.5 support-fraction test, so
            # keep.sum() != ndof and the ambiguity branch must engage.
            lo = np.flatnonzero(w[i] < kl.threshold)
            if lo.size < 2:
                continue
            frac = (np.abs(v[i][:, lo]) ** 2).sum(axis=0)
            # padded axes are the complement of the compact index set;
            # use column support norms to split the cluster
            idx = products.beamtransfer._compact_indices(chunk[i])[0]
            comp = (np.abs(v[i][idx][:, lo]) ** 2).sum(axis=0) / (
                frac + 1e-300
            )
            pads = lo[comp < 0.5]
            gens = lo[comp >= 0.5]
            if pads.size == 0 or gens.size == 0:
                continue
            a, b = pads[0], gens[0]
            ca = v[i][:, a].copy()
            cb = v[i][:, b].copy()
            r = 1.0 / np.sqrt(2.0)
            v[i][:, a] = r * (ca + cb)
            v[i][:, b] = r * (ca - cb)
            mixed_ms.append(chunk[i])
        return _as_lazy(w, v)

    monkeypatch.setattr(klmod.projections, "kl_factored_batched", mixing)

    def no_fallback(self, mi):
        raise AssertionError(f"per-m fallback engaged for m={mi}")

    monkeypatch.setattr(type(kl), "transform_save", no_fallback)

    kl._transform_save_mbatch(chunk)

    assert mixed_ms, "test fixture produced no mixable zero cluster"

    for mi in chunk:
        evf_ref, ev_ref, evec_ref = ref[mi]
        evf, ev, evec = _read_ev(kl, mi)
        # above-threshold output identical to the unmixed run
        np.testing.assert_allclose(ev, ev_ref, rtol=1e-10, atol=0)
        np.testing.assert_allclose(np.abs(evec), np.abs(evec_ref), atol=1e-9)
        # full-spectrum diagnostic agrees (zero cluster to within noise)
        scale = max(evf_ref.max(), 1.0)
        np.testing.assert_allclose(evf, evf_ref, atol=1e-8 * scale)


def test_mixed_above_threshold_column_still_falls_back(products, monkeypatch):
    """A mixed *above*-threshold column is a real anomaly: per-m path."""
    from driftscan_tpu.core import kltransform as klmod

    kl = products.kltransforms["kl"]
    chunk = list(range(min(kl.mbatch, products.telescope.mmax + 1)))

    # the tiny fixture has no genuine mode above the default 0.1 cut;
    # lower it so some above-threshold column exists to poison
    monkeypatch.setattr(kl, "threshold", 1e-8)

    real = klmod.projections.kl_factored_batched

    poisoned = []

    def poison(*args, **kwargs):
        kwargs = dict(kwargs, lazy=False)
        w, v = real(*args, **kwargs)
        w = np.asarray(w)
        v = np.asarray(v)
        for i, mi in enumerate(chunk):
            hi = np.flatnonzero(w[i] > kl.threshold)
            idx = products.beamtransfer._compact_indices(mi)[0]
            pad = np.setdiff1d(np.arange(v.shape[1]), idx)
            if hi.size == 0 or pad.size == 0:
                continue
            col = v[i][:, hi[0]].copy()
            col[:] = 0.0
            col[pad[0]] = 1.0
            v[i][:, hi[0]] = col  # fully padded support above threshold
            poisoned.append(mi)
            break
        assert poisoned, "fixture has no m with modes above threshold + padding"
        return _as_lazy(w, v)

    monkeypatch.setattr(klmod.projections, "kl_factored_batched", poison)

    fell_back = []
    monkeypatch.setattr(
        type(kl), "transform_save", lambda self, mi: fell_back.append(mi)
    )

    kl._transform_save_mbatch(chunk)
    assert poisoned and poisoned[0] in fell_back
