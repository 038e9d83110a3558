"""BeamTransferTempSVD / BeamTransferFullSVD: device-batched SVD variants.

Parity targets: /root/reference/drift/core/beamtransfer.py:1458-1733.
"""

import numpy as np
import pytest

from driftscan_tpu.core import beamtransfer
from driftscan_tpu.ops import projections
from driftscan_tpu.telescope import cylinder


PARAMS = dict(
    num_freq=2,
    freq_start=100.0,
    freq_end=110.0,
    freq_mode="edge",
    num_cylinders=2,
    cylinder_width=2.0,
    num_feeds=2,
    feed_spacing=1.5,
    tsys=50.0,
)


@pytest.fixture(scope="module", params=["temp", "full"])
def bt_variant(request, tmp_path_factory):
    cls = {
        "temp": beamtransfer.BeamTransferTempSVD,
        "full": beamtransfer.BeamTransferFullSVD,
    }[request.param]
    tel = cylinder.PolarisedCylinderTelescope.from_config(PARAMS)
    d = tmp_path_factory.mktemp(f"btdir_{request.param}")
    bt = cls(str(d), telescope=tel)
    bt.generate()
    return request.param, bt


def test_variant_products_finite(bt_variant):
    kind, bt = bt_variant
    for mi in range(bt.telescope.mmax + 1):
        sig = bt.beam_singularvalues(mi)
        assert np.isfinite(sig).all()
        assert (sig >= 0).all()
        assert sig.shape == (bt.nfreq, bt.svd_len)


def test_variant_sig_matches_lapack(bt_variant):
    """Device-batched spectra == host LAPACK svd of the same weighted beam."""
    kind, bt = bt_variant
    tel = bt.telescope
    mi = 1
    nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1
    bfm = bt.beam_m(mi).reshape(nfreq, bt.ntel, npol, nl)
    noisew = np.stack([bt._noise_weights(fi) for fi in range(nfreq)])
    bfm_w = bfm * noisew[:, :, None, None]

    if kind == "temp":
        mat = bfm_w[:, :, 0, :]
    else:
        mat = bfm_w.reshape(nfreq, bt.ntel, npol * nl)
    ref_sig = np.linalg.svd(mat, compute_uv=False)[:, : bt.svd_len]

    got = bt.beam_singularvalues(mi)
    scale = max(ref_sig.max(), 1e-30)
    np.testing.assert_allclose(got, ref_sig, rtol=1e-6, atol=1e-8 * scale)


def test_variant_ut_unitary_rows(bt_variant):
    """The stored ut rows (de-weighted) are orthonormal."""
    kind, bt = bt_variant
    tel = bt.telescope
    mi = 1
    noisew = np.stack(
        [bt._noise_weights(fi) for fi in range(tel.nfreq)]
    )
    ut = bt.beam_ut(mi) / noisew[:, None, :]
    g = np.einsum("fst,fzt->fsz", ut, ut.conj())
    eye = np.broadcast_to(np.eye(bt.svd_len), g.shape)
    np.testing.assert_allclose(g, eye, atol=1e-8)


def test_simple_svd_split_path(monkeypatch):
    """Forced split-complex simple_svd == the native path (f64 planes)."""
    from driftscan_tpu import backend

    rng = np.random.default_rng(3)
    m = rng.standard_normal((3, 8, 12)) + 1j * rng.standard_normal((3, 8, 12))
    ut_n, s_n = projections.simple_svd(m)

    monkeypatch.setattr(backend, "split_complex", lambda: True)
    ut_s, s_s = projections.simple_svd(m)

    np.testing.assert_allclose(s_s, s_n, rtol=1e-8, atol=1e-10)
    # U is unique only up to phase: compare projectors
    pn = np.einsum("bst,bzt->bsz", ut_n.conj(), ut_n)
    ps = np.einsum("bst,bzt->bsz", ut_s.conj(), ut_s)
    np.testing.assert_allclose(ps, pn, atol=1e-7)
