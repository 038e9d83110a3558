"""The batched-m generate paths must reproduce the per-m products."""

import h5py
import numpy as np
import pytest

from driftscan_tpu.core import beamtransfer, kltransform
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


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two identical product runs: per-m and batched."""
    runs = {}
    for mode in ["per_m", "batched"]:
        tel = cylinder.UnpolarisedCylinderTelescope.from_config(PARAMS)
        d = tmp_path_factory.mktemp(f"bg_{mode}")
        bt = beamtransfer.BeamTransfer(str(d), telescope=tel)
        if mode == "per_m":
            bt.svd_mbatch = 1
        bt.generate()
        kl = kltransform.KLTransform.from_config(
            {"subset": False}, bt, subdir="kl"
        )
        if mode == "per_m":
            kl.mbatch = 1
        kl.generate()
        runs[mode] = (bt, kl)
    return runs


def test_svd_files_match(pair):
    bt_p, _ = pair["per_m"]
    bt_b, _ = pair["batched"]
    tel = bt_p.telescope

    for mi in range(tel.mmax + 1):
        np.testing.assert_allclose(
            bt_b.beam_singularvalues(mi),
            bt_p.beam_singularvalues(mi),
            rtol=1e-9,
            atol=1e-12,
        )
        # The SVD bases are unique up to phases; compare the projector
        # B^H B (gauge invariant).
        for fi in range(tel.nfreq):
            bp = bt_p.beam_svd(mi)[fi].reshape(bt_p.svd_len, -1)
            bb = bt_b.beam_svd(mi)[fi].reshape(bt_b.svd_len, -1)
            np.testing.assert_allclose(
                bb.conj().T @ bb, bp.conj().T @ bp, atol=1e-8
            )


def test_kl_spectra_match(pair):
    bt_p, kl_p = pair["per_m"]
    bt_b, kl_b = pair["batched"]
    tel = bt_p.telescope

    for mi in range(tel.mmax + 1):
        ep = kl_p.evals_m(mi)
        eb = kl_b.evals_m(mi)
        if ep is None:
            assert eb is None or eb.size == 0
            continue
        assert eb.size == ep.size
        np.testing.assert_allclose(eb, ep, rtol=1e-6, atol=1e-9)


def test_kl_evecs_diagonalise(pair):
    """Batched eigenvectors must diagonalise the same covariances."""
    import driftscan_tpu.backend as backend

    bt, kl = pair["batched"]
    mi = 1
    evals, evecs = kl.modes_m(mi)
    nside = bt.ndof(mi)
    S, N = kl.sn_covariance(mi)
    # split mode computes at f32 device precision: the
    # N-orthonormality floor is then ~1e-2; native f64 is ~1e-7
    tol = 1e-2 if backend.split_complex() else 1e-7
    np.testing.assert_allclose(
        evecs @ N @ evecs.conj().T, np.eye(nside), atol=tol
    )
    np.testing.assert_allclose(
        evecs @ S @ evecs.conj().T,
        np.diag(evals),
        atol=max(np.abs(evals).max(), 1.0) * 1e-6,
    )


def test_psexact_batched_band_projection(tmp_path):
    """The one-shot all-band projection must equal the per-band sandwich
    (makeproj) on the standard SVD layout."""
    import yaml

    from driftscan_tpu.core import manager

    conf = yaml.safe_load(
        f"""
config:
    beamtransfers:  Yes
    kltransform:    Yes
    psfisher:       No
    output_directory: "{tmp_path}/prod"

telescope:
    type:           UnpolarisedCylinder
    num_freq:       2
    freq_start:     100.0
    freq_end:       110.0
    freq_mode:      edge
    num_cylinders:  2
    cylinder_width: 2.0
    num_feeds:      2
    feed_spacing:   1.5

kltransform:
    -   type:       KLTransform
        name:       kl
        subset:     No

psfisher:
    -   type:       Full
        klname:     kl
        name:       psx
        bandtype:   polar
"""
    )
    m = manager.ProductManager()
    m.apply_config(conf)
    m.generate()

    from driftscan_tpu.core import psestimation

    ps = psestimation.PSExact.from_config(
        dict(bandtype="polar"), m.kltransforms["kl"], subdir="psx"
    )
    ps.genbands()

    for mi in (0, 2):
        if ps.num_evals(mi) == 0:
            continue
        assert ps._batchable_proj()
        g = ps._sky_modes_t(mi)
        from driftscan_tpu.ops import projections as pk

        import driftscan_tpu.backend as backend

        fast = pk.band_covariance_projection(g, ps.clarray)
        # split mode computes at f32 device precision
        rtol, atol = (1e-3, 1e-5) if backend.split_complex() else (1e-8, 1e-10)
        for bi in range(ps.nbands):
            slow = ps.makeproj(mi, bi)
            scale = np.abs(slow).max() + 1e-300
            np.testing.assert_allclose(
                fast[bi], slow, rtol=rtol, atol=atol * scale
            )
