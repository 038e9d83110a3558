"""The device-resident BeamTransfer.generate must write identical products.

The CLI pipeline (`drift-makeproducts run` ->
BeamTransfer.generate writing beam.hdf5) must ride the same resident fast
path as the bench (parallel/resident.py), still writing byte-compatible
files (reference contract drift/core/beamtransfer.py:447-676).
"""

import numpy as np
import pytest

from driftscan_tpu.core.beamtransfer import BeamTransfer
from driftscan_tpu.telescope import cylinder


def _tel(pol=False, **kw):
    cls = (
        cylinder.PolarisedCylinderTelescope
        if pol
        else cylinder.UnpolarisedCylinderTelescope
    )
    params = dict(
        num_freq=2,
        freq_start=100.0,
        freq_end=110.0,
        freq_mode="edge",
        num_cylinders=2,
        cylinder_width=3.0,
        num_feeds=2,
        feed_spacing=1.0,
        tsys=50.0,
    )
    params.update(kw)
    return cls.from_config(params)


@pytest.mark.parametrize("pol", [False, True])
def test_resident_mfiles_match_chunked(tmp_path, pol):
    tel = _tel(pol=pol)

    bt_file = BeamTransfer(str(tmp_path / "chunked"), telescope=tel)
    bt_file.resident = "never"
    bt_file.generate(skip_svd=True)
    assert bt_file._mem_beam is None

    bt_res = BeamTransfer(str(tmp_path / "resident"), telescope=tel)
    bt_res.resident = "always"
    bt_res.generate(skip_svd=True)
    assert bt_res._mem_beam is not None

    for mi in range(0, tel.mmax + 1, max(1, tel.mmax // 5)):
        a = bt_file.beam_m(mi)
        b = bt_res.beam_m(mi)  # served from memory
        scale = np.abs(a).max()
        assert np.allclose(a, b, rtol=1e-4, atol=1e-6 * max(scale, 1e-30)), (
            f"m={mi}: resident BTM differs from chunked "
            f"(max |diff| {np.abs(a - b).max():.3e}, scale {scale:.3e})"
        )

    # The files on disk hold the same values the in-memory tables serve.
    bt_reload = BeamTransfer(str(tmp_path / "resident"), telescope=tel)
    mi = tel.mmax // 2
    np.testing.assert_array_equal(bt_reload.beam_m(mi), bt_res.beam_m(mi))


def test_resident_full_generate_svd_spectrum(tmp_path):
    """Full generate() through the resident path: SVD products agree."""
    tel = _tel()

    bt_file = BeamTransfer(str(tmp_path / "chunked"), telescope=tel)
    bt_file.resident = "never"
    bt_file.generate()

    bt_res = BeamTransfer(str(tmp_path / "resident"), telescope=tel)
    bt_res.resident = "always"
    bt_res.generate()

    for mi in (0, tel.mmax // 2, tel.mmax):
        sa = bt_file.beam_singularvalues(mi)
        sb = bt_res.beam_singularvalues(mi)
        assert np.allclose(sa, sb, rtol=1e-3, atol=1e-6 * max(sa.max(), 1e-30))

    # The SVD-product memory cache holds exactly what the files hold.
    assert bt_res._mem_svd is not None
    bt_reload = BeamTransfer(str(tmp_path / "resident"), telescope=tel)
    assert bt_reload._mem_svd is None
    mi = tel.mmax // 2
    for name in ("beam_svd", "invbeam_svd", "beam_ut"):
        np.testing.assert_array_equal(
            getattr(bt_res, name)(mi), getattr(bt_reload, name)(mi)
        )
    np.testing.assert_array_equal(
        bt_res.beam_singularvalues(mi), bt_reload.beam_singularvalues(mi)
    )


def test_use_resident_gate():
    tel = _tel()
    bt = BeamTransfer.__new__(BeamTransfer)
    bt.telescope = tel
    bt.resident = "auto"
    bt.resident_hbm_gb = 10.0
    bt.resident_host_gb = 8.0
    assert bt._use_resident()  # tiny problem fits

    bt.resident_hbm_gb = 1e-9  # nothing fits
    assert not bt._use_resident()

    bt.resident = "always"
    assert bt._use_resident()

    bt.resident = "never"
    assert not bt._use_resident()


def test_kl_device_handoff_matches_host_path(tmp_path):
    """KL fed from the device-resident beam handoff == the host upload.

    The SVD stage leaves the sky->SVD beams on device (_dev_svd); the
    batched KL assembles its pencil input from them with an on-device
    svcut mask.  Both paths must produce identical eigenfiles (the
    handoff arrays are the very ones the svd.hdf5 files came from).
    """
    from driftscan_tpu.core.kltransform import KLTransform

    tel = _tel()

    bt = BeamTransfer(str(tmp_path / "prod"), telescope=tel)
    bt.resident = "always"
    bt.generate()
    assert bt._dev_svd is not None and len(bt._dev_svd) == tel.mmax + 1

    kl_dev = KLTransform(bt, subdir="kl_dev")
    kl_dev.generate()

    # Same products, handoff disabled: forces _load_bsvd_batch + upload.
    bt._dev_svd = None
    kl_host = KLTransform(bt, subdir="kl_host")
    kl_host.generate()

    import h5py

    for mi in (0, tel.mmax // 2, tel.mmax):
        with h5py.File(kl_dev._evfile % mi, "r") as fd, h5py.File(
            kl_host._evfile % mi, "r"
        ) as fh:
            np.testing.assert_array_equal(fd["evals_full"][:], fh["evals_full"][:])
            np.testing.assert_array_equal(fd["evals"][:], fh["evals"][:])
            np.testing.assert_array_equal(fd["evecs"][:], fh["evecs"][:])
