"""m-window path referee: windowed == full-range == dense complex128.

Production-scale runs stream the BTM as m-windows
(resident.btm_resident ``m_range`` + product ``m_lo`` addressing).
This test pins all three representations against each other at a
wide-fractional-bandwidth (400-800 MHz) feed-sparse cylinder:

  1. the windowed table column IS the full-range column (bit-exact),
  2. the windowed product step (m_lo addressing) matches the
     full-range step (legacy addressing) on the same m,
  3. both match a dense complex128 generalised eigensolve built from
     the raw noise-weighted beams with the negative-m block included
     (the reference algorithm,
     /root/reference/drift/core/kltransform.py:258-341).

Note the negative-m block matters: zeroing it (e.g. building beams
with the table-local index through the legacy builder, which reads
m=0 -> no negative block) collapses the pencil and yields top
eigenvalues ~6 orders low — the flawed-probe failure mode.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow


def test_windowed_product_matches_full_and_dense():
    import jax.numpy as jnp
    import scipy.linalg as sla

    import bench
    from driftscan_tpu.parallel import mstep, resident
    from driftscan_tpu.telescope import cylinder

    M = 12
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(dict(
        num_freq=8, freq_start=400.0, freq_end=800.0, freq_mode="edge",
        num_cylinders=2, cylinder_width=3.0, num_feeds=1,
        feed_spacing=6.0, tsys=50.0, single_precision=True,
    ))
    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    nl = tel.lmax + 1
    npol = tel.num_pol_sky
    F = tel.nfreq

    posf, negf = resident.btm_resident(tel, blg, fig)
    posw, negw = resident.btm_resident(tel, blg, fig, m_range=(M, M + 1))

    # 1. table equivalence (windowed col 0 <-> full col M; legacy neg
    # col j <-> m = j+1)
    np.testing.assert_array_equal(
        np.asarray(posw.re[..., 0]), np.asarray(posf.re[..., M])
    )
    np.testing.assert_array_equal(
        np.asarray(posw.im[..., 0]), np.asarray(posf.im[..., M])
    )
    np.testing.assert_array_equal(
        np.asarray(negw.re[..., 0]), np.asarray(negf.re[..., M - 1])
    )
    np.testing.assert_array_equal(
        np.asarray(negw.im[..., 0]), np.asarray(negf.im[..., M - 1])
    )

    # 2. step equivalence
    nw = jnp.asarray(np.asarray(noisew), posf.re.dtype)
    mv = jnp.asarray(np.array([M], np.int32))
    evA, _, _ = resident._spectrum_batch(
        posf.re, posf.im, negf.re, negf.im, nw, ls, lf, mv,
        npairs=tel.npairs, nfreq=F, nl=nl, npol=npol, sig_levels=2,
    )
    evB, _, _ = resident._spectrum_batch(
        posw.re, posw.im, negw.re, negw.im, nw, ls, lf, mv,
        npairs=tel.npairs, nfreq=F, nl=nl, npol=npol, sig_levels=2,
        m_lo=np.int32(M),
    )
    evA = np.sort(np.asarray(evA)[0])
    evB = np.sort(np.asarray(evB)[0])
    np.testing.assert_allclose(evB, evA, rtol=1e-6, atol=1e-12)

    # 3. dense complex128 referee from raw noise-weighted beams
    beams_re, beams_im = resident._build_beam_batch(
        posf.re, posf.im, negf.re, negf.im, mv, tel.npairs, F, npol, nl
    )
    bs = (np.asarray(beams_re) + 1j * np.asarray(beams_im))[0]
    bs = bs * np.asarray(noisew)[:, :, None]
    bs = bs.reshape(F, -1, npol, nl)
    n = F * bs.shape[1]
    csl = np.asarray(cl_s, np.float64).reshape(nl, F, F)
    cnl = np.asarray(cl_n, np.float64).reshape(nl, F, F)
    b = bs[:, :, 0, :].astype(np.complex128)
    S_d = np.einsum("fal,lfg,gbl->fagb", b, csl, b.conj(), optimize=True)
    N_d = np.einsum("fal,lfg,gbl->fagb", b, cnl, b.conj(), optimize=True)
    S_d = S_d.reshape(n, n)
    N_d = N_d.reshape(n, n) + np.eye(n)
    S_d = 0.5 * (S_d + S_d.conj().T)
    N_d = 0.5 * (N_d + N_d.conj().T)
    w = np.sort(sla.eigh(S_d, N_d, eigvals_only=True))

    # top of the spectrum: the band a retention decision can see
    top = w[-1]
    sel = w > 1e-3 * top
    k = int(sel.sum())
    assert k >= 2
    np.testing.assert_allclose(evA[-k:], w[-k:], rtol=2e-3)
