"""Polarised m-window referee: ns1's actual path against dense f64.

tests/test_window_referee.py pins the windowed product path
unpolarised; the polarised runs (npol=4) are where the triple-SVD additionally filters pure-polarisation
modes and the pol-diagonal C_l blocks ([0,0] TT+point sources,
[1,1]/[2,2] polarised synchrotron) enter the pencil.  This test:

  1. windowed == full-range `_spectrum_batch` at npol=4 (the windowed
     layout),
  2. engine evals match the shared dense complex128 referee
     (tests/_referee.py) built from the step's own SVD-basis beams with
     the pol-summed contraction (reference algorithm
     drift/core/kltransform.py:258-341).
"""

import numpy as np
import pytest

import _referee

pytestmark = pytest.mark.slow


def test_polarised_windowed_product_matches_dense():
    import jax.numpy as jnp

    import bench
    from driftscan_tpu.parallel import mstep, resident
    from driftscan_tpu.telescope import cylinder

    M = 10
    tel = cylinder.PolarisedCylinderTelescope.from_config(dict(
        num_freq=4, freq_start=400.0, freq_end=800.0, freq_mode="edge",
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
    assert npol == 4

    posf, negf = resident.btm_resident(tel, blg, fig)
    posw, negw = resident.btm_resident(tel, blg, fig, m_range=(M, M + 1))

    nw = jnp.asarray(np.asarray(noisew), posf.re.dtype)
    mv = jnp.asarray(np.array([M], np.int32))

    # 1. windowed == full-range
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

    # 2. dense complex128 referee from the step's SVD-basis beams
    beams_re, beams_im = resident._build_beam_batch(
        posf.re, posf.im, negf.re, negf.im, mv, tel.npairs, F, npol, nl
    )
    res = mstep.kl_product_step_split(
        beams_re, beams_im, nw, ls, lf, mv, npol=npol, nl=nl,
    )
    ev_engine = np.sort(np.asarray(res.evals)[0])

    w = _referee.dense_spectrum(_referee.beams_of(res, 0, npol, nl), cl_s, cl_n)

    k, err = _referee.top_spectrum_error(ev_engine, w, 1e-3 * w[-1])
    assert k >= 2
    assert err <= 2e-3
