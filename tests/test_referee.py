"""The f32 product engine against the shared dense complex128 referee.

Tiny-width versions of the on-card check in ``chip_smoke.py``: the
windowed resident spectrum pass (``resident._spectrum_batch`` with
``m_lo`` addressing) must match the dense generalised eigensolve built
from the product step's own SVD-basis beams (tests/_referee.py) on the
eigenvalues within three decades of the top, at the engine's f32 tier;
and the fused Fisher kernel must match the dense quadratic estimator.
"""

import numpy as np
import pytest

import _referee


def _tel(npol):
    from driftscan_tpu.telescope import cylinder

    cls = (
        cylinder.PolarisedCylinderTelescope
        if npol == 4
        else cylinder.UnpolarisedCylinderTelescope
    )
    return cls.from_config(dict(
        num_freq=4, freq_start=400.0, freq_end=800.0, freq_mode="edge",
        num_cylinders=2, cylinder_width=3.0, num_feeds=1,
        feed_spacing=6.0, tsys=50.0, single_precision=True,
    ))


@pytest.mark.parametrize("npol, M", [(1, 12), (4, 10)])
def test_spectrum_batch_matches_dense_referee(npol, M):
    import jax.numpy as jnp

    import bench
    from driftscan_tpu.parallel import mstep, resident

    tel = _tel(npol)
    assert tel.num_pol_sky == npol
    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    nl, F = tel.lmax + 1, tel.nfreq

    pos, neg = resident.btm_resident(tel, blg, fig, m_range=(M, M + 1))
    nw = jnp.asarray(np.asarray(noisew), pos.re.dtype)
    mv = jnp.asarray(np.array([M], np.int32))
    ev, _, _ = resident._spectrum_batch(
        pos.re, pos.im, neg.re, neg.im, nw, ls, lf, mv,
        npairs=tel.npairs, nfreq=F, nl=nl, npol=npol, sig_levels=2,
        m_lo=np.int32(M),
    )

    # the step's SVD-basis beams for the same m
    b_re, b_im = resident._build_beam_batch(
        pos.re, pos.im, neg.re, neg.im, mv, tel.npairs, F, npol, nl,
        m_lo=np.int32(M),
    )
    res = mstep.kl_product_step_split(b_re, b_im, nw, ls, lf, mv, npol=npol, nl=nl)
    w = _referee.dense_spectrum(_referee.beams_of(res, 0, npol, nl), cl_s, cl_n)

    k, err = _referee.top_spectrum_error(np.asarray(ev)[0], w, 1e-3 * w[-1])
    assert k >= 2
    assert err <= 2e-3


def test_fisher_kernel_matches_dense_estimator():
    """fisher_step_split == the dense quadratic estimator (f64 planes)."""
    from driftscan_tpu.parallel import mstep

    rng = np.random.default_rng(8)
    M, F, T, npol, nl = 2, 2, 6, 4, 6
    beam = rng.standard_normal((M, F, T, npol * nl)) + 1j * rng.standard_normal(
        (M, F, T, npol * nl)
    )
    # low-rank polarised response, so the polarisation filter keeps modes
    pu = rng.standard_normal((M, F, T, 1)) + 1j * rng.standard_normal((M, F, T, 1))
    pv = rng.standard_normal((M, F, 1, (npol - 1) * nl))
    beam[..., nl:] = np.einsum("mftr,mfrl->mftl", pu, pv)
    noisew = np.ones((F, T))

    def rand_cl(scale, k):
        a = rng.standard_normal((nl, F, k)) * scale
        return np.einsum("lfk,lgk->lfg", a, a)

    cl_s = np.zeros((npol, npol, nl, F, F))
    cl_f = np.zeros((npol, npol, nl, F, F))
    cl_s[0, 0] = rand_cl(3.0, 2)
    cl_f[0, 0] = rand_cl(0.3, 1)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_f, out_dtype=np.float64)
    mv = np.array([1, 2], np.int32)
    res = mstep.kl_product_step_split(
        np.ascontiguousarray(beam.real), np.ascontiguousarray(beam.imag),
        noisew, ls, lf, mv, npol=npol, nl=nl,
    )
    clbands = [rand_cl(0.5, 2), rand_cl(0.2, 1)]
    band_lt = mstep.band_factor_table(clbands, out_dtype=np.float64, l_chunk=3)
    thr = 0.05
    f_re, f_im = mstep.fisher_step_split(
        res.evals, res.evecs_re, res.evecs_im, res.beam_re, res.beam_im,
        band_lt, ps_threshold=thr, fisher_k=F * T, npol=npol, nl=nl, l_chunk=3,
    )
    got = np.asarray(f_re) + 1j * np.asarray(f_im)
    want = _referee.dense_fisher(res, clbands, thr, npol, nl)
    assert (np.abs(want) > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10 * np.abs(want).max())


def test_top_spectrum_error():
    w = np.array([1e-9, 0.05, 0.2, 1.0])
    e = np.array([0.0, 0.05, 0.2002, 0.999])
    k, err = _referee.top_spectrum_error(e[::-1], w, 0.1)  # order-free
    assert k == 2
    assert err == pytest.approx(1e-3)
    assert _referee.top_spectrum_error(e, w, 10.0) == (0, 0.0)


def test_dense_pencil_is_hermitian_with_identity_noise_floor():
    """Zero covariances give S = 0 and N = I; random ones a Hermitian
    pair with N >= I (the prewhitened radiometer noise)."""
    rng = np.random.default_rng(2)
    F, S_, npol, nl = 2, 3, 2, 4
    b = rng.standard_normal((F, S_, npol, nl)) + 1j * rng.standard_normal(
        (F, S_, npol, nl)
    )
    zero = np.zeros((npol, npol, nl, F, F))
    S_d, N_d = _referee.dense_pencil(b, zero, zero)
    np.testing.assert_array_equal(S_d, 0)
    np.testing.assert_array_equal(N_d, np.eye(F * S_))

    a = rng.standard_normal((npol, nl, F, 2))
    cl = np.zeros((npol, npol, nl, F, F))
    for p in range(npol):
        cl[p, p] = np.einsum("lfk,lgk->lfg", a[p], a[p])
    S_d, N_d = _referee.dense_pencil(b, cl, cl)
    # the per-g matrix products equal the direct contraction
    want = sum(
        np.einsum("fal,lfg,gbl->fagb", b[:, :, p], cl[p, q], b[:, :, q].conj())
        for p in range(npol) for q in range(npol)
    ).reshape(F * S_, F * S_)
    np.testing.assert_allclose(S_d, 0.5 * (want + want.conj().T), atol=1e-12)
    np.testing.assert_allclose(S_d, S_d.conj().T, atol=1e-12)
    np.testing.assert_allclose(N_d - np.eye(F * S_), S_d, atol=1e-12)
    assert np.linalg.eigvalsh(S_d).min() > -1e-10
