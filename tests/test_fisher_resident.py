"""The fused device-resident Fisher step.

Validates :func:`mstep.fisher_step_split` (the quadratic-estimator
Fisher computed inside the product-step program, with factored band
covariances) two independent ways:

* first principles — a dense complex128 host recomputation from the
  product step's own KL modes (the reference's formula at
  /root/reference/drift/core/psestimation.py:775-815);
* end to end — ``product_all_resident(band_lt=...)`` against the
  file-based ``PSExact`` Fisher on the same telescope, covariances and
  retention threshold.
"""

import numpy as np
import pytest

import _referee
from driftscan_tpu.core import manager
from driftscan_tpu.parallel import mstep, resident

# Bench-scale suite: excluded from the default fast tier (see pyproject.toml)
pytestmark = pytest.mark.slow



# ---------------------------------------------------------------------
# first principles
# ---------------------------------------------------------------------


def test_fisher_step_first_principles():
    """Kernel == dense host recomputation on random polarised beams."""
    rng = np.random.default_rng(5)
    M, F, T, npol, nl, nbands = 3, 2, 6, 2, 8, 3
    beam = rng.standard_normal((M, F, T, npol * nl)) + 1j * rng.standard_normal(
        (M, F, T, npol * nl)
    )
    # rank-2 polarised response: the triple SVD's polarisation filter
    # projects out exactly two directions and keeps the rest (a fully
    # random pol block is full rank and would correctly reject everything)
    pu = rng.standard_normal((M, F, T, 2)) + 1j * rng.standard_normal((M, F, T, 2))
    pv = rng.standard_normal((M, F, 2, nl)) + 1j * rng.standard_normal((M, F, 2, nl))
    beam[..., nl:] = np.einsum("mftr,mfrl->mftl", pu, pv)
    noisew = np.abs(rng.standard_normal((F, T))) + 0.5

    def rand_cl(scale, k):
        a = rng.standard_normal((nl, F, k)) * scale
        return np.einsum("lfk,lgk->lfg", a, a)

    def polblock(scale_t, scale_p, k):
        cl = np.zeros((npol, npol, nl, F, F))
        cl[0, 0] = rand_cl(scale_t, k)
        cl[1, 1] = rand_cl(scale_p, k)
        return cl

    cl_s = polblock(3.0, 1.0, 3)
    cl_f = polblock(0.5, 0.2, 2)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_f, out_dtype=np.float64)

    mv = np.array([0, 2, -1], np.int32)  # padded slot exercises the contract
    res = mstep.kl_product_step_split(
        np.ascontiguousarray(beam.real),
        np.ascontiguousarray(beam.imag),
        noisew,
        ls,
        lf,
        mv,
        npol=npol,
        nl=nl,
    )

    clbands = [rand_cl(0.7, 2), rand_cl(0.4, 3), rand_cl(0.2, 1)]
    band_lt = mstep.band_factor_table(clbands, out_dtype=np.float64, l_chunk=4)
    thr = 0.05

    f_re, f_im = mstep.fisher_step_split(
        res.evals,
        res.evecs_re,
        res.evecs_im,
        res.beam_re,
        res.beam_im,
        band_lt,
        ps_threshold=thr,
        fisher_k=F * T,  # full slice: every retained mode covered
        npol=npol,
        nl=nl,
        l_chunk=4,
    )
    got = np.asarray(f_re) + 1j * np.asarray(f_im)

    want = _referee.dense_fisher(res, clbands, thr, npol, nl)
    assert (np.abs(want[0]) > 0).any()  # the test actually retains modes
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10 * scale)
    # padded m slot contributes exact zeros
    np.testing.assert_array_equal(got[2], 0)


def test_fisher_step_mode_slice():
    """A fisher_k covering the retained set reproduces the full slice."""
    rng = np.random.default_rng(11)
    M, F, T, npol, nl = 2, 2, 5, 1, 6
    beam = rng.standard_normal((M, F, T, nl)) + 1j * rng.standard_normal(
        (M, F, T, nl)
    )
    noisew = np.ones((F, T))
    a = rng.standard_normal((nl, F, 2))
    cl_s = np.einsum("lfk,lgk->lfg", a, a)[None, None] * 5.0
    cl_f = np.eye(F)[None, None, None] * np.ones((nl, 1, 1)) * 1e-3
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_f, out_dtype=np.float64)
    mv = np.array([1, 3], np.int32)
    res = mstep.kl_product_step_split(
        np.ascontiguousarray(beam.real),
        np.ascontiguousarray(beam.imag),
        noisew,
        ls,
        lf,
        mv,
        npol=npol,
        nl=nl,
    )
    thr = 1.0
    retained = int((np.asarray(res.evals) > thr).sum(axis=1).max())
    assert retained >= 1
    band_lt = mstep.band_factor_table([cl_s[0, 0]], out_dtype=np.float64)
    args = (res.evals, res.evecs_re, res.evecs_im, res.beam_re, res.beam_im,
            band_lt)
    full = mstep.fisher_step_split(
        *args, ps_threshold=thr, fisher_k=F * T, npol=npol, nl=nl
    )
    part = mstep.fisher_step_split(
        *args, ps_threshold=thr, fisher_k=retained, npol=npol, nl=nl
    )
    np.testing.assert_allclose(
        np.asarray(part[0]), np.asarray(full[0]), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(part[1]), np.asarray(full[1]), rtol=1e-10, atol=1e-12
    )


def test_fisher_step_compacted_frequencies():
    """The bucketed dispatcher's f_idx band-table gather is exact.

    Emulates a compacted chunk: the full problem has 3 frequencies but
    the chunk's active set is {0, 2} with one duplicated padding slot
    whose beams are zeroed (the dispatcher's fmask) — the Fisher must
    equal the same computation with the band table pre-gathered on the
    host and no padding slot.
    """
    rng = np.random.default_rng(3)
    M, Ff, T, npol, nl = 2, 3, 5, 1, 6
    act = np.array([0, 2])
    beam_c = rng.standard_normal((M, 3, T, nl)) + 1j * rng.standard_normal(
        (M, 3, T, nl)
    )
    beam_c[:, 1] = 0.0  # slot 1 is the zeroed padding duplicate
    noisew = np.ones((3, T))
    a = rng.standard_normal((nl, 3, 2))
    cl_s = np.einsum("lfk,lgk->lfg", a, a)[None, None] * 5.0
    cl_f = np.eye(3)[None, None, None] * np.ones((nl, 1, 1)) * 1e-3
    # compact the covariance tables to the chunk layout (slot 1 = dup of 2)
    f_idx = np.array([0, 2, 2], np.int32)
    ls, lf = mstep.prepare_cl_factors(
        cl_s[:, :, :, f_idx][:, :, :, :, f_idx],
        cl_f[:, :, :, f_idx][:, :, :, :, f_idx],
        out_dtype=np.float64,
    )
    mv = np.array([1, 2], np.int32)
    res = mstep.kl_product_step_split(
        np.ascontiguousarray(beam_c.real),
        np.ascontiguousarray(beam_c.imag),
        noisew,
        ls,
        lf,
        mv,
        npol=npol,
        nl=nl,
    )
    # full-F band table, gathered on device via f_idx
    clb_full = [np.einsum("lfk,lgk->lfg",
                          rng.standard_normal((nl, Ff, 2)),
                          rng.standard_normal((nl, Ff, 2)))
                for _ in range(2)]
    clb_full = [0.5 * (c + c.transpose(0, 2, 1)) + 3 * np.eye(Ff)[None]
                for c in clb_full]
    band_full = mstep.band_factor_table(clb_full, out_dtype=np.float64)
    got = mstep.fisher_step_split(
        res.evals, res.evecs_re, res.evecs_im, res.beam_re, res.beam_im,
        band_full, ps_threshold=0.05, fisher_k=3 * T, npol=npol, nl=nl,
        f_idx=np.asarray(f_idx),
    )
    # same thing with the gather done on the host
    band_pre = band_full[:, :, f_idx]
    want = mstep.fisher_step_split(
        res.evals, res.evecs_re, res.evecs_im, res.beam_re, res.beam_im,
        band_pre, ps_threshold=0.05, fisher_k=3 * T, npol=npol, nl=nl,
    )
    assert np.abs(np.asarray(want[0])).max() > 0
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------
# end to end vs the file pipeline
# ---------------------------------------------------------------------

CONFIG = """
config:
    beamtransfers:      Yes
    kltransform:        Yes
    psfisher:           Yes
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
    tsys:               1.0

kltransform:
    -   type:           KLTransform
        name:           kl
        use_thermal:    Yes
        use_foregrounds: No

psfisher:
    -   type:           Full
        name:           psx
        klname:         kl
        k_bands:
        -   spacing:    linear
            start:      0.0
            stop:       0.25
            num:        3
"""


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    base = tmp_path_factory.mktemp("fisher_resident")
    cfile = str(base / "params.yaml")
    with open(cfile, "w") as f:
        f.write(CONFIG.format(outdir=f"{base}/testdir"))
    m = manager.ProductManager.from_config(cfile)
    m.generate()
    return m


def _resident_fisher(m, topband=False, **kw):
    tel = m.telescope
    kl = m.kltransforms["kl"]
    ps = m.psestimators["psx"]
    ps.genbands()

    # the exact covariances the file KL solved (thermal-only noise:
    # use_foregrounds is off, so the foreground factor is null)
    cl_s = kl.signal()
    cl_f = np.zeros_like(cl_s)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_f, out_dtype=np.float64)

    import bench

    _, _, noisew, _ = bench._covariances(tel)
    noisew = noisew.astype(np.float64)

    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    pos, neg = resident.btm_resident(tel, blg, fig)

    band_lt = mstep.band_factor_table(ps.clarray, out_dtype=np.float64)
    resident._FISHER_K[0] = 0  # forget escalation state between tests
    ev, nmo, fish = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=4,
        band_lt=band_lt, ps_threshold=kl.threshold,
        topband=topband, kl_cut=kl.threshold, **kw,
    )
    return ev, fish, ps


def test_resident_fisher_matches_psexact(products):
    """Fused resident Fisher == the file-based PSExact total Fisher."""
    ev, fish, ps = _resident_fisher(products)
    f_file, _ = ps.fisher_bias()
    f_file = np.asarray(f_file)

    scale = np.abs(f_file).max()
    assert scale > 0
    np.testing.assert_allclose(fish, f_file, rtol=2e-4, atol=1e-6 * scale)
    # Fisher matrices are real symmetric up to roundoff
    np.testing.assert_allclose(fish.imag, 0, atol=1e-8 * scale)
    np.testing.assert_allclose(fish.real, fish.real.T, rtol=1e-6)


def test_resident_fisher_topband_engine(products):
    """The matmul-only top-band KL engine feeds the same Fisher.

    Retained-band eigensolve + fused Fisher in one dispatch.  Sub-cut modes are exact zeros there, which
    is precisely the set the estimator's threshold mask drops.
    """
    ev, fish_tb, ps = _resident_fisher(products, topband=True)
    f_file, _ = ps.fisher_bias()
    f_file = np.asarray(f_file)
    scale = np.abs(f_file).max()
    np.testing.assert_allclose(fish_tb, f_file, rtol=5e-4, atol=1e-5 * scale)


def test_resident_fisher_lchunk_none_resolves(products, monkeypatch):
    """Regression guard (r3): ``fisher_lchunk=None`` resolves to the
    module-level ``_FISHER_LCHUNK`` default instead of raising
    ``int(None)``, and the Fisher total is invariant to the l-chunk
    depth of the factor scan."""
    monkeypatch.setattr(resident, "_FISHER_LCHUNK", 3)
    ev, fish, ps = _resident_fisher(products)
    f_file, _ = ps.fisher_bias()
    f_file = np.asarray(f_file)
    scale = np.abs(f_file).max()
    np.testing.assert_allclose(fish, f_file, rtol=2e-4, atol=1e-6 * scale)


def test_resident_fisher_escalates_mode_slice(products):
    """A deliberately tiny initial fisher_k escalates to cover retention."""
    ev, fish_small, ps = _resident_fisher(products, fisher_k=2)
    retained = int((ev > products.kltransforms["kl"].threshold).sum(axis=1).max())
    assert retained > 2  # the escalation actually had work to do
    assert resident._FISHER_K[0] >= retained
    f_file, _ = ps.fisher_bias()
    scale = np.abs(np.asarray(f_file)).max()
    np.testing.assert_allclose(fish_small, np.asarray(f_file), rtol=2e-4,
                               atol=1e-6 * scale)
