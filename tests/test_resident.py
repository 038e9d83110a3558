"""The device-resident product path must reproduce the host-staged one."""

import numpy as np
import pytest

import driftscan_tpu.backend as backend
from driftscan_tpu.ops import zarray as za
from driftscan_tpu.parallel import mstep, resident
from driftscan_tpu.telescope import cylinder

# Bench-scale suite: excluded from the default fast tier (see pyproject.toml)
pytestmark = pytest.mark.slow



def _tel(**kw):
    return cylinder.UnpolarisedCylinderTelescope.from_config(
        dict(
            num_freq=2,
            freq_start=100.0,
            freq_end=110.0,
            freq_mode="edge",
            num_cylinders=2,
            cylinder_width=2.0,
            num_feeds=2,
            feed_spacing=1.5,
            **kw,
        )
    )


def test_btm_resident_matches_transfer_matrices():
    tel = _tel()
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    tarray = np.asarray(tel.transfer_matrices(blg, fig))  # (nu, 1, L+1, 2L+1)
    pos, neg = resident.btm_resident(tel, blg, fig)
    posn, negn = za.to_numpy(pos), za.to_numpy(neg)

    L = tel.lmax
    np.testing.assert_allclose(posn[:, 0], tarray[:, 0, :, : L + 1], atol=1e-10)
    # packed negative m: tarray[..., -m] = neg[..., m-1]
    for m in (1, L // 2, L):
        np.testing.assert_allclose(
            negn[:, 0, :, m - 1], tarray[:, 0, :, -m], atol=1e-10
        )


def test_btm_resident_polarised():
    tel = cylinder.PolarisedCylinderTelescope.from_config(
        dict(
            num_freq=1,
            freq_start=100.0,
            freq_end=110.0,
            freq_mode="edge",
            num_cylinders=1,
            cylinder_width=2.0,
            num_feeds=2,
            feed_spacing=1.5,
        )
    )
    bl = np.arange(tel.npairs)
    fi = np.zeros_like(bl)

    tarray = np.asarray(tel.transfer_matrices(bl, fi))  # (nu, 4, L+1, 2L+1)
    pos, neg = resident.btm_resident(tel, bl, fi)
    posn, negn = za.to_numpy(pos), za.to_numpy(neg)

    L = tel.lmax
    np.testing.assert_allclose(posn, tarray[..., : L + 1], atol=1e-10)
    for m in (1, L // 2):
        np.testing.assert_allclose(negn[..., m - 1], tarray[..., -m], atol=1e-10)


def test_product_all_resident_matches_host_path():
    # f64 on both paths: this tiny telescope's KL evals (~1e-3) sit at the
    # f32 resolution floor, so only the f64 comparison is meaningful.
    tel = _tel()
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    import bench

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    noisew = noisew.astype(np.float64)

    pos, neg = resident.btm_resident(tel, blg, fig)
    evals_r, nmodes_r = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=4
    )

    # host-staged path: same product step fed from the packed host tarray
    tarray = np.asarray(tel.transfer_matrices(blg, fig))
    nl = tel.lmax + 1
    nm = tel.mmax + 1
    t5 = tarray.reshape(tel.npairs, tel.nfreq, 1, nl, -1)
    step = mstep.jit_product_step_split(npol=1, nl=nl)

    evals_h = []
    for s in range(0, nm, 4):
        ms = np.arange(s, min(s + 4, nm))
        beam = np.zeros(
            (4, tel.nfreq, 2 * tel.npairs, nl), dtype=np.complex128
        )
        for i, mi in enumerate(ms):
            p = t5[..., mi]
            n = (-1) ** mi * np.conj(t5[..., -mi]) if mi else np.zeros_like(p)
            blk = np.concatenate([p, n], axis=0)
            beam[i] = blk.transpose(1, 0, 2, 3).reshape(
                tel.nfreq, 2 * tel.npairs, nl
            )
        mv = np.full(4, -1, np.int32)
        mv[: len(ms)] = ms
        res = step(
            np.ascontiguousarray(beam.real),
            np.ascontiguousarray(beam.imag),
            noisew,
            ls,
            lf,
            mv,
        )
        evals_h.append(np.asarray(res.evals)[: len(ms)])
    evals_h = np.concatenate(evals_h)

    assert evals_r.shape == evals_h.shape
    scale = np.abs(evals_h).max() + 1e-30
    # the atol floor covers tail modes whose band-boundary assignment
    # legitimately shifts with the paths' different beam roundoff
    np.testing.assert_allclose(evals_r, evals_h, rtol=1e-6, atol=1e-4 * scale)


def test_product_all_resident_mesh_sharded():
    """The resident spectrum pass shards its m batches over the mesh and
    reproduces the single-device result."""
    import jax

    from driftscan_tpu.parallel import mesh as meshmod

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")

    tel = _tel()
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    import bench

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    noisew = noisew.astype(np.float64)

    pos, neg = resident.btm_resident(tel, blg, fig)
    mesh = meshmod.make_mesh(jax.devices()[:8])

    ev0, nm0 = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=8
    )
    ev1, nm1 = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=8, mesh=mesh
    )
    np.testing.assert_array_equal(nm1, nm0)
    scale = np.abs(ev0).max() + 1e-30
    np.testing.assert_allclose(ev1, ev0, rtol=1e-8, atol=1e-10 * scale)


def test_product_all_resident_sig_cap_matches_exact():
    """The signal-side rank cap must reproduce the exact spectrum for the
    retained (significant) modes."""
    tel = _tel()
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    import bench

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n, out_dtype=np.float64)
    noisew = noisew.astype(np.float64)

    pos, neg = resident.btm_resident(tel, blg, fig)
    ev0, _ = resident.product_all_resident(tel, pos, neg, ls, lf, noisew, mbatch=4)
    ev1, _ = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, mbatch=4, sig_k_cap=8
    )

    for i in range(ev0.shape[0]):
        top = ev0[i] > 1e-2 * max(ev0[i].max(), 1e-300)
        k = int(top.sum())
        if k == 0:
            continue
        np.testing.assert_allclose(ev1[i, -k:], ev0[i, -k:], rtol=5e-3)


def test_adaptive_sig_depth_matches_fixed():
    """Adaptive per-batch deflation depth must match the fixed depth —
    both in the weak regime (stays at one level) and in a strong-signal
    regime (must deepen: top eigenvalue above the one-level bound)."""
    import bench

    tel = _tel()
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    pos, neg = resident.btm_resident(tel, blg, fig)

    for boost, tag in [(1.0, "weak"), (1e15, "strong")]:
        ls, lf = mstep.prepare_cl_factors(
            cl_s * boost, cl_n, out_dtype=np.float64
        )
        nw = noisew.astype(np.float64)

        ev_a, nm_a = resident.product_all_resident(
            tel, pos, neg, ls, lf, nw, mbatch=4
        )
        ev_f, nm_f = resident.product_all_resident(
            tel, pos, neg, ls, lf, nw, mbatch=4, sig_levels=2
        )
        if tag == "strong":
            assert ev_a.max() > resident._SIG1_TOP_BOUND  # deepening hit
        np.testing.assert_array_equal(nm_a, nm_f)
        big = ev_f > max(ev_f.max() * 1e-6, 1e-12)
        np.testing.assert_allclose(
            ev_a[big], ev_f[big], rtol=1e-6, err_msg=tag
        )


def test_bucketed_product_matches_full():
    """Freq-compacted + mode-capped dispatch == the full-size program.

    Wide fractional band (100-200 MHz) so the per-freq band limit
    actually thins with m and the bucketed path compacts; quantisation
    floors forced down so compaction kicks in at this tiny scale.
    """
    tel = cylinder.UnpolarisedCylinderTelescope.from_config(
        dict(
            num_freq=4, freq_start=100.0, freq_end=200.0, freq_mode="edge",
            num_cylinders=2, cylinder_width=2.0, num_feeds=3,
            feed_spacing=1.5,
        )
    )
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    pos, neg = resident.btm_resident(tel, blg, fig)

    import bench

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(
        cl_s, cl_n, out_dtype=np.asarray(pos.re).dtype
    )

    ev_full, nm_full = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, bucket=False, sig_levels=2
    )

    import driftscan_tpu.parallel.resident as rmod

    orig_q, orig_t = rmod._quant_frac, rmod._BUCKET_MIN_SAVING
    try:
        # quantise exactly and accept any saving, so this small case
        # genuinely dispatches compacted shapes
        rmod._quant_frac = lambda x, full: min(max(int(x), 1), full)
        rmod._BUCKET_MIN_SAVING = 1
        ev_b, nm_b = resident.product_all_resident(
            tel, pos, neg, ls, lf, noisew, bucket=True, sig_levels=2
        )
    finally:
        rmod._quant_frac, rmod._BUCKET_MIN_SAVING = orig_q, orig_t

    np.testing.assert_array_equal(nm_b, nm_full)
    # both spectra ascending with zero padding in front; the retained
    # (top) eigenvalues must agree to solver tolerance
    scale = max(ev_full.max(), 1e-30)
    np.testing.assert_allclose(ev_b, ev_full, rtol=2e-4, atol=1e-6 * scale)
    # the bucketing must actually have engaged (some m with thin support)
    counts_last = nm_full[-1]
    assert (counts_last == 0).any() or nm_full.max() < min(
        tel.lmax + 1, 2 * tel.npairs
    )


def test_m_window_streaming_matches_full():
    """BTM + product per m-window == the full-range resident run.

    The device-memory streaming axis: at production band limits the full
    (l, m) tables exceed device memory (66 GB at 256 freqs x lmax 1006
    polarised), so the
    pipeline runs per m-window; each window's spectra must match the
    monolithic run exactly.
    """
    import bench

    tel = cylinder.UnpolarisedCylinderTelescope.from_config(
        dict(
            num_freq=2, freq_start=100.0, freq_end=110.0, freq_mode="edge",
            num_cylinders=2, cylinder_width=2.0, num_feeds=3,
            feed_spacing=1.5,
        )
    )
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    ls, lf = mstep.prepare_cl_factors(cl_s, cl_n)

    pos, neg = resident.btm_resident(tel, blg, fig)
    ev_full, nm_full = resident.product_all_resident(
        tel, pos, neg, ls, lf, noisew, bucket=False, sig_levels=2
    )

    nm = tel.mmax + 1
    cut = nm // 2
    evs, nms = [], []
    for m0, m1 in ((0, cut), (cut, nm)):
        pw, nw = resident.btm_resident(tel, blg, fig, m_range=(m0, m1))
        assert pw.re.shape[-1] == m1 - m0
        ev, nmo = resident.product_all_resident(
            tel, pw, nw, ls, lf, noisew, bucket=False, sig_levels=2,
            m_range=(m0, m1),
        )
        assert ev.shape[0] == m1 - m0
        evs.append(ev)
        nms.append(nmo)
    ev_win = np.concatenate(evs)
    nm_win = np.concatenate(nms)

    np.testing.assert_array_equal(nm_win, nm_full)
    scale = max(ev_full.max(), 1e-30)
    np.testing.assert_allclose(ev_win, ev_full, rtol=2e-5, atol=1e-8 * scale)


def test_topband_product_matches_exact():
    """The matmul-only top-band engine must reproduce the exact spectrum
    for every eigenvalue above the retention cut, in both a weak regime
    (band near the cut) and a boosted regime (band spanning many
    deflation levels)."""
    import bench

    tel = _tel()
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]

    cl_s, cl_n, noisew, _ = bench._covariances(tel)
    pos, neg = resident.btm_resident(tel, blg, fig)
    cut = 0.1

    for boost, tag in [(1.0, "weak"), (1e8, "strong")]:
        ls, lf = mstep.prepare_cl_factors(cl_s * boost, cl_n, out_dtype=np.float64)
        nw = noisew.astype(np.float64)

        ev0, nm0 = resident.product_all_resident(
            tel, pos, neg, ls, lf, nw, mbatch=4
        )
        ev1, nm1 = resident.product_all_resident(
            tel, pos, neg, ls, lf, nw, mbatch=4, topband=True, kl_cut=cut
        )
        np.testing.assert_array_equal(nm0, nm1)
        # identical retained sets...
        np.testing.assert_array_equal(ev0 > cut, ev1 > cut, err_msg=tag)
        # ...with tier-level agreement on the retained eigenvalues
        keep = ev0 > cut
        if keep.any():
            np.testing.assert_allclose(
                ev1[keep], ev0[keep], rtol=2e-4, err_msg=tag
            )
        # the sub-cut tail is either exact zeros (top-band chunks) or
        # the exact engine's values (fallback chunks) — never spurious
        # above-cut entries (already checked by the retained-set
        # equality above)
        assert float(np.abs(ev1[~keep]).max(initial=0.0)) <= cut


def test_run_topband_escalation_ladder():
    """The dispatcher escalates (2k, levels+1) on a failed certificate,
    remembers the working size, and falls back to the exact engine when
    the ladder passes k = n/2."""
    n = 64
    k0 = resident._quant_frac(max(n // 8, 8), n)
    ev = np.ones((4, 3))
    nmo = np.ones(3, dtype=int)

    # case 1: first size fails the certificate, the doubled size passes
    calls = []

    def run_ok_second(mv, sig_levels, kw, nw, lsd, lfd):
        k = (kw or {}).get("kl_top_k")
        calls.append((k, (kw or {}).get("kl_levels"), sig_levels))
        ok = np.asarray([k is not None and k >= 2 * k0])
        return ev, nmo, ok, None

    saved = dict(resident._TB_STATE)
    resident._TB_STATE.clear()
    try:
        out, _, _ = resident._run_topband(
            run_ok_second, None, {}, None, None, None, n, 0.1, None
        )
        np.testing.assert_array_equal(out, ev)
        assert [c[0] for c in calls] == [k0, 2 * k0]
        assert calls[1][1] == 6  # levels escalated 5 -> 6
        assert resident._TB_STATE[n] == (2 * k0, 6)

        # case 2: remembered state skips the failed rung on redispatch
        calls.clear()
        resident._run_topband(
            run_ok_second, None, {}, None, None, None, n, 0.1, None
        )
        assert [c[0] for c in calls] == [2 * k0]

        # case 3: nothing certifies -> exact fallback (kw is the plain
        # extra dict again, sig_levels the exact default)
        def run_never_ok(mv, sig_levels, kw, nw, lsd, lfd):
            calls.append(((kw or {}).get("kl_top_k"), sig_levels))
            return ev, nmo, np.asarray([kw is not None and "kl_top_k" in kw
                                        and False]), None
        calls.clear()
        resident._TB_STATE.clear()
        out, _, _ = resident._run_topband(
            run_never_ok, None, {"x": 1}, None, None, None, n, 0.1, 2
        )
        np.testing.assert_array_equal(out, ev)
        # ladder k0 -> 2k0 -> n/2 (quantised rungs), then the exact call
        assert calls[-1] == (None, 2)
        assert all(c[0] is not None for c in calls[:-1])
        assert n not in resident._TB_STATE  # nothing certified
    finally:
        resident._TB_STATE.clear()
        resident._TB_STATE.update(saved)
