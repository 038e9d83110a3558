"""Device-resident product generation: BTM -> SVD -> KL without host trips.

The file-based pipeline stages communicate through HDF5 (the reference's
contract), which forces a device->host fetch of the full BTM and a
host->device re-upload for the SVD/KL stage.  For in-memory workflows
(benchmarking, interactive analysis, simulation) this module keeps
everything on the device instead:

* :func:`btm_resident` computes the beam transfer matrices bucket-by-
  bucket (per-nside, like ``TransitTelescope.transfer_matrices``) and
  leaves the (l, m) tables on device, padded to the global band limit;
* :func:`product_step_resident` builds each m-batch's beam matrix on
  device (a gather along the m axis + the (-1)^m conjugate negative-m
  block, reference packing at
  /root/reference/drift/core/beamtransfer.py:620-624) fused into the same
  jit as the SVD+KL product step, so the only host traffic is the final
  eigenvalues.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import telescope as teles
from ..ops import sht, zarray as za
from . import mstep


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _tables_set(pr, pi, nr, ni, sel, p_re, p_im, n_re, n_im, pm):
    """Scatter a chunk into the resident BTM tables, in place.

    The tables are donated: the eager ``tab.at[...].set`` this replaces
    allocated a full second copy of each multi-GB (l, m) table per
    chunk, which at production band limits transiently doubled the
    tables' device-memory footprint.

    ``sel`` is padded to the chunk's power-of-two batch with the
    out-of-bounds index ``nu`` — scatter drops those rows, so the padded
    duplicate units in the beam batch never land in the tables.
    """
    npol_t, subl = p_re.shape[1], p_re.shape[2]
    wp, wn = p_re.shape[3], n_re.shape[3]
    pols, sub = np.s_[:npol_t], np.s_[:subl]
    pr = pr.at[sel, pols, sub, :wp].set(p_re * pm)
    pi = pi.at[sel, pols, sub, :wp].set(p_im * pm)
    nr = nr.at[sel, pols, sub, :wn].set(n_re * pm)
    ni = ni.at[sel, pols, sub, :wn].set(n_im * pm)
    return pr, pi, nr, ni


def btm_resident(tel, bl_indices, f_indices, m_range=None):
    """Compute BTMs for the given units, leaving them on device.

    Returns (pos, neg): Z pytrees with planes
    ``pos (nu, npol, lside+1, lside+1)`` (coefficients for m >= 0) and
    ``neg (nu, npol, lside+1, lside)`` (m = -1 ... -lside, column
    j <-> m = j + 1), already masked to each unit's own band limit.  For
    unpolarised telescopes npol == 1; polarised ones carry their
    transformed Stokes components (the skipped ones stay zero, matching
    ``transfer_matrices``).

    ``m_range=(m0, m1)`` computes and stores only that m-window, in the
    *uniform* layout: both planes get width m1 - m0 with column
    j <-> m = m0 + j (the m = 0 negative column is zero).  This is the
    device-memory streaming axis: the full (l, m) tables scale as nu * npol *
    nl * nm and exceed device memory at production band limits (66 GB
    at 256 freqs x lmax 1006 polarised), while each window's share of
    the SHT costs only its fraction of the full transform.
    """
    bl_indices = np.asarray(bl_indices)
    f_indices = np.asarray(f_indices)
    lside = tel.lmax
    npol = tel.num_pol_sky

    lmax_arr, _ = teles.max_lm(
        tel.baselines[bl_indices],
        tel.wavelengths[f_indices],
        tel.u_width,
        tel.v_width,
    )
    lmax_arr = np.ceil(lmax_arr * tel.l_boost).astype(np.int64)
    nsides = np.array([tel._nside_for(int(l)) for l in lmax_arr])

    nu = len(bl_indices)
    dt = jnp.float32 if tel.single_precision else jnp.float64
    if m_range is None:
        pw, nw_ = lside + 1, lside
    else:
        m0, m1 = int(m_range[0]), int(m_range[1])
        pw = nw_ = m1 - m0
    pos_re = jnp.zeros((nu, npol, lside + 1, pw), dtype=dt)
    pos_im = jnp.zeros_like(pos_re)
    neg_re = jnp.zeros((nu, npol, lside + 1, nw_), dtype=dt)
    neg_im = jnp.zeros_like(neg_re)

    for ns in np.unique(nsides):
        bucket = np.nonzero(nsides == ns)[0]
        # Frequency-major order within the bucket: the unique beams are
        # per-(freq, beamclass), so consecutive chunks then share them
        # across baselines and the device beam cache serves each beam
        # once per window instead of once per baseline.
        bucket = bucket[np.argsort(f_indices[bucket], kind="stable")]
        boff = 0
        for take in teles.sht_unit_chunks(len(bucket), 12 * int(ns) ** 2, npol):
            sel = bucket[boff : boff + take]
            boff += take
            # Quantise the chunk band limit to a power-of-two fraction of
            # the telescope lmax: every distinct sub_lmax is a separate
            # compile *and*, in windowed runs, a separate ~GB device
            # Legendre table — quantisation caps both at log2(lside)
            # variants.  The extra l rows are exact
            # zeros past each unit's own band-limit mask below.
            sub_lmax = min(lside, _quant_frac(int(lmax_arr[sel].max()), lside))

            sub_win = None
            if m_range is not None:
                # this chunk only carries m <= sub_lmax: skip before the
                # (expensive) beam evaluation, not after
                if m0 > sub_lmax:
                    continue
                # full window width (not clamped to sub_lmax): m > l
                # coefficients are exactly zero by the Legendre
                # recurrence, and a constant width shares one compiled
                # program across chunks and windows
                sub_win = (m0, m1)

            # pad the unit batch to a power of two for shape-stable compiles
            nsel = len(sel)
            npad = 1 << max(nsel - 1, 0).bit_length()
            bsel = np.concatenate(
                [bl_indices[sel], np.repeat(bl_indices[sel][-1], npad - nsel)]
            )
            fsel = np.concatenate(
                [f_indices[sel], np.repeat(f_indices[sel][-1], npad - nsel)]
            )

            if os.environ.get("DRIFTSCAN_TPU_DEBUG_CHUNKS"):
                import time as _time

                print(
                    f"[btm_resident +{_time.time():.0f}] nside={ns} "
                    f"take={take} npad={npad} sub_lmax={sub_lmax} "
                    f"win={sub_win}",
                    flush=True,
                )
            tel._init_trans(int(ns))
            cvis = tel._beam_map_batch_split(bsel, fsel)
            if tel.single_precision:
                cvis = za.Z(cvis.re.astype(jnp.float32), cvis.im.astype(jnp.float32))

            # btrans = conj(SHT(conj(map))) (reference telescope.py:1188-1191)
            p, n = sht.analysis_split(
                cvis.conj(), lmax=sub_lmax, neg_m=True, m_window=sub_win,
                nside=int(ns), ring_padded=True,
            )
            p, n = p.conj(), n.conj()

            # normalise to a pol axis: (nu, npol_t, l, m)
            if p.re.ndim == 3:
                p = za.Z(p.re[:, None], p.im[:, None])
                n = za.Z(n.re[:, None], n.im[:, None])
            npol_t = p.re.shape[1]

            # per-unit band-limit mask; padded batch rows get lmax -1
            # (fully masked) and the out-of-bounds scatter index nu, so
            # the duplicate units are dropped by the scatter itself
            ls = np.arange(sub_lmax + 1)
            lmax_pad = np.concatenate(
                [lmax_arr[sel], np.full(npad - nsel, -1, dtype=lmax_arr.dtype)]
            )
            lmask = jnp.asarray(
                (ls[None, :] <= lmax_pad[:, None]).astype(np.float32), dtype=dt
            )
            sel_pad = jnp.asarray(
                np.concatenate([sel, np.full(npad - nsel, nu)]).astype(np.int32)
            )

            pm = lmask[:, None, :, None]  # masks l; broadcasts (pol, m)
            pos_re, pos_im, neg_re, neg_im = _tables_set(
                pos_re, pos_im, neg_re, neg_im, sel_pad, p.re, p.im, n.re, n.im, pm
            )
            if os.environ.get("DRIFTSCAN_TPU_DEBUG_CHUNKS"):
                # synchronous in debug mode so an OOM localises to a chunk
                pos_re.block_until_ready()

    return za.Z(pos_re, pos_im), za.Z(neg_re, neg_im)


def _build_beam_batch(
    pos_re, pos_im, neg_re, neg_im, mv, npairs, nfreq_full, npol, nl,
    f_idx=None, fmask=None, m_lo=None,
):
    """(M, F, T, npol*nl) beam planes from the resident (l, m) tables.

    pos/neg planes are (nu, npol, nl, nm*) with units ordered
    baseline-major (u = bl * nfreq_full + f).  With ``f_idx`` the
    frequency axis is compacted to the given indices (``fmask`` zeroes
    padding slots) — the gather happens *after* the per-m slice so no
    full-band copy of the tables is ever made.  ``m_lo >= 0`` selects
    the uniform m-window layout (column j <-> m = m_lo + j in *both*
    planes; ``m_lo`` is a traced scalar so all same-width windows share
    one compiled program); the default None is the legacy full-range
    layout (neg column j <-> m = j + 1).
    """

    def build_one(m):
        if m_lo is not None:
            col = jnp.maximum(m - m_lo, 0)
            p_re = jnp.take(pos_re, col, axis=-1)  # (nu, npol, nl)
            p_im = jnp.take(pos_im, col, axis=-1)
            n_re = jnp.take(neg_re, col, axis=-1)
            n_im = jnp.take(neg_im, col, axis=-1)
        else:
            p_re = jnp.take(pos_re, m, axis=-1)  # (nu, npol, nl)
            p_im = jnp.take(pos_im, m, axis=-1)
            midx = jnp.maximum(m - 1, 0)
            n_re = jnp.take(neg_re, midx, axis=-1)
            n_im = jnp.take(neg_im, midx, axis=-1)
        sign = jnp.where(m % 2 == 0, 1.0, -1.0).astype(p_re.dtype)
        use_neg = (m > 0).astype(p_re.dtype)
        n_re = sign * use_neg * n_re
        n_im = -sign * use_neg * n_im  # conjugate

        def organise(x):
            # (nu, npol, nl) -> (F, npairs, npol*nl)
            x = x.reshape(npairs, nfreq_full, npol * nl)
            if f_idx is not None:
                x = jnp.take(x, f_idx, axis=1) * fmask[None, :, None]
            return x.transpose(1, 0, 2)

        top_re, top_im = organise(p_re), organise(p_im)
        bot_re, bot_im = organise(n_re), organise(n_im)
        # telescope axis: positive-m pair block, then the conjugate block
        return (
            jnp.concatenate([top_re, bot_re], axis=1),
            jnp.concatenate([top_im, bot_im], axis=1),
        )

    return jax.vmap(build_one)(mv)


@functools.partial(
    jax.jit,
    static_argnames=("npairs", "nfreq", "nl", "npol", "polsvcut"),
)
def _svdcount_batch(
    pos_re, pos_im, neg_re, neg_im, noisew, mv,
    npairs: int, nfreq: int, nl: int, npol: int = 1, polsvcut: float = 1e-4,
    m_lo=None,
):
    """Per-(m, freq) retained SVD mode counts — the cheap sizing pass.

    Runs only the beam build + triple SVD (~1% of the product step) so
    the bucketed product dispatcher can compact each m-chunk's pencil to
    its true dimension before paying the cubic KL cost.
    """
    from ..ops import linalg

    beams_re, beams_im = _build_beam_batch(
        pos_re, pos_im, neg_re, neg_im, mv, npairs, nfreq, npol, nl, m_lo=m_lo
    )

    def one_m(bm_re, bm_im, mval):
        lmask = (jnp.arange(nl) >= mval).astype(bm_re.dtype)
        tile = jnp.tile(lmask, npol)[None, None, :]
        w = noisew[:, :, None]
        out = linalg.triple_svd_split_batched(
            bm_re * tile * w, bm_im * tile * w, npol=npol, nl=nl,
            polsvcut=polsvcut,
        )
        return (out[5] * (mval >= 0)).astype(jnp.int32)

    return jax.vmap(one_m)(beams_re, beams_im, mv)


@functools.partial(
    jax.jit,
    static_argnames=(
        "npairs", "nfreq", "nl", "npol", "fg_levels", "sig_levels",
        "fg_k_cap", "sig_k_cap", "band_rel", "method", "s_cap", "nfreq_full",
        "kl_cut", "kl_top_k", "kl_levels",
    ),
)
def _resident_batch(
    pos_re,
    pos_im,
    neg_re,
    neg_im,
    noisew,
    ls,
    lf,
    mv,
    npairs: int,
    nfreq: int,
    nl: int,
    npol: int = 1,
    fg_levels: int = 8,
    sig_levels: int = 2,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    band_rel: float = 3e-2,
    method: str = "qr",
    s_cap: int = 0,
    nfreq_full: int = 0,
    kl_cut: float = 0.0,
    kl_top_k: int = 0,
    kl_levels: int = 5,
    f_idx=None,
    fmask=None,
    m_lo=None,
):
    """Build the m-batch beam matrices on device and run the product step.

    With ``f_idx``/``fmask``/``nfreq_full`` the frequency axis is
    compacted (``nfreq`` is then the compact length); ``noisew``/``ls``/
    ``lf`` must already be gathered to the same indices.
    """
    beams_re, beams_im = _build_beam_batch(
        pos_re, pos_im, neg_re, neg_im, mv, npairs,
        nfreq_full or nfreq, npol, nl, f_idx=f_idx, fmask=fmask, m_lo=m_lo,
    )

    return mstep.kl_product_step_split(
        beams_re,
        beams_im,
        noisew,
        ls,
        lf,
        mv,
        npol=npol,
        nl=nl,
        fg_levels=fg_levels,
        sig_levels=sig_levels,
        fg_k_cap=fg_k_cap,
        sig_k_cap=sig_k_cap,
        band_rel=band_rel,
        method=method,
        s_cap=s_cap,
        kl_cut=kl_cut,
        kl_top_k=kl_top_k,
        kl_levels=kl_levels,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "npairs", "nfreq", "nl", "npol", "fg_levels", "sig_levels",
        "fg_k_cap", "sig_k_cap", "band_rel", "method", "s_cap", "nfreq_full",
        "kl_cut", "kl_top_k", "kl_levels",
    ),
)
def _spectrum_batch(
    pos_re,
    pos_im,
    neg_re,
    neg_im,
    noisew,
    ls,
    lf,
    mv,
    npairs: int,
    nfreq: int,
    nl: int,
    npol: int = 1,
    fg_levels: int = 8,
    sig_levels: int = 2,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    band_rel: float = 3e-2,
    method: str = "qr",
    s_cap: int = 0,
    nfreq_full: int = 0,
    kl_cut: float = 0.0,
    kl_top_k: int = 0,
    kl_levels: int = 5,
    f_idx=None,
    fmask=None,
    m_lo=None,
):
    """Spectrum-only product batch: returns (evals, nmodes, klok), so XLA
    dead-code-eliminates the eigenvector/beam outputs a spectrum pass
    never reads.

    (One jit per m-batch rather than a lax.scan over all batches: the
    host sees each batch's spectrum, which the adaptive depth and the
    Fisher mode-slice escalation decide on.)
    """
    res = _resident_batch.__wrapped__(
        pos_re,
        pos_im,
        neg_re,
        neg_im,
        noisew,
        ls,
        lf,
        mv,
        npairs=npairs,
        nfreq=nfreq,
        nl=nl,
        npol=npol,
        fg_levels=fg_levels,
        sig_levels=sig_levels,
        fg_k_cap=fg_k_cap,
        sig_k_cap=sig_k_cap,
        band_rel=band_rel,
        method=method,
        s_cap=s_cap,
        nfreq_full=nfreq_full,
        kl_cut=kl_cut,
        kl_top_k=kl_top_k,
        kl_levels=kl_levels,
        f_idx=f_idx,
        fmask=fmask,
        m_lo=m_lo,
    )
    return res.evals, res.nmodes, res.klok


@functools.partial(
    jax.jit,
    static_argnames=(
        "npairs", "nfreq", "nl", "npol", "fg_levels", "sig_levels",
        "fg_k_cap", "sig_k_cap", "band_rel", "method", "s_cap", "nfreq_full",
        "kl_cut", "kl_top_k", "kl_levels",
        "ps_threshold", "fisher_k", "fisher_lchunk",
    ),
)
def _fisher_batch(
    pos_re,
    pos_im,
    neg_re,
    neg_im,
    noisew,
    ls,
    lf,
    mv,
    band_lt,
    npairs: int,
    nfreq: int,
    nl: int,
    npol: int = 1,
    fg_levels: int = 8,
    sig_levels: int = 2,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    band_rel: float = 3e-2,
    method: str = "qr",
    s_cap: int = 0,
    nfreq_full: int = 0,
    kl_cut: float = 0.0,
    kl_top_k: int = 0,
    kl_levels: int = 5,
    ps_threshold: float = 0.1,
    fisher_k: int = 128,
    fisher_lchunk: int = 64,
    f_idx=None,
    fmask=None,
    m_lo=None,
):
    """Product batch + per-m quadratic-estimator Fisher in one program.

    Runs the full product step and immediately contracts each m's
    retained KL modes against the factored band covariances
    (:func:`mstep.fisher_step_split`) — the KL eigenvectors and SVD
    beams stay inside the XLA program and never reach the host, exactly
    like the spectrum pass.  Returns
    (evals, nmodes, klok, fisher_re, fisher_im); the caller sums the
    per-m Fisher blocks and must check no m retained more than
    ``fisher_k`` modes (the kernel's static mode-slice).
    """
    res = _resident_batch.__wrapped__(
        pos_re,
        pos_im,
        neg_re,
        neg_im,
        noisew,
        ls,
        lf,
        mv,
        npairs=npairs,
        nfreq=nfreq,
        nl=nl,
        npol=npol,
        fg_levels=fg_levels,
        sig_levels=sig_levels,
        fg_k_cap=fg_k_cap,
        sig_k_cap=sig_k_cap,
        band_rel=band_rel,
        method=method,
        s_cap=s_cap,
        nfreq_full=nfreq_full,
        kl_cut=kl_cut,
        kl_top_k=kl_top_k,
        kl_levels=kl_levels,
        f_idx=f_idx,
        fmask=fmask,
        m_lo=m_lo,
    )
    f_re, f_im = mstep.fisher_step_split(
        res.evals,
        res.evecs_re,
        res.evecs_im,
        res.beam_re,
        res.beam_im,
        band_lt,
        ps_threshold=ps_threshold,
        fisher_k=fisher_k,
        npol=npol,
        nl=nl,
        s_cap=s_cap,
        l_chunk=fisher_lchunk,
        f_idx=f_idx,
    )
    return res.evals, res.nmodes, res.klok, f_re, f_im


# One y-Gram deflation level resolves eigenvalues to ~n*eps(f32) of the
# top absolutely; with retained modes cut at eval ~0.1 a single level is
# accurate (rel <~ 1e-3) whenever the batch's top whitened eigenvalue
# stays below this bound — above it the batch is re-solved deeper.
_SIG1_TOP_BOUND = 1.0

# Working (basis width, levels) of the top-band engine per pencil
# dimension, remembered across chunks/windows so the escalation ladder
# is paid once per shape, not once per dispatch.
_TB_STATE = {}

# Working Fisher mode-slice width (the static retained-mode cap of the
# fused product+Fisher kernel), remembered globally: the kernel clamps
# it to each chunk's pencil dimension, so one monotone value serves
# every shape while bounding recompiles to the escalation count.
_FISHER_K = [0]

# l-axis chunk depth of the fused Fisher's factor scan
# (mstep.fisher_step_split l_chunk).  Larger chunks raise the arithmetic
# intensity of the per-chunk einsums at the cost of bigger Y buffers.
# This env var is the only override; product_all_resident falls back to
# it when the caller leaves fisher_lchunk=None.
_FISHER_LCHUNK = int(os.environ.get("DRIFTSCAN_TPU_FISHER_LCHUNK", "64"))


# Starting subspace width of the top-band engine, as a fraction of the
# pencil dimension (k0 = n / frac).  The certificate escalation doubles
# k on incompleteness, but it cannot see *value* error inside a complete
# basis: at k = n/8 boundary-mode values have been seen 0.24 rel off
# while the certificate passed, and k = n/4 brings paired values to
# ~5e-7 of the exact engine at f64 Ritz.  The engine is off by default
# (``topband=False``) and has not been measured on a GPU.
_TB_START_FRAC = int(os.environ.get("DRIFTSCAN_TPU_TB_START_FRAC", "8"))


def _run_topband(run, mv, extra, nw, lsd, lfd, n_chunk, kl_cut, exact_levels):
    """One chunk through the top-band KL engine with escalation.

    Starts from the remembered (k, levels) for this pencil dimension
    (default n/8 columns, 5 levels); any m failing the completeness
    certificate redispatches the chunk with (2k, levels+1).  Past
    k = n/2 the filtered engine no longer wins over the exact eigh —
    fall back to it (``exact_levels=None`` keeps its adaptive default).

    Returns (evals, nmodes, fisher) — fisher is None unless the ``run``
    closure dispatches the fused product+Fisher kernel.
    """
    k, lv = _TB_STATE.get(
        n_chunk,
        (_quant_frac(max(n_chunk // _TB_START_FRAC, 8), n_chunk), 5),
    )
    while k <= n_chunk // 2:
        kw = dict(extra or {})
        kw.update(
            kl_cut=float(kl_cut),
            kl_top_k=int(min(k, n_chunk)),
            kl_levels=int(lv),
        )
        ev, nmo, okf, fish = run(mv, 1, kw, nw, lsd, lfd)
        if bool(np.asarray(okf).all()):
            _TB_STATE[n_chunk] = (k, lv)
            return np.asarray(ev), nmo, fish
        k, lv = 2 * k, lv + 1
    ev, nmo, _, fish = run(mv, exact_levels, extra, nw, lsd, lfd)
    return np.asarray(ev), nmo, fish


def _auto_mbatch(tel, budget_gb=4.0):
    """m-batch size bounding the product step's working set.

    Dominant per-m buffers (f32 in single-precision runs): the
    interleaved QR augmentation (2(K+n) x 2n), the whitened factor
    (2n x 2K) and a few (2n)^2 Gram/eigh temporaries; a ~3x allowance
    covers XLA's fusion copies.  ``budget_gb`` is a fixed sizing
    constant, not derived from the device's memory.
    """
    nl = tel.lmax + 1
    n = tel.nfreq * min(nl, 2 * tel.npairs) * tel.num_pol_sky
    K = nl * tel.num_pol_sky * tel.nfreq
    # K_aug=K: a tel-only estimate cannot see rank-compacted factors, so
    # it sizes the noise-side QR augmentation at the uncompacted width
    # (conservative); product_all_resident uses the true widths instead.
    return _auto_mbatch_n(n, K, budget_gb=budget_gb, cap=8, K_aug=K)


# Minimum dimension-reduction factor for a compacted chunk shape to be
# worth its own compiled variant.
_BUCKET_MIN_SAVING = 2


def _quant_frac(x: int, full: int) -> int:
    """Smallest power-of-two *fraction* of ``full`` that is >= x.

    Every distinct shape is a compile, so bucket sizes are quantised to
    {full, ~full/2, ~full/4, ...} — at most log2(full) compiled variants
    per axis, not full/gran.
    """
    x = max(int(x), 1)
    q = full
    while (q + 1) // 2 >= x:
        q = (q + 1) // 2
    return q


def _analytic_dof_bound(tel, nm, m_lo=0):
    """Host-side upper-profile of the per-m pencil dimension for the
    window ``[m_lo, m_lo + nm)``.

    Uses the per-(baseline, freq) band limits (teles.max_lm) to bound
    active rows; only used to decide whether the measured bucketing pass
    is worth its compile cost, never as a correctness cap.
    """
    nl = tel.lmax + 1
    S = min(nl, 2 * tel.npairs)
    bl = np.arange(tel.npairs)
    fi = np.arange(tel.nfreq)
    blg, fig = [x.ravel() for x in np.meshgrid(bl, fi, indexing="ij")]
    lmax_a, mmax_a = teles.max_lm(
        tel.baselines[blg], tel.wavelengths[fig], tel.u_width, tel.v_width
    )
    lmax_a = np.ceil(np.asarray(lmax_a) * tel.l_boost).reshape(
        tel.npairs, tel.nfreq
    )
    mmax_a = np.ceil(np.asarray(mmax_a) * tel.l_boost).reshape(
        tel.npairs, tel.nfreq
    )
    ms = (m_lo + np.arange(nm))[:, None, None]  # (nm, 1, 1)
    # rows with support at (m, f): pairs whose band reaches m (plus the
    # conjugate block), capped by the l-range and the padded mode count
    pair_rows = 2 * (mmax_a[None] >= ms).sum(axis=1)  # (nm, F)
    lrows = tel.num_pol_sky * np.maximum(
        lmax_a.max(axis=0)[None] + 1 - ms[:, :, 0], 0
    )
    return np.minimum(np.minimum(pair_rows, lrows), S).sum(axis=1)  # (nm,)


def _auto_mbatch_n(n: int, K: int, budget_gb=4.0, cap: int = 16, K_aug=None):
    """m-batch size for a pencil of dimension ``n`` (see _auto_mbatch).

    ``K`` sizes the whitened signal factor; ``K_aug`` (default ``K``)
    sizes the noise-side QR augmentation — with rank-compacted
    foreground factors (fpencil.factor_cl) the two differ by an order
    of magnitude.  The signal width is capped at ``n``: when the
    factored width exceeds 2n the product step re-factors it to an
    (n, n) Cholesky factor (fpencil.beam_factor_compact), so the wide
    factor never exists on device.
    """
    if K > 2 * n:
        K = n
    n2, k2 = 2 * n, 2 * K
    k2a = 2 * (K if K_aug is None else K_aug)
    per_m = ((k2a + n2) * n2 + n2 * k2 + 6 * n2 * n2) * 4.0 * 3.0
    budget = budget_gb * 2**30
    mb = int(max(1, min(cap, budget // max(per_m, 1.0))))
    return 1 << (mb.bit_length() - 1)  # power of two


def product_all_resident(
    tel, pos, neg, ls, lf, noisew, mbatch=None, max_m=None, mesh=None,
    sig_k_cap=0, sig_levels=None, bucket=None, m_range=None,
    topband=False, kl_cut=0.1,
    band_lt=None, ps_threshold=0.1, fisher_k=None, fisher_lchunk=None,
):
    """Run the SVD+KL product step over every m from resident BTMs.

    Fetches only the eigen-spectrum: returns (evals (nm, ndof), nmodes
    (nm, nfreq)) as host numpy.

    With a multi-device ``mesh`` the m batch of each dispatch is sharded
    over the mesh axis (the BTM tables are replicated) so every device
    solves its own m-modes — the multi-device scaling axis of the pipeline
    (SURVEY.md section 2.3).  Scale ``mbatch`` with the device count.

    ``sig_levels=None`` selects the depth *adaptively per batch*: each
    batch is first solved with a single whitened-signal Gram level (the
    eigh is ~85% of the step cost), and only batches whose top
    eigenvalue exceeds ``_SIG1_TOP_BOUND`` — where the retained range
    outruns one level's f32 resolution — are re-solved with the deeper
    default.  The host sees every spectrum anyway, so the check is free.

    ``sig_k_cap`` rank-caps the *signal-side* Gram levels (subspace
    iteration): measured exact to ~2e-3 — within the f32 engine's own
    noise band — because the whitened signal spectrum is concentrated.
    (Capping the foreground side is NOT safe; see fpencil.gram_bands_topk.)

    ``bucket`` (default on for single-device runs) first measures every
    m's true per-frequency mode counts with a cheap SVD-only pass, then
    dispatches each m-chunk with its frequency axis compacted to the
    *active* frequencies and the mode axis capped at the chunk's true
    maximum (shapes quantised to bound compile count).  At wide
    fractional bandwidth the per-freq band limit scales with frequency,
    so the high-m pencils are a fraction of ndofmax — and the KL cost is
    cubic in that dimension.  The reference gets the same effect from
    its per-m ragged arrays (drift/core/beamtransfer.py:760-818); this
    is the static-shape equivalent.

    ``m_range=(m0, m1)`` processes only that m-window from tables built
    with ``btm_resident(..., m_range=...)`` (uniform layout) — the
    device-memory streaming axis for band limits whose full tables exceed device
    memory.  Returns spectra for m in [m0, m1).

    ``topband=True`` replaces the whitened-signal eigendecomposition —
    the QDWH eigh that dominates the product step — with the matmul-only
    filtered top-band engine (fpencil.gram_topband): only eigenvalues
    >= ``kl_cut`` (the KL retention threshold this spectrum will be cut
    at) are computed, and the sub-cut tail is reported as exact zeros.
    Each chunk dispatch carries a per-m completeness certificate; on
    failure the chunk is redispatched with a doubled basis (and one
    more deflation level), falling back to the exact engine at
    basis width n/2.  The working (k, levels) is remembered per chunk
    shape across windows.

    ``band_lt`` (a factor table from :func:`mstep.band_factor_table`)
    additionally computes the quadratic-estimator Fisher matrix in the
    same fused dispatch — the Fisher phase of the pipeline
    (/root/reference/drift/core/psestimation.py:463-512) without the KL
    eigenvectors ever leaving the device.  ``ps_threshold`` is the
    estimator's KL retention cut (> 0); ``fisher_k`` the initial static
    retained-mode cap (auto-escalated ×2, remembered across windows,
    whenever a chunk's spectrum retains more modes).  The return gains a
    third element: the (nbands, nbands) complex Fisher summed over the
    window's m-modes.
    """
    if m_range is not None:
        m_lo, m_hi = int(m_range[0]), int(m_range[1])
    else:
        m_lo, m_hi = 0, tel.mmax + 1
    if max_m is not None:
        m_hi = min(m_hi, m_lo + max_m)
    nm = m_hi - m_lo
    m_static = np.int32(m_lo) if m_range is not None else None
    nl = tel.lmax + 1
    dt = pos.re.dtype
    F = tel.nfreq
    S = min(nl, 2 * tel.npairs)
    npol = tel.num_pol_sky
    # true pencil factor widths (rank-compacted factors shrink these)
    K_cov = nl * int(np.asarray(ls).shape[-1])
    K_aug = nl * int(np.asarray(lf).shape[-1])

    multi = mesh is not None and mesh.devices.size > 1
    if bucket is None:
        # Auto: only pay the sizing pass (and its compiles) when the
        # analytic per-m dof profile promises a real cubic-cost win —
        # e.g. wide fractional bandwidth, where high-m pencils hold a
        # fraction of the frequencies.
        if multi:
            bucket = False
        else:
            prof = _analytic_dof_bound(tel, nm, m_lo).astype(np.float64)
            n_full = float(F * S)
            bucket = float((prof**3).sum()) < 0.5 * nm * n_full**3
    elif bucket and multi:
        raise ValueError(
            "bucket=True is unsupported on a multi-device mesh: compacted "
            "chunk batch sizes are not device-divisible; use bucket=False "
            "(the auto default for meshes)"
        )

    noisew_h = np.asarray(noisew)
    ls_h = np.asarray(ls)
    lf_h = np.asarray(lf)
    noisew = jnp.asarray(noisew_h, dtype=dt)
    ls = jnp.asarray(ls_h, dtype=dt)
    lf = jnp.asarray(lf_h, dtype=dt)

    if mbatch is None:
        # true factor widths (the tel-only estimate can't see the
        # rank-compacted covariance factors)
        mbatch = _auto_mbatch_n(F * S, K_cov, K_aug=K_aug, cap=8)

    place_mv = jnp.asarray
    if multi:
        import jax.sharding as jsh

        if mbatch % mesh.devices.size:
            mbatch = ((mbatch // mesh.devices.size) + 1) * mesh.devices.size
        shard = jsh.NamedSharding(mesh, jsh.PartitionSpec(mesh.axis_names[0]))

        def place_mv(x):
            return jax.device_put(x, shard)

    adaptive = sig_levels is None

    fisher = band_lt is not None
    if fisher:
        if float(ps_threshold) <= 0:
            raise ValueError("ps_threshold must be > 0 for the Fisher pass")
        if fisher_lchunk is None:
            fisher_lchunk = _FISHER_LCHUNK
        fisher_lchunk = int(fisher_lchunk)
        # the fused kernel's factor scan needs l_chunk | nlp — snap down
        # to the largest divisor of the table's (padded) l axis
        nlp = int(np.asarray(band_lt).shape[1])
        if nlp % fisher_lchunk:
            fisher_lchunk = max(
                d for d in range(1, min(fisher_lchunk, nlp) + 1) if nlp % d == 0
            )
        band_dev = jnp.asarray(band_lt, dtype=dt)
        if _FISHER_K[0] == 0:
            _FISHER_K[0] = int(fisher_k) if fisher_k else max(
                32, _quant_frac(F * S // 8, F * S)
            )
        elif fisher_k:
            _FISHER_K[0] = max(_FISHER_K[0], int(fisher_k))

    def run(mv, levels, extra=None, nw=noisew, lsd=ls, lfd=lf):
        kwargs = {} if levels is None else {"sig_levels": levels}
        if extra:
            kwargs.update(extra)
        common = dict(
            npairs=tel.npairs,
            nfreq=kwargs.pop("nfreq", F),
            nl=nl,
            npol=npol,
            sig_k_cap=sig_k_cap,
            m_lo=m_static,
        )
        if not fisher:
            ev, nmo, okf = _spectrum_batch(
                pos.re, pos.im, neg.re, neg.im, nw, lsd, lfd,
                place_mv(mv), **common, **kwargs,
            )
            return ev, nmo, okf, None
        ev, nmo, okf, f_re, f_im = _fisher_batch(
            pos.re, pos.im, neg.re, neg.im, nw, lsd, lfd,
            place_mv(mv), band_dev,
            ps_threshold=float(ps_threshold),
            fisher_k=int(_FISHER_K[0]),
            fisher_lchunk=int(fisher_lchunk),
            **common, **kwargs,
        )
        return ev, nmo, okf, (f_re, f_im)

    # ---- sizing pass: true per-(m, freq) mode counts ----
    counts = None
    if bucket:
        cb = max(mbatch, 16)
        rows = []
        for s in range(0, nm, cb):
            ms = m_lo + np.arange(s, min(s + cb, nm))
            mv = np.full(cb, -1, np.int32)
            mv[: len(ms)] = ms
            c = _svdcount_batch(
                pos.re, pos.im, neg.re, neg.im, noisew, jnp.asarray(mv),
                npairs=tel.npairs, nfreq=F, nl=nl, npol=npol, m_lo=m_static,
            )
            rows.append(np.asarray(c)[: len(ms)])
        counts = np.concatenate(rows)  # (nm, F) int, row i <-> m_lo + i

    evals, nmodes = [], []
    fish_total = (
        np.zeros((np.asarray(band_lt).shape[0],) * 2, np.complex128)
        if fisher
        else None
    )
    s = 0
    while s < nm:
        if counts is not None:
            # chunk size from the chunk-head dimension (recomputed below)
            cap0 = int(counts[s].max())
            act0 = int((counts[s] > 0).sum())
            sq = _quant_frac(cap0, S)
            fq = _quant_frac(act0, F)
            mb = _auto_mbatch_n(fq * sq, K_cov, K_aug=K_aug)
            ms = m_lo + np.arange(s, min(s + mb, nm))
            # the chunk's true requirements (head m has the largest
            # support, but quantisation can still be exceeded mid-chunk)
            cc = counts[ms - m_lo]
            sq = _quant_frac(int(cc.max()), S)
            act = np.nonzero(cc.max(axis=0) > 0)[0]
            fq = _quant_frac(max(len(act), 1), F)
            # compaction below ~_BUCKET_MIN_SAVING x dimension saves less
            # than the extra compiled-variant costs: run full-size
            if fq * sq * _BUCKET_MIN_SAVING > F * S:
                fq, sq = F, S
            if fq >= F and sq >= S:
                fq, sq = F, S
                mb = mbatch  # reuse the standard full-size program
                ms = m_lo + np.arange(s, min(s + mb, nm))
                extra = None
                nw, lsd, lfd = noisew, ls, lf
            else:
                # never grow the chunk past what the caps were measured
                # on; shrink if the final dimension needs a smaller batch
                mb2 = min(mb, _auto_mbatch_n(fq * sq, K_cov, K_aug=K_aug))
                if mb2 < mb:
                    mb = mb2
                    ms = ms[:mb]
                f_idx = np.full(fq, act[-1] if len(act) else 0, np.int32)
                f_idx[: len(act)] = act
                fmask = np.zeros(fq, dtype=np.asarray(noisew_h).dtype)
                fmask[: len(act)] = 1.0
                extra = {
                    "nfreq": fq,
                    "s_cap": int(sq),
                    "nfreq_full": F,
                    "f_idx": jnp.asarray(f_idx),
                    "fmask": jnp.asarray(fmask, dtype=dt),
                }
                nw = jnp.asarray(noisew_h[f_idx], dtype=dt)
                lsd = jnp.asarray(ls_h[:, :, f_idx], dtype=dt)
                lfd = jnp.asarray(lf_h[:, :, f_idx], dtype=dt)
        else:
            mb = mbatch
            ms = m_lo + np.arange(s, min(s + mb, nm))
            extra = None
            nw, lsd, lfd = noisew, ls, lf
            fq, sq = F, S

        mv = np.full(mb, -1, np.int32)
        mv[: len(ms)] = ms
        while True:
            if topband:
                ev, nmo, fish = _run_topband(
                    run, mv, extra, nw, lsd, lfd, fq * sq, kl_cut,
                    None if adaptive else sig_levels,
                )
            else:
                ev, nmo, _, fish = run(
                    mv, 1 if adaptive else sig_levels, extra, nw, lsd, lfd
                )
                ev = np.asarray(ev)
                if adaptive and ev.max() > _SIG1_TOP_BOUND:
                    ev, nmo, _, fish = run(mv, None, extra, nw, lsd, lfd)
                    ev = np.asarray(ev)
            if not fisher:
                break
            # the kernel's mode slice is static: if any m retained more
            # modes than it, escalate (remembered) and redo the chunk
            retained = int(
                (np.asarray(ev)[: len(ms)] > ps_threshold).sum(axis=1).max()
            )
            if retained <= min(_FISHER_K[0], fq * sq) or _FISHER_K[0] >= fq * sq:
                break
            _FISHER_K[0] = 2 * _FISHER_K[0]
        if fisher:
            f_re, f_im = fish
            fish_total += (
                np.asarray(f_re)[: len(ms)].sum(axis=0)
                + 1j * np.asarray(f_im)[: len(ms)].sum(axis=0)
            )
        ev = ev[: len(ms)]
        nmo = np.asarray(nmo)[: len(ms)]

        if counts is not None and (fq < F or sq < S):
            # pad the compacted spectra back to the global layout: the
            # full-size program emits the same eigenvalues plus extra
            # exact zeros, which sort to the front (ascending, >= 0)
            ev = np.pad(ev, ((0, 0), (F * S - ev.shape[1], 0)))
            nm_full = np.zeros((len(ms), F), dtype=nmo.dtype)
            nm_full[:, f_idx[: len(act)]] = nmo[:, : len(act)]
            nmo = nm_full

        evals.append(ev)
        nmodes.append(nmo)
        s += mb
    if fisher:
        return np.concatenate(evals), np.concatenate(nmodes), fish_total
    return np.concatenate(evals), np.concatenate(nmodes)
