"""The batched, mesh-sharded per-m product step.

This is the device performance path for the pipeline core: one jitted
program that takes a *batch of m-modes* of beam transfer matrices and
produces the SVD compression and the KL filter for every one of them —
the work the reference distributes as a per-m loop over MPI ranks
(/root/reference/drift/core/beamtransfer.py:678-929 and
/root/reference/drift/core/kltransform.py:310-355).

Shapes are fully padded (masks instead of data-dependent rank cuts), so
the batch vmaps on one device and shards over a ``Mesh`` along the m
axis with pjit — XLA inserts any collectives.

The KL stage works on *factored* covariances (ops.fpencil): the sky
covariance blocks are Cholesky-factored once on the host
(:func:`prepare_cl_factors`) and every m-mode projects the factor, never
the dense ill-conditioned matrix — the key to f32 numerical safety
(see ops/fpencil.py module docstring).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import fpencil, linalg, zarray as za


def prepare_cl_factors(cl_signal, cl_noise, out_dtype=np.float32):
    """Host-side, once per run: factor the per-l sky covariance blocks.

    cl_signal, cl_noise : (npol, npol, nl, F, F) real arrays.
    Returns (ls, lf) factor tables of shape (nl, npol, F, npol*F) for
    :func:`kl_product_step_split`.
    """
    return (
        fpencil.factor_cl(cl_signal, out_dtype=out_dtype),
        fpencil.factor_cl(cl_noise, out_dtype=out_dtype),
    )


class ProductStepResult(NamedTuple):
    """Per-m outputs of the batched product step (all padded)."""

    ut: jnp.ndarray  # (M, F, S, T) telescope -> SVD basis
    beam_svd: jnp.ndarray  # (M, F, S, P*L) sky -> SVD basis
    sig: jnp.ndarray  # (M, F, S) singular values
    nmodes: jnp.ndarray  # (M, F) retained mode counts
    evals: jnp.ndarray  # (M, F*S) KL eigenvalues (ascending, 0-padded)
    evecs: jnp.ndarray  # (M, F*S, F*S) KL modes (rows)
    # per-m completeness certificate of the top-band KL engine (always
    # True on the exact path) — see ProductStepResultSplit.klok
    klok: jnp.ndarray


class ProductStepResultSplit(NamedTuple):
    """Split-complex per-m outputs (re/im planes)."""

    ut_re: jnp.ndarray
    ut_im: jnp.ndarray
    beam_re: jnp.ndarray
    beam_im: jnp.ndarray
    sig: jnp.ndarray
    nmodes: jnp.ndarray
    evals: jnp.ndarray
    evecs_re: jnp.ndarray
    evecs_im: jnp.ndarray
    # per-m completeness certificate of the top-band KL engine: True
    # unless kl_top_k was set and the m's retained band overflowed the
    # basis / level budget (fpencil.gram_topband) — redispatch those m's
    # with a larger budget or the exact engine.
    klok: jnp.ndarray


def kl_product_step_split(
    beam_re,
    beam_im,
    noisew,
    ls,
    lf,
    m_values,
    npol: int,
    nl: int,
    polsvcut: float = 1e-4,
    svcut: float = 1e-6,
    with_thermal: bool = True,
    fg_levels: int = 8,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    method: str = "qr",
    s_cap: int = 0,
    compact_signal: bool | None = None,
    kl_cut: float = 0.0,
    kl_top_k: int = 0,
    kl_levels: int = 5,
) -> ProductStepResultSplit:
    """SVD-compress and KL-filter a batch of m-modes in one jitted program.

    Parameters
    ----------
    beam_re, beam_im : (M, F, T, npol*nl) real
        Beam transfer matrix batch (m-major), split planes.
    noisew : (F, T) float
        Inverse noise weights (noisepower^-1/2) per frequency.  The KL
        noise model relies on the beams being noise-prewhitened: the
        projected radiometer noise is then exactly the identity in the
        SVD basis.
    ls, lf : (nl, npol, F, npol*F)
        Signal and foreground covariance factors
        (:func:`prepare_cl_factors`).
    m_values : (M,) int
        The m of each batch element; elements with m < 0 are padding and
        produce zero outputs.
    with_thermal
        False solves the foreground-only pencil (DoubleKL stage 1).
    s_cap
        If > 0, keep only the top ``s_cap`` SVD modes per frequency in
        the KL stage (the caller guarantees every m in the batch has at
        most that many non-zero modes — see resident.product m-bucketing).
        The KL pencil then has dimension F * s_cap instead of
        F * svd_len; since its cost is cubic, this is where the high-m
        tail's shrinking rank pays off.  The SVD outputs (ut, beam, sig)
        stay full-size.
    kl_cut, kl_top_k, kl_levels
        ``kl_top_k > 0`` switches the whitened-signal eigensolver to the
        matmul-only top-band engine (:func:`fpencil.kl_solve_qr_topband`;
        requires ``method='qr'``/``with_thermal``): only the modes with
        eigenvalue >= ``kl_cut`` (the caller's KL retention threshold)
        are computed, in ``kl_levels`` two-decade deflation levels of a
        ``kl_top_k``-column filtered basis; everything below the cut is
        reported as exact zeros.  The per-m ``klok`` output certifies
        completeness — the dispatcher must redispatch failed m's.
    """
    dt_r = beam_re.dtype
    noisew = noisew.astype(dt_r)
    ls = jnp.asarray(ls, dtype=dt_r)
    lf = jnp.asarray(lf, dtype=dt_r)

    def one_m(bm_re, bm_im, mval):
        F = bm_re.shape[0]

        # The beam is only sensitive to l >= m (compact l >= m storage in
        # the reference): mask, then noise-prewhiten.
        lmask = (jnp.arange(nl) >= mval).astype(dt_r)
        tile = jnp.tile(lmask, npol)[None, None, :]
        w = noisew[:, :, None]
        bw_re = bm_re * tile * w
        bw_im = bm_im * tile * w

        # --- SVD compression (batched over frequency) ---
        ut_re, ut_im, bs_re, bs_im, sig, nmodes = linalg.triple_svd_split_batched(
            bw_re, bw_im, npol=npol, nl=nl, polsvcut=polsvcut
        )
        S = ut_re.shape[1]

        # Global svcut relative to this m's top singular value.
        svmask = (sig > sig.max() * svcut).astype(dt_r)
        ut = za.Z(ut_re * svmask[:, :, None], ut_im * svmask[:, :, None])
        bsvd = za.Z(bs_re * svmask[:, :, None], bs_im * svmask[:, :, None])
        # nmodes must count what actually survives in ut/beam_svd: the
        # per-frequency gram floor AND the global svcut.  sig is sorted
        # descending per frequency, so the svcut mask is a prefix and
        # min() composes the two counts exactly.
        nmodes = jnp.minimum(
            nmodes, jnp.sum(svmask, axis=-1).astype(nmodes.dtype)
        )

        # --- factored covariance projection + KL pencil ---
        if s_cap and s_cap < S:
            # modes are sorted by singular value per frequency, so the
            # top-s_cap slice keeps every non-zero mode (caller contract)
            bkl = za.Z(bsvd.re[:, :s_cap], bsvd.im[:, :s_cap])
            S_kl = s_cap
        else:
            bkl = bsvd
            S_kl = S
        b4 = bkl.reshape(F, S_kl, npol, nl)
        n_kl = F * S_kl
        # Re-factor the signal side to width n when the factored form is
        # wider (production scale: (n, nl*K) ~ (2048, 258k)): rank(S) <= n
        # makes the (n, n) Cholesky factor exact up to formation rounding,
        # and every pencil stage downstream is O(n^2 * width).  The
        # foreground must stay truly factored (14-decade spectrum).
        do_compact = compact_signal
        if do_compact is None:
            do_compact = method == "qr" and nl * ls.shape[-1] > 2 * n_kl
        if do_compact:
            a_s = fpencil.beam_factor_compact(b4, ls)
        else:
            a_s = fpencil.beam_factor(b4, ls)
        a_f = fpencil.beam_factor(b4, lf)
        if kl_top_k:
            if method != "qr" or not with_thermal:
                raise ValueError(
                    "kl_top_k requires method='qr' with_thermal=True"
                )
            kl, klok = fpencil.kl_solve_qr_topband(
                a_s, a_f, cut=kl_cut, k=kl_top_k, levels=kl_levels
            )
        else:
            kl = fpencil.kl_solve(
                a_s,
                a_f,
                with_thermal=with_thermal,
                fg_levels=fg_levels,
                sig_levels=sig_levels,
                band_rel=band_rel,
                fg_k_cap=fg_k_cap,
                sig_k_cap=sig_k_cap,
                method=method,
            )
            klok = jnp.asarray(True)
        evecs = kl.evecs.conj().transpose(1, 0)  # rows are KL modes

        keep = 1.0 - (mval < 0).astype(dt_r)
        return (
            ut.re * keep,
            ut.im * keep,
            bsvd.re * keep,
            bsvd.im * keep,
            sig * keep,
            (nmodes * (mval >= 0)).astype(jnp.int32),
            kl.evals * keep,
            evecs.re * keep,
            evecs.im * keep,
            klok | (mval < 0),  # padding m's never block a dispatch
        )

    out = jax.vmap(one_m)(beam_re, beam_im, m_values)
    return ProductStepResultSplit(*out)


def kl_product_step(
    beam,
    noisew,
    ls,
    lf,
    m_values,
    npol: int,
    nl: int,
    **kwargs,
) -> ProductStepResult:
    """Native-complex wrapper: splits the beam and re-assembles outputs.

    The compute is the split-complex implementation in both cases — one
    algorithm, one numerical behaviour on every backend.
    """
    beam = jnp.asarray(beam)
    r = kl_product_step_split(
        jnp.real(beam),
        jnp.imag(beam),
        noisew,
        ls,
        lf,
        m_values,
        npol=npol,
        nl=nl,
        **kwargs,
    )
    dt_c = jnp.complex128 if r.sig.dtype == jnp.float64 else jnp.complex64
    mk = lambda re, im: re.astype(dt_c) + 1j * im.astype(dt_c)
    return ProductStepResult(
        ut=mk(r.ut_re, r.ut_im),
        beam_svd=mk(r.beam_re, r.beam_im),
        sig=r.sig,
        nmodes=r.nmodes,
        evals=r.evals,
        evecs=mk(r.evecs_re, r.evecs_im),
        klok=r.klok,
    )


def _shardings(mesh):
    ax = mesh.axis_names[0]
    shard = NamedSharding(mesh, P(ax))
    repl = NamedSharding(mesh, P())
    return shard, repl


def jit_product_step_split(npol: int, nl: int, mesh=None, **kwargs):
    """jit (and optionally mesh-shard over m) the split product step.

    With a mesh, the beam batch, m values and all outputs are sharded
    along the leading m axis; the small factor tables are replicated.
    """
    fn = functools.partial(kl_product_step_split, npol=npol, nl=nl, **kwargs)
    if mesh is None:
        return jax.jit(fn)
    shard, repl = _shardings(mesh)
    return jax.jit(
        fn,
        in_shardings=(shard, shard, repl, repl, repl, shard),
        out_shardings=ProductStepResultSplit(*([shard] * 10)),
    )


def jit_product_step(npol: int, nl: int, mesh=None, **kwargs):
    """jit (and optionally mesh-shard over m) the native-complex wrapper."""
    fn = functools.partial(kl_product_step, npol=npol, nl=nl, **kwargs)
    if mesh is None:
        return jax.jit(fn)
    shard, repl = _shardings(mesh)
    return jax.jit(
        fn,
        in_shardings=(shard, repl, repl, repl, shard),
        out_shardings=ProductStepResult(
            ut=shard, beam_svd=shard, sig=shard, nmodes=shard, evals=shard,
            evecs=shard, klok=shard,
        ),
    )


def band_factor_table(clbands, out_dtype=np.float32, l_chunk=64,
                      rank_rtol=1e-15):
    """Host-side, once per run: factor each band's temperature C_l.

    The quadratic-estimator Fisher needs every band's angular power
    spectrum projected into the KL basis.  Keeping the band covariances
    *factored* (C_a,l = L_a,l L_a,l^H per multipole, rank-compacted) lets
    the device accumulate the projected covariance C_a = (G L_a)(G L_a)^H
    over l-chunks without ever forming the dense ill-conditioned blocks —
    the same design as the KL pencil factors (ops/fpencil.py).

    Parameters
    ----------
    clbands : iterable of (nl, F, F) real arrays
        Per-band angular spectra (rows of ``PSEstimation.clarray``); an
        iterable so callers can stream bands at production scale instead
        of materialising the full (nbands, nl, F, F) array.
    l_chunk
        The device kernel's l-chunk length; the l axis is zero-padded to
        a multiple of it.
    rank_rtol
        Per-block relative eigenvalue cut for the rank compaction
        (``fpencil.factor_cl``).  Unlike the KL pencil factors — whose
        near-floor eigenvalues are sensitive to absolute covariance
        perturbations — the Fisher depends on the band covariances only
        through retained-mode traces, so a relative cut of ``eps`` biases
        F_ab by O(eps): cuts up to ~1e-6 are safely inside the 3e-2
        Fisher tier and directly shrink the table's device footprint.

    Returns
    -------
    band_lt : (nbands, nlp, F, Kmax) real array
        Factor table for :func:`fisher_step_split`; per-band widths are
        zero-padded to the largest rank-compacted width.
    """
    facs = []
    for c in clbands:
        c = np.asarray(c, dtype=np.float64)
        # (1, 1, nl, F, F) -> (nl, 1, F, K): temperature-only band block
        facs.append(
            fpencil.factor_cl(
                c[None, None], out_dtype=out_dtype, rank_rtol=rank_rtol
            )[:, 0]
        )
    if not facs:
        raise ValueError("no bands given")
    kmax = max(f.shape[-1] for f in facs)
    nl, F = facs[0].shape[0], facs[0].shape[1]
    nlp = ((nl + l_chunk - 1) // l_chunk) * l_chunk
    out = np.zeros((len(facs), nlp, F, kmax), dtype=out_dtype)
    for bi, f in enumerate(facs):
        out[bi, :nl, :, : f.shape[-1]] = f
    return out


# Matmul precision of the Fisher contraction einsums.  The Fisher tier
# is rel 3e-2 (BASELINE.md) and the contraction is a plain quadratic
# form — no deflation, no cancellation across decades — so a tier with
# eps ~ 5e-7 per pass (f32 accumulation across l-chunks) would sit far
# inside it.  None inherits the global default ("highest"); module state
# read at trace time, like the topband filter switch
# (fpencil._FILTER_PRECISION).
_FISHER_PRECISION = os.environ.get("DRIFTSCAN_TPU_FISHER_PRECISION") or None


def fisher_step_split(
    evals,
    evecs_re,
    evecs_im,
    beam_re,
    beam_im,
    band_lt,
    ps_threshold: float,
    fisher_k: int,
    npol: int,
    nl: int,
    s_cap: int = 0,
    l_chunk: int = 64,
    f_idx=None,
):
    """Per-m Fisher matrices from the product step's KL modes, on device.

    F_ab[m] = sum_ij w_i w_j C_a[i, j] C_b[j, i] with inverse-covariance
    weights w = 1/(1 + lambda) over the KL modes retained at
    ``ps_threshold`` — the reference's exact quadratic-estimator Fisher
    (/root/reference/drift/core/psestimation.py:775-815), restructured so
    the band covariances stay factored: C_a = (G L_a)(G L_a)^H
    accumulated over l-chunks, where G is the retained KL modes rotated
    to the temperature sky basis (the file path's
    ``psestimation._sky_modes_t``) and L_a the per-l band factors
    (:func:`band_factor_table`).  Everything is matmuls.

    Parameters
    ----------
    evals, evecs_re, evecs_im
        The product step's KL outputs: (M, n) eigenvalues ascending with
        exact zeros padding the *front*, and (M, n, n) eigenvector planes
        with rows = modes aligned to the eigenvalues — so the retained
        modes are the trailing ``fisher_k`` rows, a contiguous slice (no
        gather).  The caller must verify (on host, from the fetched
        spectra) that no m retains more than ``fisher_k`` modes.
    beam_re, beam_im : (M, F, S, npol*nl)
        The product step's sky->SVD beams (modes sorted per frequency, so
        the top-``s_cap`` slice matches the KL pencil's compaction).
    band_lt : (nbands, nlp, F, K) real
        Band factor table; ``nlp`` a multiple of ``l_chunk``.
    ps_threshold
        KL retention threshold for the estimator (must be > 0: padded
        batch slots carry exact-zero eigenvalues and must drop out).
    f_idx : (F_compact,) int, optional
        Compacted-frequency gather indices (the resident dispatcher's
        bucketing); applied to the band table on device.  Padding slots
        need no mask: their beams are zeroed upstream, so G vanishes
        there and the duplicated factor rows multiply zero.

    Returns
    -------
    (fisher_re, fisher_im) : (M, nbands, nbands)
        Per-m Fisher matrices; sum over m on the host.  Padded m slots
        (all-zero eigenvalues) contribute exact zeros.
    """
    if ps_threshold <= 0:
        raise ValueError("ps_threshold must be > 0 (padding-slot contract)")
    dt = beam_re.dtype
    band_lt = jnp.asarray(band_lt, dtype=dt)
    if f_idx is not None:
        band_lt = jnp.take(band_lt, f_idx, axis=2)
    nbands, nlp = band_lt.shape[0], band_lt.shape[1]
    if nlp % l_chunk:
        raise ValueError("band_lt l axis must be a multiple of l_chunk")
    nchunk = nlp // l_chunk

    def one_m(ev, v_re, v_im, bm_re, bm_im):
        F, S = bm_re.shape[0], bm_re.shape[1]
        s_kl = s_cap if (s_cap and s_cap < S) else S
        n = ev.shape[0]
        kf = min(fisher_k, n)
        ev_k = ev[n - kf :]
        w = jnp.where(
            ev_k > ps_threshold, 1.0 / (1.0 + ev_k), jnp.zeros((), dt)
        ).astype(dt)
        v3 = za.Z(
            v_re[n - kf :].reshape(kf, F, s_kl),
            v_im[n - kf :].reshape(kf, F, s_kl),
        )
        # temperature rows of the sky->SVD beam, zero-padded to nlp
        pad = ((0, 0), (0, 0), (0, nlp - nl))
        bt = za.Z(
            jnp.pad(bm_re[:, :s_kl].reshape(F, s_kl, npol, nl)[:, :, 0], pad),
            jnp.pad(bm_im[:, :s_kl].reshape(F, s_kl, npol, nl)[:, :, 0], pad),
        )

        prec = _FISHER_PRECISION
        ein = functools.partial(jnp.einsum, precision=prec)

        def body(carry, i):
            c_re, c_im = carry
            l0 = i * l_chunk
            bc = za.Z(
                jax.lax.dynamic_slice_in_dim(bt.re, l0, l_chunk, axis=2),
                jax.lax.dynamic_slice_in_dim(bt.im, l0, l_chunk, axis=2),
            )
            lt = jax.lax.dynamic_slice_in_dim(band_lt, l0, l_chunk, axis=1)
            # G[k, f, l] = sum_s V[k, f, s] B[f, s, l] — file-layout rows,
            # no extra conjugation (matches psestimation._sky_modes_t)
            g_re = ein("kfs,fsl->kfl", v3.re, bc.re) - ein(
                "kfs,fsl->kfl", v3.im, bc.im
            )
            g_im = ein("kfs,fsl->kfl", v3.re, bc.im) + ein(
                "kfs,fsl->kfl", v3.im, bc.re
            )
            # Y[b, l, k, K] = sum_f G[k, f, l] L_b[l, f, K] (L real)
            y_re = ein("kfl,blfK->blkK", g_re, lt)
            y_im = ein("kfl,blfK->blkK", g_im, lt)
            # C_b += Y Y^H, summing the (l, K) factor axes
            c_re = (
                c_re
                + ein("blkK,blqK->bkq", y_re, y_re)
                + ein("blkK,blqK->bkq", y_im, y_im)
            )
            c_im = (
                c_im
                + ein("blkK,blqK->bkq", y_im, y_re)
                - ein("blkK,blqK->bkq", y_re, y_im)
            )
            return (c_re, c_im), None

        zero = jnp.zeros((nbands, kf, kf), dt)
        (c_re, c_im), _ = jax.lax.scan(body, (zero, zero), jnp.arange(nchunk))
        # F_ab = sum_ij (w_i C_a[i,j] w_j) conj(C_b[i,j])  (C_b Hermitian)
        d_re = (c_re * w[None, :, None] * w[None, None, :]).reshape(nbands, -1)
        d_im = (c_im * w[None, :, None] * w[None, None, :]).reshape(nbands, -1)
        cb_re = c_re.reshape(nbands, -1)
        cb_im = c_im.reshape(nbands, -1)
        f_re = d_re @ cb_re.T + d_im @ cb_im.T
        f_im = d_im @ cb_re.T - d_re @ cb_im.T
        return f_re, f_im

    return jax.vmap(one_m)(evals, evecs_re, evecs_im, beam_re, beam_im)


def btm_forward_step(alm, beam):
    """The m-mode forward model: sky alm -> visibilities for a batch of m.

    v[m, f, t] = sum_s beam[m, f, t, s] alm[m, f, s]

    This is the inner projection of timestream simulation
    (/root/reference/drift/pipeline/timestream.py:741-742), batched.
    """
    return jnp.einsum("mfts,mfs->mft", beam, alm)
