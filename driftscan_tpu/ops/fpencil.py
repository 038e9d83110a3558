"""Factored-covariance KL pencil solver (split-complex, f32-safe).

The KL stage solves the generalised Hermitian problem

    S v = w N v,   S = signal covariance,  N = noise + foreground covariance

projected into the SVD basis (reference: /root/reference/drift/core/
kltransform.py:258-355).  The foreground covariance spans ~14 decades, so
*forming* the dense projected matrices and eigendecomposing them in f32
destroys the small eigenvalues (absolute eigh error ~ n*eps*||N||), and
near-zero/negative roundoff eigenvalues turn the whitening into inf/NaN.

This module never forms the ill-conditioned dense covariances.  Instead:

* each per-l sky covariance block C_l is Cholesky-factored **once on the
  host in f64** (shared by every m) — ``factor_cl``;
* per m, the projected covariance factor ``A = B_svd @ L`` is built by one
  einsum — its entries span only *half* the decades of the covariance
  (``sqrt``), so f32 carries them comfortably — ``beam_factor``;
* the eigen-spectrum of ``A A^H`` is recovered over the full dynamic range
  by **multi-level Gram deflation** (``gram_bands``): each Gram
  eigendecomposition resolves ~sqrt(eps) of its own top; deflating the
  converged band and re-Gramming the remainder recovers the next decades.
  All heavy ops are (n x K)(K x n) matmuls plus small eighs;
* the noise whitening uses the *identity-plus-low-rank* structure
  ``N = I + A_f A_f^H`` (the radiometer noise projects to exactly the
  identity because the beams are noise-prewhitened):
  ``W = N^(-1/2) = I - Q diag(1 - 1/sqrt(1+s^2)) Q^H`` — no inversion of
  an ill-conditioned matrix anywhere.

Everything is jit/vmap-compatible with static shapes and works on
real (re, im) planes via the split-complex ``Z`` representation.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import zarray as za


# ------------------------------------------------------------------
# Host-side: factor the per-l sky covariance blocks (f64, once per run)
# ------------------------------------------------------------------


def factor_cl(cl, out_dtype=np.float32, compact_rank=True, rank_rtol=1e-15):
    """Factor per-l sky covariance blocks: C_l = L_l L_l^H (host, f64).

    Parameters
    ----------
    cl : (npol, npol, nl, F, F) real array
        Angular covariance blocks C_l[p, q, f, g] (as produced by
        skymodel.foreground_model / im21cm_model).
    out_dtype
        dtype of the returned factor (factor entries span only half the
        decades of the covariance, so f32 is adequate for f32 pipelines).
    compact_rank
        Spectrally smooth covariances (foregrounds: the whole premise of
        KL foreground removal) have tiny per-(l, pol) numerical
        frequency rank r even at hundreds of frequencies.  When the
        worst block's rank is below F/2, factor by per-block f64 eigh
        truncated at ``rank_rtol * w_max(l, pol)`` instead of Cholesky:
        the downstream pencil width — and with it the memory and the
        per-round CholeskyQR cost of the noise whitening, both linear in
        the factor width — shrinks by F/r (measured 768 -> 24 columns
        for the standard foreground model at 256 frequencies).
        Full-rank covariances (the 21 cm signal, which decorrelates
        rapidly in frequency) fall back to the Cholesky path
        automatically.
    rank_rtol
        Relative eigenvalue cut (vs the per-block maximum) for
        ``compact_rank``.  The default sits at f64 eigh resolution:
        KL pencil eigenvalues are sensitive to *absolute* covariance
        perturbations at the thermal floor — many decades below the
        foreground maximum — so the cut must discard only what the f64
        input rounding already corrupts (a per-l-max-relative 1e-12 cut
        measurably biases near-floor KL eigenvalues by ~1%).

    Returns
    -------
    L : (nl, npol, F, K) array such that
        C_l[p,q,f,g] = sum_k L[l,p,f,k] L[l,q,g,k].
        For pol-block-diagonal covariances (every standard sky model) the
        zero columns are compacted away: K = n_active_pols * F (or
        n_active_pols * r_max when rank compaction wins), which directly
        shrinks the pencil's factor width downstream.
    """
    in_eps = np.finfo(np.asarray(cl).dtype).eps
    # The rank floor can't sit below the input's own rounding noise: an
    # f32-cast covariance has eigenvalue noise ~sqrt(F)*eps32*w_max, so
    # a 1e-15 cut correctly measures full rank there and compaction
    # falls back to Cholesky (callers wanting compaction must supply
    # f64 covariances — see bench._covariances).
    rank_rtol = max(rank_rtol, 8.0 * float(in_eps))
    cl = np.asarray(cl, dtype=np.float64)
    npol, _, nl, F, _ = cl.shape

    def _block_sqrt(b):
        """(nl, F, F) PSD blocks -> (nl, F, F) factors, Cholesky-first."""
        b = 0.5 * (b + b.transpose(0, 2, 1))
        d = np.einsum("lii->li", b).max(axis=1)
        ok = d > 0
        out = np.zeros_like(b)
        if not ok.any():
            return out
        jit = 1e-12 * d[ok]
        n = b.shape[-1]
        try:
            out[ok] = np.linalg.cholesky(b[ok] + jit[:, None, None] * np.eye(n))
        except np.linalg.LinAlgError:
            # semi-definite numerics: eigh square root (slower, exactly
            # the old behaviour)
            w, q = np.linalg.eigh(b[ok])
            w = np.maximum(w, 0.0)
            out[ok] = q * np.sqrt(w)[:, None, :]
        return out

    # Pol-block-diagonal fast path (standard sky models have no pol
    # cross-covariances): per-pol (nl, F, F) Cholesky on the contiguous
    # diagonal blocks — no 5-axis transpose of the full array, which at
    # 256 freqs x lmax 1000 is a 17 GB strided copy costing ~5 minutes
    # on a single-core host.
    cross = any(
        np.any(cl[p, q])
        for p in range(npol)
        for q in range(npol)
        if p != q
    )
    if not cross:
        active_pols = [p for p in range(npol) if np.any(cl[p, p])]

        if compact_rank and active_pols:
            # Measure the numerical frequency rank per (l, pol) block.
            facs, ranks = [], []
            for p in active_pols:
                b = 0.5 * (cl[p, p] + cl[p, p].transpose(0, 2, 1))
                w, q = np.linalg.eigh(b)  # ascending
                wmax = np.maximum(w[:, -1:], 0.0)
                keep = w > rank_rtol * wmax + 1e-300
                ranks.append(int(keep.sum(axis=1).max()))
                facs.append((w, q, keep))
            r_max = max(ranks)
            if r_max <= F // 2:
                # quantise to a power of two: the factor width is a
                # compiled-shape axis downstream
                r_q = 1 << (max(r_max, 1) - 1).bit_length()
                K = len(active_pols) * r_q
                L = np.zeros((nl, npol, F, K))
                for i, (p, (w, q, keep)) in enumerate(zip(active_pols, facs)):
                    # top-r_q eigenpairs are the last r_q columns (w asc)
                    wt = np.where(keep, np.maximum(w, 0.0), 0.0)[:, -r_q:]
                    qt = q[:, :, -r_q:]
                    L[:, p, :, i * r_q : (i + 1) * r_q] = qt * np.sqrt(wt)[
                        :, None, :
                    ]
                return np.ascontiguousarray(L.astype(out_dtype))

        K = max(len(active_pols), 1) * F
        L = np.zeros((nl, npol, F, K))
        for i, p in enumerate(active_pols):
            L[:, p, :, i * F : (i + 1) * F] = _block_sqrt(cl[p, p])
        return np.ascontiguousarray(L.astype(out_dtype))

    # General (pol-coupled) path: dense (npol F)^2 blocks
    npf = npol * F
    m = cl.transpose(2, 0, 3, 1, 4).reshape(nl, npf, npf)
    L = _block_sqrt(m)
    return np.ascontiguousarray(L.reshape(nl, npol, F, npf).astype(out_dtype))


# ------------------------------------------------------------------
# Device-side: project a factor through the SVD beam
# ------------------------------------------------------------------


# Lowering for :func:`beam_factor`.  The einsum "fapl,lpfk->falk" has
# BOTH f and l as diagonal (shared, non-contracted) indices, which XLA
# lowers as a (f*l)-batched (S, p)(p, K) matmul — p is 1 or 4, a tiny
# contraction depth for a matmul unit.  "bcast" lowers it as p broadcast
# multiply-accumulates over the (F, S, nl, K) output — plain
# memory-bandwidth work.  Env-overridable; which is faster on a GPU has
# not been measured.
_BEAM_FACTOR_IMPL = os.environ.get("DRIFTSCAN_TPU_BEAM_FACTOR_IMPL", "einsum")


def _beam_factor_bcast_plane(plane: jnp.ndarray, lt: jnp.ndarray) -> jnp.ndarray:
    """One real plane of the broadcast lowering; lt is (npol, F, nl, K)."""
    npol = lt.shape[0]
    out = plane[:, :, 0, :, None] * lt[0][:, None, :, :]
    for p in range(1, npol):
        out = out + plane[:, :, p, :, None] * lt[p][:, None, :, :]
    return out


def beam_factor(bsvd: za.Z, L) -> za.Z:
    """Projected covariance factor A = B_svd L, in factored (tall) form.

    bsvd : Z with planes (F, S, npol, nl) — the sky->SVD projection.
    L : (nl, npol, F, K) real — output of :func:`factor_cl`.

    Returns Z with planes (F*S, nl*K):
    A[(f a), (l k)] = sum_p bsvd[f,a,p,l] * L[l,p,f,k].
    """
    F, S = bsvd.re.shape[0], bsvd.re.shape[1]
    K = L.shape[-1]
    nl = L.shape[0]
    if _BEAM_FACTOR_IMPL == "bcast":
        lt = jnp.transpose(L, (1, 2, 0, 3))  # (npol, F, nl, K)
        a_re = _beam_factor_bcast_plane(bsvd.re, lt)
        a_im = _beam_factor_bcast_plane(bsvd.im, lt)
    else:
        a_re = jnp.einsum("fapl,lpfk->falk", bsvd.re, L, optimize=True)
        a_im = jnp.einsum("fapl,lpfk->falk", bsvd.im, L, optimize=True)
    return za.Z(a_re.reshape(F * S, nl * K), a_im.reshape(F * S, nl * K))


def beam_factor_compact(bsvd: za.Z, L, l_chunk: int = 64) -> za.Z:
    """Width-compacted projected covariance factor: an (n, n) Cholesky
    re-factorisation of S = (B L)(B L)^H.

    :func:`beam_factor` returns a factor of width nl * K — at production
    band limits (nl ~ 1000, K ~ 256) that is a multi-GB (n, 258k) array,
    and every downstream pencil stage (triangular solve, Gram levels,
    deflation) pays O(n^2 * width) for it.  But rank(S) <= n always, so
    an (n, n) factor reproduces the pencil *exactly* up to formation
    rounding.  This computes S by accumulating per-l-chunk Grams over a
    ``lax.scan`` (the wide factor is never materialised), then takes a
    shifted f64 complex Cholesky (the interleaved embedding preserves
    triangularity — :func:`zarray.cholesky`), selecting the smallest
    shift from a relative {1e-10, 1e-7, 1e-4, 1e-2} ladder that yields a
    finite factor (all rungs cost ~n^3/3, trivial next to the Gram).

    Accuracy envelope: the f32 Gram formation perturbs S by
    ~sqrt(width) * eps32 * ||S||, so eigenvalues of the downstream
    pencil are reliable down to ~1e-5 relative to the top — ample for
    the *signal* side, whose whitened spectrum is the S/N spectrum (a
    few decades above the retention threshold).  Do NOT use it for the
    foreground side: the foreground spans ~14 decades and must stay in
    true factored form for the QR whitening (see kl_solve_qr).
    """
    F, S = bsvd.re.shape[0], bsvd.re.shape[1]
    nl, npol, _, K = L.shape
    n = F * S
    dt = bsvd.re.dtype

    # pad the l axis to a chunk multiple (zero rows contribute nothing)
    nlp = -(-nl // l_chunk) * l_chunk
    pad = nlp - nl
    b_re = jnp.pad(bsvd.re, ((0, 0), (0, 0), (0, 0), (0, pad)))
    b_im = jnp.pad(bsvd.im, ((0, 0), (0, 0), (0, 0), (0, pad)))
    Lp = jnp.pad(jnp.asarray(L, dtype=dt), ((0, pad), (0, 0), (0, 0), (0, 0)))

    nc = nlp // l_chunk
    # (F, S, npol, nc, lc) -> (nc, F, S, npol, lc); (nc, lc, npol, F, K)
    b_re = jnp.moveaxis(b_re.reshape(F, S, npol, nc, l_chunk), 3, 0)
    b_im = jnp.moveaxis(b_im.reshape(F, S, npol, nc, l_chunk), 3, 0)
    Lc = Lp.reshape(nc, l_chunk, npol, F, K)

    def body(acc, xs):
        br, bi, lc = xs
        ar = jnp.einsum("fapl,lpfk->falk", br, lc, optimize=True).reshape(n, -1)
        ai = jnp.einsum("fapl,lpfk->falk", bi, lc, optimize=True).reshape(n, -1)
        s_re = acc[0] + ar @ ar.T + ai @ ai.T
        s_im = acc[1] + ai @ ar.T - ar @ ai.T
        return (s_re, s_im), None

    init = (jnp.zeros((n, n), dtype=dt), jnp.zeros((n, n), dtype=dt))
    (s_re, s_im), _ = jax.lax.scan(body, init, (b_re, b_im, Lc))

    # exact Hermitian symmetrisation before factoring
    s_re = 0.5 * (s_re + s_re.T)
    s_im = 0.5 * (s_im - s_im.T)

    # f64 interleaved Cholesky with a relative shift ladder: S is PSD and
    # often genuinely rank-deficient (band-limit masks), and the f32 Gram
    # formation can push small eigenvalues slightly negative.
    # DRIFTSCAN_TPU_COMPACT_CHOL=f32 drops the factorisation to the
    # input dtype; the shift ladder then settles one rung higher
    # (~1e-5 relative eigenvalue bias instead of ~1e-8).
    f64 = os.environ.get("DRIFTSCAN_TPU_COMPACT_CHOL", "f64") != "f32"
    cdt = jnp.float64 if f64 else dt
    s_e = za.interleave(za.Z(s_re, s_im)).astype(cdt)
    dmax = jnp.max(jnp.diagonal(s_e)) + jnp.asarray(1e-30, cdt)
    eye = jnp.eye(2 * n, dtype=cdt)

    def chol_at(rel):
        return jnp.linalg.cholesky(s_e + (rel * dmax) * eye)

    out = chol_at(1e-2)  # always-finite backstop
    rungs = (1e-4, 1e-7, 1e-10) if f64 else (1e-4, 1e-5)
    for rel in rungs:
        cand = chol_at(rel)
        good = jnp.isfinite(cand[-1, -1])
        out = jnp.where(good, cand, out)

    lz = za.deinterleave(out)
    return za.Z(lz.re.astype(dt), lz.im.astype(dt))


# ------------------------------------------------------------------
# Multi-level Gram deflation
# ------------------------------------------------------------------


class GramBands(NamedTuple):
    """Banded left singular structure of a factor X (n, K), stacked.

    q : Z with planes (levels, n, n) — per-level eigenvector columns,
        zeroed outside the level's band.  Bands are mutually orthogonal
        (each level works on the deflated remainder of the previous).
    s : (levels, n) singular values, zeroed outside the band; the *last*
        level keeps every column (its tail is unconverged but tiny).

    Unbatched shapes — batch with ``jax.vmap``.
    """

    q: za.Z
    s: jnp.ndarray


_RANDOM_BASIS_CACHE = {}


def _random_real_basis(n2: int, k2: int, dtype) -> jnp.ndarray:
    """Fixed random orthonormal start block (host-cached, real)."""
    key = (n2, k2, np.dtype(dtype).name)
    if key not in _RANDOM_BASIS_CACHE:
        rng = np.random.default_rng(97531)
        q, _ = np.linalg.qr(rng.standard_normal((n2, k2)))
        _RANDOM_BASIS_CACHE[key] = np.ascontiguousarray(q, dtype=dtype)
    return jnp.asarray(_RANDOM_BASIS_CACHE[key])


def _chol_qr_real(v):
    """Orthonormalise a real column block by Cholesky-QR (matmul-only).

    The shift must sit above the f32 roundoff of the Gram (power
    iteration collapses columns toward the dominant eigenspace, driving
    the Gram numerically singular); a relative ~1e-5 shift keeps the
    Cholesky positive while the repeat pass restores orthogonality.
    """
    for _ in range(2):
        g = v.T @ v
        g = 0.5 * (g + g.T)
        shift = 1e-5 * jnp.max(jnp.diagonal(g)) + 1e-30
        g = g + shift * jnp.eye(g.shape[0], dtype=g.dtype)
        L = jnp.linalg.cholesky(g)
        v = jax.scipy.linalg.solve_triangular(L, v.T, lower=True).T
    return v


def _top_band_eigh(g: za.Z, k_c: int, iters: int = 8):
    """Approximate top-k_c eigenpairs of a Hermitian PSD split matrix.

    Subspace iteration on the (normalised) real-symmetric embedding —
    matmuls and Cholesky-QR only, plus one small (2*k_c) Rayleigh-Ritz
    eigh instead of the full 2n eigendecomposition.  The embedding's
    doubled spectrum is handled exactly as in :func:`zarray.eigh`: keep
    the even-indexed Ritz pairs and Newton-polish the reassembled complex
    vectors.

    Returns (w (k_c,) descending Ritz eigenvalues, v Z(n, k_c) columns).
    """
    n = g.shape[-1]
    E = za.embed_herm(g)

    # normalise so repeated applications stay inside the f32 range
    scale = jnp.maximum(jnp.max(jnp.abs(g.re)), jnp.max(jnp.abs(g.im))) + 1e-30
    En = E / scale

    v = _random_real_basis(2 * n, 2 * k_c, E.dtype)
    for _ in range(iters):
        # re-orthonormalise every step: wide spectra collapse the block
        # onto the dominant eigenspace within one application
        v = _chol_qr_real(En @ v)

    h = v.T @ (En @ v)
    h = 0.5 * (h + h.T)
    w2, u = jnp.linalg.eigh(h)  # ascending, (2k,)
    w2 = w2[::-1] * scale
    u = u[:, ::-1]
    ritz = v @ u  # (2n, 2k) descending

    idx = jnp.arange(k_c) * 2
    w = w2[idx]
    vc = za.unembed_vecs(ritz[:, idx])

    # Newton polish: within doubled pairs the selected complex vectors can
    # be slightly non-orthogonal (see zarray.eigh).
    eye = jnp.eye(k_c, dtype=vc.dtype)
    for _ in range(2):
        gram = za.einsum("ji,jk->ik", vc.conj(), vc)
        corr = za.Z(1.5 * eye - 0.5 * gram.re, -0.5 * gram.im)
        vc = za.einsum("ij,jk->ik", vc, corr)
    return w, vc


def gram_bands_topk(
    x: za.Z, levels: int, band_rel: float, k_cap: int, iters: int = 8
) -> GramBands:
    """Rank-capped :func:`gram_bands`: each level extracts at most
    ``k_cap`` directions by subspace iteration instead of a full 2n eigh.

    If a level's true band is wider than ``k_cap``, the un-extracted
    directions simply remain in the deflated remainder and surface at the
    next level (converging with extra levels rather than failing).  The
    last level is NOT complete — use only where a complete basis is not
    required (the id-plus-low-rank whitening, spectrum-only passes).

    **Approximate — quick-look only.**  Measured on the benchmark
    telescope: ~17x faster than the exact levels, but band-boundary Ritz
    vectors converge slowly against continuous spectra, under-whitening
    the foreground and biasing the retained KL eigenvalues ~+10%.  The
    exact :func:`gram_bands` remains the production default everywhere.
    """

    def eig_fn(g):
        w, q = _top_band_eigh(g, k_cap, iters=iters)  # descending
        return jnp.sqrt(jnp.maximum(w, 0.0)), q

    return _gram_level_scan(x, levels, band_rel, eig_fn)


def _gram_level_scan(x: za.Z, levels: int, band_rel: float, eig_fn) -> GramBands:
    """Level-deflation scan shared by gram_bands / gram_bands_topk.

    ``eig_fn(g) -> (s, q)``: descending non-negative singular values and
    matching left-vector columns of the level Gram ``g``.  The level
    loop is a ``lax.scan`` so the program compiles one level body
    regardless of depth.
    """

    def level_body(xc, level):
        g = za.einsum("ik,jk->ij", xc, xc.conj())
        g = za.Z(
            0.5 * (g.re + jnp.swapaxes(g.re, -1, -2)),
            0.5 * (g.im - jnp.swapaxes(g.im, -1, -2)),
        )
        s, q = eig_fn(g)

        last = level == levels - 1
        maskf = jnp.where(last | (s > s[:1] * band_rel), 1.0, 0.0).astype(
            s.dtype
        )
        qm = za.Z(q.re * maskf[None, :], q.im * maskf[None, :])

        # deflate: X <- (I - Qm Qm^H) X, applied twice (CGS2) — a single
        # pass leaks ~eps * s_max_level into the remainder, which would
        # floor every later level at that leak.
        for _ in range(2):
            proj = za.einsum("ji,jk->ik", qm.conj(), xc)
            xc = xc - za.einsum("ij,jk->ik", qm, proj)

        return xc, (qm.re, qm.im, s * maskf)

    _, (q_re, q_im, ss) = jax.lax.scan(
        level_body, x, jnp.arange(levels), length=levels
    )
    return GramBands(za.Z(q_re, q_im), ss)


def gram_bands(x: za.Z, levels: int = 3, band_rel: float = 3e-2) -> GramBands:
    """Left singular structure of X over ~levels*|log10(band_rel)| decades.

    Each level forms the Gram matrix G = X X^H (one matmul), takes its
    eigendecomposition, keeps the singular values above
    ``band_rel * s_max_level`` (the part a single f32 Gram actually
    resolves: eigh error ~ n*eps*s_max^2, and sqrt halves the exponent),
    then deflates that subspace out of X and repeats on the remainder.

    The level loop is a ``lax.scan`` so the program compiles one level
    body regardless of depth.
    """

    def eig_fn(g):
        w, q = za.eigh(g)  # ascending
        s = jnp.sqrt(jnp.maximum(w[::-1], 0.0))
        return s, za.Z(q.re[..., ::-1], q.im[..., ::-1])

    return _gram_level_scan(x, levels, band_rel, eig_fn)


def _select_complete_basis(bands: GramBands):
    """Pick n mutually-orthogonal columns across bands, by singular value.

    In-band columns rank by their s; masked-out columns get key -1 so the
    top-n selection takes the k_i converged columns of each level plus the
    head of the last level (whose tail duplicates already-selected
    directions at s ~ 0).  Returns (q Z(n, n) columns desc by s, s (n,)).
    """
    levels, n, k = bands.q.re.shape
    is_last = jnp.arange(levels)[:, None] == levels - 1
    keys = jnp.where(is_last | (bands.s > 0), bands.s, -1.0).reshape(-1)

    # (levels, n, k) -> (n, levels*k) column concatenation
    qcat_re = bands.q.re.transpose(1, 0, 2).reshape(n, levels * k)
    qcat_im = bands.q.im.transpose(1, 0, 2).reshape(n, levels * k)

    if levels * k < n:
        # rank-capped bands may not span everything: complete with zero
        # columns (eval exactly 0, below anything the caller keeps)
        pad = n - levels * k
        qcat_re = jnp.pad(qcat_re, ((0, 0), (0, pad)))
        qcat_im = jnp.pad(qcat_im, ((0, 0), (0, pad)))
        keys = jnp.pad(keys, (0, pad), constant_values=-1.0)

    order = jnp.argsort(-keys)[:n]
    q = za.Z(qcat_re[:, order], qcat_im[:, order])
    s = jnp.maximum(keys[order], 0.0)
    return q, s


# ------------------------------------------------------------------
# Whitening operators
# ------------------------------------------------------------------


def whiten_apply_idpluslr(bands: GramBands, y: za.Z) -> za.Z:
    """Apply W = (I + A A^H)^(-1/2) to y, A given by its Gram bands.

    W = I - sum_i Q_i diag(alpha_i) Q_i^H with alpha = 1 - 1/sqrt(1+s^2);
    alpha -> 0 as s -> 0, so unconverged/duplicate tail columns are
    harmless and no basis compaction is needed.  The bands are mutually
    orthogonal, so the level sum is applied in one batched contraction.
    """
    alpha = 1.0 - 1.0 / jnp.sqrt(1.0 + bands.s * bands.s)  # (levels, n)
    proj = za.einsum("lji,jk->lik", bands.q.conj(), y)
    proj = za.Z(proj.re * alpha[..., None], proj.im * alpha[..., None])
    return y - za.einsum("lij,ljk->ik", bands.q, proj)


def whiten_apply_floor(bands: GramBands, y: za.Z, floor_rel: float) -> za.Z:
    """Apply W = (A A^H)^(-1/2) to y with a relative eigenvalue floor.

    For foreground-only whitening (DoubleKL stage 1, where the thermal
    noise is excluded: reference doublekl.py:30-88): *eigenvalues* of
    A A^H below ``floor_rel * lambda_max`` are clamped before inversion
    (i.e. singular values below sqrt(floor_rel) * s_max).
    """
    q, s = _select_complete_basis(bands)
    smax = s[..., :1]
    sc = jnp.maximum(s, np.sqrt(floor_rel) * smax + 1e-30)
    proj = za.einsum("...ji,...jk->...ik", q.conj(), y)
    proj = za.Z(proj.re / sc[..., :, None], proj.im / sc[..., :, None])
    return za.einsum("...ij,...jk->...ik", q, proj)


# ------------------------------------------------------------------
# Factor-side QR whitening
# ------------------------------------------------------------------


def _solve_tri_interleaved(r_e: jnp.ndarray, b: za.Z, adjoint: bool) -> za.Z:
    """Solve R x = b (adjoint=False) or R^H x = b (True), R interleaved."""
    be = za.interleave(b)
    if adjoint:
        x = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(r_e, -1, -2), be, lower=True
        )
    else:
        x = jax.scipy.linalg.solve_triangular(r_e, be, lower=False)
    return za.deinterleave(x)


# ------------------------------------------------------------------
# Tall R factorisation: shifted CholeskyQR (matmul-only)
# ------------------------------------------------------------------

# Relative shift per round, in units of the current lambda_max estimate.
# Must sit above the f32 Gram's roundoff (~sqrt(rows)*eps*lambda_max)
# so the shifted Cholesky always succeeds; each round then reduces
# cond^2 by ~1/shift_rel (~3.4 decades at the f32 setting, ~12 at f64).
_CHOLQR_SHIFT_EPS_MULT = 3000.0


# Static round-count override (None = conditioning-worst-case default).
# Each shifted round is a full tall Gram + update — at bench shapes the
# noise QR is ~2/3 of the pencil-construction flops — and at bench-class
# conditioning (cond(N) ~ 3e11) rounds=4 already sits on the f32 Gram
# noise floor (~1e-3 retained-mode rel vs the dense f64 referee, same as
# rounds=8; rounds=3 degrades to ~8e-3).  The default stays at the
# 1e18-coverage count: the override is a *measured-run* lever, not a
# library default — a user's pencil may be worse conditioned than
# anything a gate saw.
_CHOLQR_ROUNDS = (
    int(os.environ["DRIFTSCAN_TPU_CHOLQR_ROUNDS"])
    if os.environ.get("DRIFTSCAN_TPU_CHOLQR_ROUNDS")
    else None
)


def _cholqr_rounds(dtype) -> int:
    """Shifted-round count covering any representable pencil conditioning.

    Physical noise pencils here reach cond(N) ~ 1e18 (low-frequency
    foreground amplitudes); with ~3.4 decades of cond^2 reduction per
    f32 round that needs 6 shifted rounds (f64: 12 decades/round, 2
    suffice), plus the two finishing rounds.
    """
    if _CHOLQR_ROUNDS:
        return _CHOLQR_ROUNDS
    return 8 if jnp.finfo(dtype).eps > 1e-10 else 4


def chol_qr_r(
    aug_e: jnp.ndarray,
    rounds: int | None = None,
    return_inv: bool = False,
) -> jnp.ndarray:
    """Upper-triangular R with ``aug_e ~= Q R`` for a tall real matrix.

    XLA's Householder QR is panel-sequential, far from matmul rate for
    the (2(K+n), 2n) pencil augmentations.  This computes the same R by
    *shifted CholeskyQR* iteration: per round one Gram matmul, one
    (2n)^2 Cholesky and one triangular solve — all matmul/blocked ops.
    Whether it beats cuSOLVER's QR on a GPU has not been measured.

    Accuracy is Householder-class *on the factor*: the shifted first
    rounds only precondition (aug = G_k (R_{k-1}..R_1) holds to rounding
    regardless of the shifts), and the final unshifted round leaves
    G_last orthonormal to ~eps, so N = R^T R carries the small noise
    eigenvalues exactly like QR's R does — unlike a direct Cholesky of
    the (once-formed, eps*lambda_max-corrupted) f32 Gram.  Validated
    against the dense f64 pencil at bench conditioning
    (tests/test_fpencil.py) and against XLA QR (method A/B).

    The diagonal is positive (Cholesky convention), matching the sign
    fix the Householder path applies.  Batched over leading axes.

    Round schedule: ``rounds - 2`` fully-shifted rounds (each cuts cond²
    by ~1/shift_rel), then one small-shift round (10 n eps — just above
    the Gram's own roundoff, bringing cond to ~1), then one unshifted
    polish that leaves the implicit Q orthonormal to ~eps.
    """
    dt = aug_e.dtype
    n = aug_e.shape[-1]
    eps = float(jnp.finfo(dt).eps)
    if rounds is None:
        rounds = _cholqr_rounds(dt)
    shift_rel = _CHOLQR_SHIFT_EPS_MULT * eps
    small_rel = 10.0 * n * eps
    eye = jnp.eye(n, dtype=dt)

    g = aug_e
    r_total = None
    invs = []
    for k in range(rounds):
        gram = jnp.einsum("...ji,...jk->...ik", g, g)
        gram = 0.5 * (gram + jnp.swapaxes(gram, -1, -2))
        if k < rounds - 2:
            rel = shift_rel
        elif k == rounds - 2:
            rel = small_rel
        else:
            rel = 0.0
        if rel:
            # inf-norm upper bound on lambda_max, per batch element
            lam = jnp.max(
                jnp.sum(jnp.abs(gram), axis=-1), axis=-1, keepdims=True
            )[..., None]
            gram = gram + (rel * lam + 1e-30) * eye
        L = jnp.linalg.cholesky(gram)
        r_k = jnp.swapaxes(L, -1, -2)
        r_total = r_k if r_total is None else r_k @ r_total
        if k < rounds - 1 or return_inv:
            # G <- G R_k^{-1} via the explicit small inverse: XLA's blocked
            # triangular solve against the tall G materialises a ladder of
            # partial-result temps (one (rows_done, tall) buffer per 128-row
            # block — ~14 GB at production scale), while the (n, n) solve
            # against I plus one tall matmul holds only ~2 copies of G.
            # Stable exactly as in _chol_qr_r_split: every solved round is
            # shifted, capping cond(R_k) at ~sqrt(1/shift_rel).
            rinv = jax.scipy.linalg.solve_triangular(
                r_k, jnp.broadcast_to(eye, r_k.shape), lower=False
            )
            if return_inv:
                invs.append(rinv)
            if k < rounds - 1:
                g = g @ rinv
    if return_inv:
        return r_total, invs
    return r_total


# Factorisation used for the pencil's noise whitening: "cholqr_split"
# (the shifted rounds in split-complex form — half the Gram flops of
# the interleaved embedding, no tall interleave, and measurably MORE
# accurate at strong-foreground conditioning: worst retained-mode
# error vs the dense complex128 referee on the full bench BTM is
# 1.5e-2 at m=1 vs 4.6e-2 interleaved and 2.4e-1 f32 Householder — the
# floor is the f32 Gram formation, round-count-independent), "cholqr" (interleaved
# embedding) or "householder" (XLA's QR) for A/B.  Env-overridable
# once, before first trace.
_QR_IMPL = os.environ.get("DRIFTSCAN_TPU_QR_IMPL", "cholqr_split")


def _chol_qr_r_split(rows: za.Z, return_inv: bool = False) -> jnp.ndarray:
    """R of the noise rows by shifted CholeskyQR in split-complex form.

    Exactly :func:`chol_qr_r`'s round schedule, but the tall matrix
    never leaves the split representation: per round the Gram is four
    real (rows, n) matmuls — *half* the flops of the
    interleaved-embedded Gram, whose doubled dimensions redo every
    product twice — the shifted complex Cholesky interleaves only the
    (n, n) Gram (zarray.cholesky), and the tall triangular solve
    becomes one split matmul against the explicit small inverse
    (stable: the shift caps cond(R_k) at ~sqrt(1/shift_rel)).  In
    exact arithmetic the result equals chol_qr_r's R (the interleaved
    embedding is a ring homomorphism mapping Cholesky to Cholesky).

    Returns interleave(R_total) — the downstream whitening solves stay
    true triangular solves (the *full* R carries cond(N)^(1/2) and
    must not be inverted explicitly).
    """
    dt = rows.re.dtype
    n = rows.shape[-1]
    eps = float(jnp.finfo(dt).eps)
    rounds = _cholqr_rounds(dt)
    shift_rel = _CHOLQR_SHIFT_EPS_MULT * eps
    small_rel = 10.0 * (2 * n) * eps
    eye = jnp.eye(n, dtype=dt)
    eye2 = jnp.eye(2 * n, dtype=dt)

    g = rows
    r_tot = None  # Z (n, n) upper-triangular complex
    invs = []
    for k in range(rounds):
        gram = _herm(za.einsum("...ji,...jk->...ik", g.conj(), g))
        if k < rounds - 2:
            rel = shift_rel
        elif k == rounds - 2:
            rel = small_rel
        else:
            rel = 0.0
        if rel:
            # inf-norm upper bound on lambda_max (|z| <= |re| + |im|)
            lam = jnp.max(
                jnp.sum(jnp.abs(gram.re) + jnp.abs(gram.im), axis=-1),
                axis=-1, keepdims=True,
            )[..., None]
            gram = za.Z(gram.re + (rel * lam + 1e-30) * eye, gram.im)
        L = za.cholesky(gram)
        r_k = za.Z(
            jnp.swapaxes(L.re, -1, -2), -jnp.swapaxes(L.im, -1, -2)
        )  # L^H, upper
        r_tot = (
            r_k
            if r_tot is None
            else za.einsum("...ij,...jk->...ik", r_k, r_tot)
        )
        if k < rounds - 1 or return_inv:
            le_t = jnp.swapaxes(za.interleave(L), -1, -2)  # interleave(L^H)
            rinv = za.deinterleave(
                jax.scipy.linalg.solve_triangular(le_t, eye2, lower=False)
            )
            if return_inv:
                invs.append(rinv)
            if k < rounds - 1:
                g = za.einsum("...ij,...jk->...ik", g, rinv)
    if return_inv:
        return za.interleave(r_tot), invs
    return za.interleave(r_tot)


def _noise_r_factor(noise_rows: za.Z) -> jnp.ndarray:
    """Interleaved upper-triangular R with N = R^H R from noise rows G."""
    if _QR_IMPL == "cholqr_split":
        return _chol_qr_r_split(noise_rows)
    aug = za.interleave(noise_rows)
    if _QR_IMPL == "householder":
        r_e = jnp.linalg.qr(aug, mode="r")
        d = jnp.diagonal(r_e, axis1=-2, axis2=-1)
        sign = jnp.where(d < 0, -1.0, 1.0).astype(aug.dtype)
        return r_e * sign[..., :, None]
    return chol_qr_r(aug)


# Whitening application: "solve" applies R_total^-H / R_total^-1 by XLA's
# triangular solve against the tall right-hand sides (the full R carries
# cond(N)^(1/2), so it is never inverted *as a whole*); "factored" applies
# the same inverses as the chain of per-round explicit factor inverses
# R_total^-1 = R_1^-1 .. R_K^-1 — each R_k is shift-capped at
# cond ~ sqrt(1/shift_rel) by construction, so every factor inversion is
# stable, and each application is one (n, n)(n, cols) matmul instead
# of a panel-sequential tall triangular solve.  The ill-conditioning of
# R_total stays distributed across the chain exactly as it is inside the
# CholeskyQR iteration itself (which whitens G through the same
# inverses).  Env-overridable; the default is "solve".
_WHITEN_IMPL = os.environ.get("DRIFTSCAN_TPU_WHITEN_IMPL", "solve")

# Residual-correction steps for the "refined" impl.  One step closes the
# chain-vs-solve gap to ~5e-4 worst-case at bench conditioning (knife-edge
# m=1); two put it under the 1e-4 retained-spectrum tier everywhere
# measured, at the cost of one more chain
# application + triangular matmul per whitening.
_WHITEN_REFINE_STEPS = int(os.environ.get("DRIFTSCAN_TPU_WHITEN_REFINE", "2"))


def _noise_white_factors(noise_rows: za.Z):
    """(r_e, [R_1^-1 .. R_K^-1]) — R and the per-round inverses as za.Z.

    Only defined for the CholeskyQR implementations (householder has no
    round factors); callers check :func:`_whiten_factored` first.
    """
    if _QR_IMPL == "cholqr_split":
        r_e, invs = _chol_qr_r_split(noise_rows, return_inv=True)
        return r_e, invs
    aug = za.interleave(noise_rows)
    r_e, invs_e = chol_qr_r(aug, return_inv=True)
    return r_e, [za.deinterleave(inv_e) for inv_e in invs_e]


def _whiten_factored() -> bool:
    return _WHITEN_IMPL in ("factored", "refined") and _QR_IMPL != "householder"


def _whiten_apply_factors(invs, b: za.Z, adjoint: bool) -> za.Z:
    """Apply R_total^-H b (adjoint) or R_total^-1 b through the factors.

    R_total = R_K .. R_1, so R_total^-1 = R_1^-1 .. R_K^-1 (apply the
    stored inverses right-to-left) and R_total^-H = R_K^-H .. R_1^-H
    (apply their adjoints left-to-right).
    """
    if adjoint:
        for inv in invs:
            b = za.einsum("...ji,...jk->...ik", inv.conj(), b)
    else:
        for inv in reversed(invs):
            b = za.einsum("...ij,...jk->...ik", inv, b)
    return b


def _compose_factor_inv(invs) -> za.Z:
    """M = R_total^-1 = R_1^-1 .. R_K^-1 composed into one (n, n) matrix.

    K-1 small (n, n)(n, n) matmuls once per pencil; every whitening
    application then costs ONE (n, n)(n, cols) matmul instead of a
    K-matmul chain.  The composed M carries the same normwise error
    bound as the chain (each factor is shift-capped), and the
    componentwise grading both lack is restored by the refinement steps
    against R_total, so "refined" accuracy is unchanged.
    """
    m = invs[0]
    for inv in invs[1:]:
        m = za.einsum("...ij,...jk->...ik", m, inv)
    return m


def _whiten_apply_refined(
    r_e: jnp.ndarray, m_inv: za.Z, b: za.Z, adjoint: bool
) -> za.Z:
    """Composed-inverse application plus iterative-refinement steps.

    The correction drives the result toward the exact solution of
    R^H y = b (resp. R v = b) for the *same* R_total the solve path
    uses, so the two impls agree to the refinement's convergence
    (residual contraction ~ ||I - M R^H|| per step) rather than to each
    path's independent rounding — which keeps knife-edge modes of the
    downstream banded deflation from rerouting.  Cost per step: one
    triangular matmul plus one M matmul.
    """
    if adjoint:
        apply = lambda x: za.einsum("...ji,...jk->...ik", m_inv.conj(), x)
    else:
        apply = lambda x: za.einsum("...ij,...jk->...ik", m_inv, x)
    mat = jnp.swapaxes(r_e, -1, -2) if adjoint else r_e
    y = apply(b)
    for _ in range(_WHITEN_REFINE_STEPS):
        res = b - za.deinterleave(mat @ za.interleave(y))
        y = y + apply(res)
    return y


def _make_whitener(noise_rows: za.Z):
    """The whitening application for the active ``_WHITEN_IMPL``.

    Returns ``whiten(b, adjoint)`` computing R^-H b (adjoint) or
    R^-1 b: "solve" = tall triangular solves against R_total,
    "factored" = the per-round inverse chain, "refined" = the chain
    plus one residual correction (see the impl docstrings above).
    """
    if _whiten_factored():
        r_e, invs = _noise_white_factors(noise_rows)
        if _WHITEN_IMPL == "refined":
            m_inv = _compose_factor_inv(invs)
            return lambda b, adj: _whiten_apply_refined(
                r_e, m_inv, b, adjoint=adj
            )
        return lambda b, adj: _whiten_apply_factors(invs, b, adjoint=adj)
    r_e = _noise_r_factor(noise_rows)
    return lambda b, adj: _solve_tri_interleaved(r_e, b, adjoint=adj)


# ------------------------------------------------------------------
# Top-band extraction: Chebyshev-filtered subspace iteration
# ------------------------------------------------------------------
#
# The retained KL modes are the eigenvalues of H = Y Y^H above an
# *absolute* cut (the S/N threshold, reference kltransform.py:310-355).
# A full eigendecomposition computes all n of them, and the eigh is the
# costliest stage of the product step.  The functions below extract
# exactly the above-cut band with *matmuls only*: a scaled Chebyshev filter that suppresses [0, b] (b below the
# cut) drives a k-column subspace iteration, and one small (k x k)
# float64 Rayleigh-Ritz recovers the eigenvalues to f64 formation
# accuracy.  Basis error from the f32 iteration enters the Ritz values
# only quadratically (variational bound: |theta - lambda| <=
# lambda_max * sin^2(angle)), so the f32 noise floor (~1e-7 subspace
# angle) is invisible at the reference's 1e-4 eigenvalue tier.


# Matmul precision of the top-band engine's *filter* stages (Chebyshev
# applications and the in-loop CholeskyQR): these only shape the
# iteration basis — the f64 Rayleigh-Ritz recovers eigenvalues from the
# span, and the spectral certificate checks completeness — so they can
# run below the library's "highest" default.  A tier with eps ~ 5e-7
# floors the locked-direction angle at ~5e-7 * (lam/lock)^2 ~ 5e-3 with
# the 2-decade levels, i.e. Ritz error ~ 2.5e-5 relative — inside the
# 1e-4 tier.  The *deflation* matmuls are excluded: their error leaks
# eps^2 * lam_max of spurious weight past the cut, which is marginal at
# production conditioning (lam/cut ~ 1e12).  None inherits the global
# default; module state (read at trace time) like _QR_IMPL.
_FILTER_PRECISION = os.environ.get("DRIFTSCAN_TPU_TOPBAND_FILTER_PRECISION") or None


def _chol_qr_zblock(v: za.Z, rounds: int = 2, precision=None) -> za.Z:
    """Orthonormalise a complex column block, matmul-only, gather-free.

    Interleaving the whole (n, k) block would cost two ~O(n*k) device
    gathers per call, so only the *small* (k, k) Cholesky factor goes through the
    interleaved embedding: per round one split Gram matmul, a shifted
    complex Cholesky (zarray.cholesky — interleaves k x k only), an
    explicit small triangular inverse R^-1 = (L^H)^-1 (stable here:
    the 1e-5 relative shift caps cond(L) at ~sqrt(1e5)), and one
    (n, k)(k, k) split matmul V <- V R^-1.

    The shifted rounds leave ~1e-5 non-orthonormality but preserve the
    *span* exactly (column operations only) — callers that need a
    metric use the explicit V^H V in the Rayleigh-Ritz step.
    """
    k = v.shape[-1]
    eye_e = jnp.eye(2 * k, dtype=v.dtype)
    for _ in range(rounds):
        g = _herm(za.einsum("ji,jk->ik", v.conj(), v, precision=precision))
        shift = 1e-5 * jnp.max(jnp.diagonal(g.re, axis1=-2, axis2=-1)) + 1e-30
        g = za.Z(g.re + shift * jnp.eye(k, dtype=g.re.dtype), g.im)
        L = za.cholesky(g)
        # R^-1 = (L^H)^-1 via the small interleaved upper solve
        le_t = jnp.swapaxes(za.interleave(L), -1, -2)  # interleave(L^H)
        rinv = za.deinterleave(
            jax.scipy.linalg.solve_triangular(le_t, eye_e, lower=False)
        )
        v = za.einsum("ij,jk->ik", v, rinv, precision=precision)
    return v


def _cheb_apply(y: za.Z, v: za.Z, b: float, degree: int, precision=None) -> za.Z:
    """Apply the Chebyshev filter T_degree(t(H)) to the block v.

    H = Y Y^H (never formed: each application is two (n, K)(K, k)
    matmuls), t(lam) = 2*lam/b - 1 maps the suppressed interval [0, b]
    onto [-1, 1]; everything above b grows as T_d(t) ~ exp(d*acosh(t)).
    Eigenvalues at 2b (t = 3) gain ~5.8^degree per application while
    [0, b] stays bounded by 1.  The three-term recurrence rescales both
    iterates by the running max each step — T_d reaches (4*lam_max/b)^d,
    far outside f32 range, but only the *direction* of the filtered
    block matters.
    """
    inv_b = 2.0 / b

    def t_of_h(x: za.Z) -> za.Z:
        w = za.einsum("ji,jk->ik", y.conj(), x, precision=precision)  # Y^H x
        hx = za.einsum("ij,jk->ik", y, w, precision=precision)  # Y (Y^H x)
        return za.Z(inv_b * hx.re - x.re, inv_b * hx.im - x.im)

    vp, vk = v, t_of_h(v)  # T_0 v, T_1 v
    for _ in range(degree - 1):
        t = t_of_h(vk)
        vn = za.Z(2.0 * t.re - vp.re, 2.0 * t.im - vp.im)
        s = 1.0 / (
            jnp.maximum(jnp.max(jnp.abs(vn.re)), jnp.max(jnp.abs(vn.im)))
            + 1e-30
        )
        vp = za.Z(vk.re * s, vk.im * s)
        vk = za.Z(vn.re * s, vn.im * s)
    return vk


def _herm(a: za.Z) -> za.Z:
    return za.Z(
        0.5 * (a.re + jnp.swapaxes(a.re, -1, -2)),
        0.5 * (a.im - jnp.swapaxes(a.im, -1, -2)),
    )


def gram_topband(
    y: za.Z,
    k: int,
    cut: float,
    levels: int = 5,
    lock_rel: float = 1e-2,
    gap_rel: float = 4.0,
    degree: int = 2,
    iters: int = 4,
    rr_dtype=jnp.float64,
):
    """All eigenpairs of H = Y Y^H with eigenvalue >= ``cut`` (absolute).

    A single-stage filter cannot work here: every f32 application of H
    rounds at ~eps32 * lambda_max, which destroys cut-level components
    whenever lambda_max/cut exceeds ~1/eps32 — the same reason
    :func:`gram_bands` deflates in levels.  So this uses the *same*
    level structure, with each level's band extracted by matmuls
    instead of a (2n)^2 QDWH eigh:

    * level ell *locks* the eigenvalues in
      [max(lock_rel * lam_ell, cut), lam_ell] (lam_1 from power
      iteration; lam_{ell+1} = the previous lock bound after
      deflation), found by a gentle Chebyshev filter of the given
      ``degree`` suppressing [0, b], b = lock / gap_rel;
    * Ritz values/vectors come from a float64 Rayleigh-Ritz with the
      explicit basis metric (B = Y^H V in ``rr_dtype``; the generalised
      (V^H H V, V^H V) solve absorbs the shifted CholeskyQR's ~1e-5
      non-orthonormality, and f64 formation keeps eigenvalues at the
      lock bound accurate);
    * locked pairs are CGS2-deflated out of Y; everything below the
      lock (unconverged band floor, the (b, lock) gap) stays in Y and
      surfaces at the next level, where it sits at the band *top*.

    The error budget fixing the constants: each f32 filter application
    reinjects rounding noise at relative eps32 of the *top* amplified
    component, so a locked direction's subspace angle floors at
    ~eps32 * gain(lam)/gain(lock) = eps32 * (lam/lock)^degree; the
    Rayleigh-Ritz error (lam - theta) * sin^2(angle) then stays below
    1e-4 * theta (the reference tier) only if (lam/lock)^degree <~ 1e4
    — hence 2-decade levels at degree 2.  Convergence against the
    suppressed region is T_degree(2*gap_rel - 1)^iters ~ 1e8.

    The completeness certificate is spectral, not structural: after the
    last level, lambda_max of the deflated remainder (power iteration —
    matmuls) must be below ``cut``.  That catches a band overflowing
    the ``k``-column basis, an unconverged filter, and too few levels
    for the spectrum's range (each level advances ~1/lock_rel in
    eigenvalue; ``levels`` must cover lambda_max/cut).

    Returns ``(theta, u, ok)``:

    theta : (levels * k,) descending within each level, zero where
        below ``cut``
    u : Z (n, levels * k) orthonormal eigenvector columns (zeroed
        below cut)
    ok : () bool — True iff every eigenvalue >= cut was captured.
    """
    n = y.shape[-2]
    dt = y.re.dtype
    cut = float(cut)
    if cut <= 0.0:
        # the certificate compares a PSD norm against the cut: with
        # cut <= 0 it is unsatisfiable and the dispatcher would burn the
        # whole escalation ladder before falling back — fail loudly
        raise ValueError("topband engine requires a positive cut "
                         f"(got {cut}); use the exact engine instead")

    lam = _spectral_norm_sq(y)  # lambda_max estimate (matmuls)
    v0_re = _random_real_basis(n, k, dt)

    thetas, us = [], []
    for _ in range(levels):
        lock = jnp.maximum(lock_rel * lam, cut)
        b = jnp.maximum(lock / gap_rel, 1e-30)
        v = za.Z(v0_re, jnp.zeros((n, k), dt))
        for _ in range(iters):
            v = _cheb_apply(y, v, b, degree, precision=_FILTER_PRECISION)
            v = _chol_qr_zblock(v, precision=_FILTER_PRECISION)

        yd = y.astype(rr_dtype)
        vd = v.astype(rr_dtype)
        bd = za.einsum("ji,jk->ik", yd.conj(), vd)  # (K, k)
        h = za.einsum("ji,jk->ik", bd.conj(), bd)  # V^H H V
        met = za.einsum("ji,jk->ik", vd.conj(), vd)  # V^H V
        theta, u, _ = za.whiten_eigh(_herm(h), _herm(met))  # ascending
        theta = theta[::-1]
        u = za.Z(u.re[:, ::-1], u.im[:, ::-1])
        uu = za.einsum("ij,jk->ik", v, u.astype(dt))  # (n, k) orthonormal

        # lock only well-converged pairs: below the lock bound the
        # filter gain margin is too thin — leave those directions in Y
        # for the next level
        keep = (theta >= lock).astype(dt)
        theta = theta.astype(dt) * keep
        uu = za.Z(uu.re * keep[None, :], uu.im * keep[None, :])
        thetas.append(theta)
        us.append(uu)

        # CGS2 deflation of the locked columns (masked columns are zero
        # and deflate nothing)
        for _ in range(2):
            proj = za.einsum("ji,jk->ik", uu.conj(), y)
            y = y - za.einsum("ij,jk->ik", uu, proj)
        lam = lock

    # certificate: nothing above the cut survives in the remainder.
    # Estimated with a BLOCK Rayleigh-Ritz, not a single power vector:
    # a single vector's Rayleigh quotient is a weighted mean, so a
    # dense shelf of eigenvalues just below an above-cut outlier
    # dilutes its weight and can under-estimate the outlier below the
    # cut — falsely certifying completeness and silently dropping a
    # retained mode.  The block absorbs the shelf into its lower Ritz
    # directions; its top Ritz value converges at (lam_{q+1}/lam_1)^2t.
    # No margin on the cut itself: continuous KL spectra generically
    # leave the remainder top just BELOW the cut, and any margin there
    # would escalate forever on perfectly complete bands.  (q, iters)
    # sized so a 500-fold shelf at 0.86x the outlier is resolved —
    # amplitude gain (lam1/shelf)^iters must beat the sqrt(n_shelf)
    # initial-overlap disadvantage.  An outlier masked by a shelf
    # *closer* than ~(sqrt(n)/gain) remains boundary fuzz: the same
    # knife-edge class the reference's threshold subsetting tie-breaks
    # by eigh rounding.  Cost: 2*iters (n, K)(K, q) matmuls — noise
    # next to the filter stages.
    ok = _spectral_norm_sq_block(y, q=16, iters=32) < cut

    theta = jnp.concatenate(thetas)  # descending across+within levels
    u = za.Z(
        jnp.concatenate([x.re for x in us], axis=1),
        jnp.concatenate([x.im for x in us], axis=1),
    )
    mask = (theta >= cut).astype(dt)
    theta = theta * mask
    u = za.Z(u.re * mask[None, :], u.im * mask[None, :])
    return theta, u, ok


def pencil_solve_qr_topband(
    a_signal: za.Z,
    noise_rows: za.Z,
    cut: float,
    k: int,
    levels: int = 5,
    lock_rel: float = 1e-2,
    gap_rel: float = 4.0,
    degree: int = 2,
    iters: int = 4,
    rr_dtype=jnp.float64,
):
    """Retained band of S v = w N v by QR whitening + filtered iteration.

    Same whitening as :func:`pencil_solve_qr` (CholeskyQR of the noise
    rows, triangular solves), but the whitened Gram's eigendecomposition
    is replaced by :func:`gram_topband`, which computes only the modes
    the KL transform retains (w >= ``cut``).  Eigenvalues below the cut
    are reported as exact zeros with zero eigenvectors — the reference
    writes them for diagnostics only and retains nothing below its
    threshold (drift/core/kltransform.py:310-355).

    Returns ``(KLResult, ok)`` with evals ascending in the standard
    (n,) layout; ``ok`` False means a band overflowed the ``k``-column
    basis or the filter had not converged (see :func:`gram_topband`).
    """
    in_dtype = a_signal.re.dtype
    n = a_signal.shape[-2]
    w = min(levels * k, n)

    whiten = _make_whitener(noise_rows)
    y = whiten(a_signal, True)  # R^-H A_s

    theta, u, ok = gram_topband(
        y,
        k=k,
        cut=cut,
        levels=levels,
        lock_rel=lock_rel,
        gap_rel=gap_rel,
        degree=degree,
        iters=iters,
        rr_dtype=rr_dtype,
    )  # (levels*k,) descending-within-level, zeros interspersed

    # top-w by value (the cut-masked zeros make value order == keep set)
    order = jnp.argsort(-theta)[:w]
    theta = jnp.take(theta, order)
    u = za.Z(
        jnp.take(u.re, order, axis=1), jnp.take(u.im, order, axis=1)
    )

    v = whiten(u, False)  # R^-1 U, (n, w)

    pad = n - w
    evals = jnp.concatenate(
        [jnp.zeros((pad,), in_dtype), theta[::-1].astype(in_dtype)]
    )
    zeros = jnp.zeros((n, pad), in_dtype)
    vfull = za.Z(
        jnp.concatenate([zeros, v.re[:, ::-1]], axis=1).astype(in_dtype),
        jnp.concatenate([zeros, v.im[:, ::-1]], axis=1).astype(in_dtype),
    )
    return KLResult(evals, vfull), ok


def kl_solve_qr_topband(
    a_signal: za.Z,
    a_fg: za.Z,
    cut: float,
    k: int,
    levels: int = 5,
    lock_rel: float = 1e-2,
    gap_rel: float = 4.0,
    degree: int = 2,
    iters: int = 4,
    rr_dtype=jnp.float64,
    fg_reg_rel: float = 0.0,
):
    """Retained band of the standard thermal pencil (see kl_solve_qr;
    ``fg_reg_rel`` carries the reference's foreground regulariser as an
    identity shift on the noise, exactly as there)."""
    nc = jnp.asarray(1.0, a_signal.re.dtype)
    if fg_reg_rel:
        nc = nc + fg_reg_rel * jnp.max(jnp.sum(a_fg.abs2(), axis=-1))
    return pencil_solve_qr_topband(
        a_signal,
        _thermal_noise_rows(a_fg, nc),
        cut=cut,
        k=k,
        levels=levels,
        lock_rel=lock_rel,
        gap_rel=gap_rel,
        degree=degree,
        iters=iters,
        rr_dtype=rr_dtype,
    )


# ------------------------------------------------------------------
# The KL pencil solve
# ------------------------------------------------------------------


class KLResult(NamedTuple):
    evals: jnp.ndarray  # (n,) ascending
    evecs: za.Z  # (n, n) columns, N-orthonormal


def _spectral_norm_sq(a: za.Z, iters: int = 8) -> jnp.ndarray:
    """lambda_max(A A^H) by power iteration (matmuls only, fixed start)."""
    n = a.shape[-2]
    v = za.Z(
        _random_real_basis(n, 1, a.dtype)[:, :1], jnp.zeros((n, 1), a.dtype)
    )
    lam = jnp.asarray(0.0, a.dtype)
    for _ in range(iters):
        w = za.einsum("ji,jk->ik", a.conj(), v)  # A^H v
        v = za.einsum("ij,jk->ik", a, w)  # A A^H v
        lam = jnp.sqrt(jnp.sum(v.abs2()))
        nv = lam + 1e-30
        v = za.Z(v.re / nv, v.im / nv)
    return lam


def _spectral_norm_sq_block(a: za.Z, q: int = 8, iters: int = 12) -> jnp.ndarray:
    """lambda_max(A A^H) by block subspace iteration + Rayleigh-Ritz.

    Sharper from below than :func:`_spectral_norm_sq` when a dense
    shelf of slightly smaller eigenvalues dilutes a single power
    vector's Rayleigh quotient: the q-column block captures the shelf
    in its lower Ritz directions, so the TOP Ritz value converges at
    ratio (lambda_{q+1}/lambda_1)^(2*iters).  Matmuls + one (q, q)
    eigh only; used by the top-band completeness certificate.
    """
    n = a.shape[-2]
    q = int(min(q, n))
    v = za.Z(_random_real_basis(n, q, a.dtype), jnp.zeros((n, q), a.dtype))
    for _ in range(iters):
        w = za.einsum("ji,jk->ik", a.conj(), v)  # A^H V
        v = za.einsum("ij,jk->ik", a, w)  # (A A^H) V
        v = _chol_qr_zblock(v)
    b = za.einsum("ji,jk->ik", a.conj(), v)  # A^H V, (K, q)
    h = _herm(za.einsum("ji,jk->ik", b.conj(), b))  # V^H (A A^H) V
    w, _ = za.eigh(h)  # ascending
    return w[-1]


def pencil_solve_qr(
    a_signal: za.Z,
    noise_rows: za.Z,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    sig_k_cap: int = 0,
) -> KLResult:
    """Solve S v = w N v with S = A_s A_s^H and N = G^H G given by rows G.

    The general core of :func:`kl_solve_qr`: any noise covariance
    expressible as a (rows, n) factor works — ``[A_f^H; sqrt(nc) I]`` for
    the standard thermal pencil, restricted/projected factors for the
    two-stage DoubleKL.  Returns evals ascending and N-orthonormal
    eigenvector columns.
    """
    in_dtype = a_signal.re.dtype
    n = a_signal.shape[-2]

    whiten = _make_whitener(noise_rows)

    y = whiten(a_signal, True)  # R^-H A_s

    if sig_k_cap:
        yb = gram_bands_topk(
            y, levels=sig_levels, band_rel=band_rel, k_cap=sig_k_cap
        )
    else:
        yb = gram_bands(y, levels=sig_levels, band_rel=band_rel)
    u, sy = _select_complete_basis(yb)
    evals = sy * sy  # descending

    v = whiten(u, False)  # R^-1 U

    evals = evals[..., ::-1].astype(in_dtype)
    v = za.Z(
        v.re[..., ::-1].astype(in_dtype), v.im[..., ::-1].astype(in_dtype)
    )
    return KLResult(evals, v)


def _thermal_noise_rows(a_fg: za.Z, nc) -> za.Z:
    """Noise factor rows [A_f^H; sqrt(nc) I] for N = nc*I + A_f A_f^H."""
    n = a_fg.shape[-2]
    dt = a_fg.dtype
    afh = za.Z(
        jnp.swapaxes(a_fg.re, -1, -2), -jnp.swapaxes(a_fg.im, -1, -2)
    )
    root = jnp.sqrt(jnp.asarray(nc, dtype=dt))
    eye = root * jnp.eye(n, dtype=dt)
    zero = jnp.zeros_like(eye)
    pad_shape = afh.re.shape[:-2] + (n, n)
    return za.Z(
        jnp.concatenate([afh.re, jnp.broadcast_to(eye, pad_shape)], axis=-2),
        jnp.concatenate([afh.im, jnp.broadcast_to(zero, pad_shape)], axis=-2),
    )


def _doublekl_stage1_floor(a_fg, nc1, fg_floor, fg_reg_rel, dt):
    """Stage-1 identity floor shared by the exact and top-band engines.

    The floor is the reference's *suppressed* radiometer noise
    (kltransform._noise_power with use_thermal=False: Tsys -> 1 mK)
    when the caller knows it (otherwise a relative foreground floor),
    plus the reference's relative foreground regulariser — its dense
    path adds fg_reg_rel * max|F_ij| to the diagonal
    (/root/reference/drift/core/kltransform.py:289-290), and for a PSD
    F the max entry sits on the diagonal = the max row norm^2 of A_f.
    """
    if nc1 is None:
        nc1 = fg_floor * _spectral_norm_sq(a_fg) + jnp.asarray(1e-30, dt)
    return nc1 + fg_reg_rel * jnp.max(jnp.sum(a_fg.abs2(), axis=-1))


def _doublekl_stage2_rows(a_signal, a_fg, p, n):
    """Stage-2 pencil factors on the kept subspace, shared by both engines.

    Returns (p^H A_s, noise rows [A_f^H p ; p ; delta I]).  The
    kept-mode diagonal of N' is >= 1 (stage-1 noise normalisation), so
    the 1e-4 delta keeps dropped columns nonsingular at ~1e-8 relative
    effect on genuine eigenvalues.
    """
    dt = a_signal.dtype
    bs = za.einsum("ji,jk->ik", p.conj(), a_signal)  # p^H A_s
    fp = za.einsum("ja,jc->ac", a_fg.conj(), p)  # A_f^H p, (K, n)
    gr = za.Z(
        jnp.concatenate([fp.re, p.re], axis=-2),
        jnp.concatenate([fp.im, p.im], axis=-2),
    )
    delta = jnp.asarray(1e-4, dt) * jnp.eye(n, dtype=dt)
    gr = za.Z(
        jnp.concatenate([gr.re, delta], axis=-2),
        jnp.concatenate([gr.im, jnp.zeros_like(delta)], axis=-2),
    )
    return bs, gr


def doublekl_solve_qr(
    a_signal: za.Z,
    a_fg: za.Z,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    nc1: float | None = None,
    fg_reg_rel: float = 1e-14,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
) -> tuple:
    """Two-stage (DoubleKL) pencil, fully factored and shape-static.

    Stage 1 solves S v = w (F + nc1 I) v (thermal suppressed to the
    reference's 1 mK floor, or an additive fg_floor regularisation when
    nc1 is not given); modes with w <= fg_threshold are *mask-dropped*
    (their columns zeroed) instead of sliced, so the whole two-stage
    solve jits and vmaps.  Stage 2 solves the thermal pencil restricted
    to the kept subspace: signal factor p^H A_s, noise factor
    [A_f^H p; p] (+ a relative ~1e-6 diagonal so dropped columns stay
    nonsingular — they emerge with eval exactly ~0 and zero vectors,
    sorting below any genuine mode, matching the padding contract of
    kl_product_step).

    Reference behaviour: /root/reference/drift/core/doublekl.py:30-88.

    Returns (f_evals (n,) ascending stage-1 spectrum,
             evals (n,) ascending stage-2 spectrum (dropped -> 0),
             evecs Z (n, n) final mode columns in the original basis,
             nkept () int32).
    """
    dt = a_signal.dtype
    n = a_signal.shape[-2]

    # ---- stage 1: S/F ----
    # The identity floor is the reference's *suppressed* radiometer noise
    # (kltransform._noise_power with use_thermal=False: Tsys -> 1 mK)
    # when the caller knows it (otherwise a relative foreground floor),
    # plus the reference's relative foreground regulariser — its dense
    # path adds fg_reg_rel * max|F_ij| to the diagonal
    # (/root/reference/drift/core/kltransform.py:289-290), and for a PSD
    # F the max entry sits on the diagonal = the max row norm^2 of A_f.
    nc1 = _doublekl_stage1_floor(a_fg, nc1, fg_floor, fg_reg_rel, dt)
    kl1 = pencil_solve_qr(
        a_signal,
        _thermal_noise_rows(a_fg, nc1),
        sig_levels=sig_levels,
        band_rel=band_rel,
    )
    f_evals = kl1.evals  # ascending
    keep = (f_evals > fg_threshold).astype(dt)  # (n,)
    p = za.Z(kl1.evecs.re * keep[None, :], kl1.evecs.im * keep[None, :])

    # ---- stage 2: S/(nc I + F) on the kept subspace ----
    bs, gr = _doublekl_stage2_rows(a_signal, a_fg, p, n)

    kl2 = pencil_solve_qr(bs, gr, sig_levels=sig_levels, band_rel=band_rel)

    # back to the original basis: final mode columns are p @ v2
    v = za.einsum("ij,jk->ik", p, kl2.evecs)

    # dropped/padded stage-2 outputs carry no signal: mask their evals to 0
    # (they are ~0 already; exact zeros keep the file contract clean)
    vnorm = jnp.sum(v.abs2(), axis=-2)
    alive = (vnorm > 1e-12).astype(dt)
    evals2 = kl2.evals * alive

    nkept = jnp.sum(keep).astype(jnp.int32)
    return f_evals, evals2, v, nkept


def doublekl_solve_qr_topband(
    a_signal: za.Z,
    a_fg: za.Z,
    cut: float,
    k: int,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    nc1: float | None = None,
    fg_reg_rel: float = 1e-14,
    levels: int = 5,
    k2: int | None = None,
):
    """Two-stage (DoubleKL) pencil through the top-band engine.

    Identical structure to :func:`doublekl_solve_qr`, with each stage's
    eigendecomposition replaced by the filtered top-band extraction:
    stage 1 computes exactly the modes it *keeps* (S/F > fg_threshold —
    the retention cut IS the stage-1 band edge), stage 2 the modes
    above the final KL threshold ``cut``.  Everything below either cut
    is reported as exact zeros, matching the mask-drop contract.

    Returns (f_evals, evals2, evecs, nkept, ok) — the first four as
    :func:`doublekl_solve_qr`; ``ok`` is the AND of both stages'
    completeness certificates (False => redispatch bigger or fall back
    to the exact engine).
    """
    dt = a_signal.dtype
    n = a_signal.shape[-2]
    if k2 is None:
        k2 = k

    # ---- stage 1: S/F, band = the kept modes ----
    nc1 = _doublekl_stage1_floor(a_fg, nc1, fg_floor, fg_reg_rel, dt)
    kl1, ok1 = pencil_solve_qr_topband(
        a_signal,
        _thermal_noise_rows(a_fg, nc1),
        cut=fg_threshold,
        k=k,
        levels=levels,
    )
    f_evals = kl1.evals  # ascending, zeros below fg_threshold
    keep = (f_evals > fg_threshold).astype(dt)
    p = za.Z(kl1.evecs.re * keep[None, :], kl1.evecs.im * keep[None, :])

    # ---- stage 2: S/(nc I + F) on the kept subspace ----
    bs, gr = _doublekl_stage2_rows(a_signal, a_fg, p, n)

    kl2, ok2 = pencil_solve_qr_topband(bs, gr, cut=cut, k=k2, levels=levels)

    v = za.einsum("ij,jk->ik", p, kl2.evecs)
    vnorm = jnp.sum(v.abs2(), axis=-2)
    alive = (vnorm > 1e-12).astype(dt)
    evals2 = kl2.evals * alive

    nkept = jnp.sum(keep).astype(jnp.int32)
    return f_evals, evals2, v, nkept, ok1 & ok2


def kl_solve_qr(
    a_signal: za.Z,
    a_fg: za.Z,
    with_thermal: bool = True,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    fg_floor: float = 1e-6,
    sig_k_cap: int = 0,
    fg_reg_rel: float = 0.0,
) -> KLResult:
    """Solve S v = w N v by factor-side QR whitening (the accurate path).

    The pencil eigenvalues are the squared singular values of R^-H A_s
    where N = R^H R comes from one backward-
    stable QR on the *factor* instead of multi-level Gram deflation of the
    ~14-decade foreground covariance.  Measured against the dense f64
    pencil at benchmark scale (n=352, cond(N) ~ 3e11): eigenvalues match
    to ~1e-5 relative and the eigenvectors verify by f64 Rayleigh
    quotient, where the Gram-deflation path was wrong by ~40x on the top
    modes (its f32 foreground Gram corrupts every direction below
    n*eps*s_max^2).

    ``with_thermal=False`` (DoubleKL stage 1) solves against the
    foreground alone, floored at ``fg_floor * lambda_max`` (additive
    regularisation rather than the reference's eigenvalue clamp — both
    are floor-scale heuristics, /root/reference/drift/core/doublekl.py:30-88).

    The whitened signal spectrum is narrow (it *is* the S/N spectrum), so
    ``sig_levels`` Gram-deflation levels on y suffice; ``sig_k_cap``
    switches the y side to subspace iteration for spectrum-only passes.

    ``fg_reg_rel`` adds the *reference's* foreground regulariser — its
    dense path shifts the noise diagonal by fg_reg_rel * max|F_ij|
    (/root/reference/drift/core/kltransform.py:289-290; for PSD F the
    max entry is the max row norm^2 of A_f), an identity shift that
    folds exactly into the thermal scale of the factored noise rows.
    At strong-foreground configurations this term can exceed the
    thermal floor itself, so output parity with the reference requires
    carrying it even though the factored solve needs no regularisation.
    """
    in_dtype = a_signal.re.dtype

    if with_thermal:
        nc = jnp.asarray(1.0, in_dtype)
    else:
        nc = fg_floor * _spectral_norm_sq(a_fg) + jnp.asarray(1e-30, in_dtype)
    if fg_reg_rel:
        nc = nc + fg_reg_rel * jnp.max(jnp.sum(a_fg.abs2(), axis=-1))

    return pencil_solve_qr(
        a_signal,
        _thermal_noise_rows(a_fg, nc),
        sig_levels=sig_levels,
        band_rel=band_rel,
        sig_k_cap=sig_k_cap,
    )


def kl_solve(
    a_signal: za.Z,
    a_fg: za.Z,
    with_thermal: bool = True,
    fg_levels: int = 8,
    sig_levels: int | None = None,
    band_rel: float | None = None,
    fg_floor: float = 1e-6,
    solve_dtype=None,
    fg_k_cap: int = 0,
    sig_k_cap: int = 0,
    method: str = "qr",
    fg_reg_rel: float = 0.0,
) -> KLResult:
    """Solve S v = w N v with S = A_s A_s^H, N = [I +] A_f A_f^H.

    ``method="qr"`` (the default) whitens by factor-side QR
    (:func:`kl_solve_qr`) — accurate to ~1e-5 of the dense f64 pencil at
    benchmark conditioning, and cheaper than the deflation ladder.
    ``method="gram"`` keeps the original multi-level Gram-deflation
    engine (foreground whitening error grows with cond(N); retained for
    A/B and for covariances too wide even for QR).

    Parameters
    ----------
    a_signal, a_fg : Z (n, K_s), (n, K_f)
        Factored projected signal and foreground covariances
        (:func:`beam_factor`).
    with_thermal
        True: N includes the (identity) projected radiometer noise —
        requires the beams to be noise-prewhitened, which makes
        U N_inst U^H == I exactly (the standard KLTransform case).
        False: N is the foreground alone (DoubleKL stage 1); its
        spectrum is floored at ``fg_floor`` relative for the whitening.
    fg_levels, sig_levels
        Gram deflation depth.  Each level extends the resolved range by
        a factor 1/band_rel of singular value (squared in eigenvalue),
        and the band cut must stay well above the Gram's eigh resolution
        (~n * eps(solve_dtype) relative to the level's top) or deflation
        of poorly-converged directions pollutes later levels.
    solve_dtype
        dtype of the Gram/eigh stages.  float64 (the default) reaches
        eps ~ 1e-15, so 3 foreground + 2 signal levels at band_rel 1e-3
        cover the foreground's 14 decades with ~1e-6 in-band accuracy
        using 5 eighs per m instead of 13.  (An all-f32 configuration needs
        (8, 5, 1e-1) for the reference's 1e-4 KL tier.)

    Returns
    -------
    KLResult with evals ascending (matching eigh convention) and evecs as
    columns satisfying v^H N v = I on the resolved subspace.
    """
    # method-appropriate depth defaults: the QR path whitens first, so its
    # y spectrum is narrow (2 levels at band_rel 3e-2 cover ~7 eigenvalue
    # decades); the gram engine needs its deeper ladder.
    if sig_levels is None:
        sig_levels = 2 if method == "qr" else 5
    if band_rel is None:
        band_rel = 3e-2 if method == "qr" else 1e-1

    if method == "qr":
        if fg_k_cap:
            raise ValueError(
                "fg_k_cap is a gram-engine knob (method='gram'): QR "
                "whitening has no foreground Gram to rank-cap"
            )
        if solve_dtype is not None:
            a_signal = a_signal.astype(solve_dtype)
            a_fg = a_fg.astype(solve_dtype)
        return kl_solve_qr(
            a_signal,
            a_fg,
            with_thermal=with_thermal,
            sig_levels=sig_levels,
            band_rel=band_rel,
            fg_floor=fg_floor,
            sig_k_cap=sig_k_cap,
            fg_reg_rel=fg_reg_rel,
        )
    if method != "gram":
        raise ValueError(f"Unknown kl_solve method {method!r}")

    if fg_reg_rel:
        # N = (1 + r) I + F == (1+r) * (I + F/(1+r)): scaling both
        # factors by 1/sqrt(1+r) gives the same generalised eigenvalues
        # through the id-plus-low-rank whitening below.
        r = fg_reg_rel * jnp.max(jnp.sum(a_fg.abs2(), axis=-1))
        s = 1.0 / jnp.sqrt(1.0 + r)
        a_signal = za.Z(a_signal.re * s, a_signal.im * s)
        a_fg = za.Z(a_fg.re * s, a_fg.im * s)

    in_dtype = a_signal.re.dtype
    if solve_dtype is not None:
        a_signal = a_signal.astype(solve_dtype)
        a_fg = a_fg.astype(solve_dtype)

    # Rank-capped (subspace-iteration) levels trade the full 2n eigh per
    # level for matmuls + a small Rayleigh-Ritz eigh.  Only valid where a
    # complete basis is not required: the id-plus-low-rank whitening
    # tolerates missing tail directions (alpha -> 0), and with sig_k_cap
    # the unresolved signal tail reports eval 0 with zero eigenvectors —
    # use for spectrum-style passes, not for full KL products.
    if fg_k_cap and not with_thermal:
        raise ValueError(
            "fg_k_cap requires with_thermal=True: foreground-floor "
            "whitening needs a complete basis"
        )
    if fg_k_cap:
        fg = gram_bands_topk(
            a_fg, levels=fg_levels, band_rel=band_rel, k_cap=fg_k_cap
        )
    else:
        fg = gram_bands(a_fg, levels=fg_levels, band_rel=band_rel)

    if with_thermal:
        y = whiten_apply_idpluslr(fg, a_signal)
    else:
        y = whiten_apply_floor(fg, a_signal, floor_rel=fg_floor)

    if sig_k_cap:
        yb = gram_bands_topk(
            y, levels=sig_levels, band_rel=band_rel, k_cap=sig_k_cap
        )
    else:
        yb = gram_bands(y, levels=sig_levels, band_rel=band_rel)
    u, sy = _select_complete_basis(yb)
    evals = sy * sy  # descending

    if with_thermal:
        v = whiten_apply_idpluslr(fg, u)
    else:
        v = whiten_apply_floor(fg, u, floor_rel=fg_floor)

    # ascending, to match jnp.linalg.eigh / the reference's eigh_gen
    evals = evals[..., ::-1].astype(in_dtype)
    v = za.Z(
        v.re[..., ::-1].astype(in_dtype), v.im[..., ::-1].astype(in_dtype)
    )
    return KLResult(evals, v)


# ------------------------------------------------------------------
# Dense f64 reference implementation (tests / CPU golden path)
# ------------------------------------------------------------------


def kl_solve_dense_ref(
    a_signal, a_fg, with_thermal=True, fg_floor=1e-6, fg_reg="additive"
):
    """Host complex/f64 direct solve of the same pencil (for validation).

    ``fg_reg`` selects the foreground-only regularisation:
    "additive" adds ``fg_floor * lambda_max(F)`` to the diagonal — the
    reference's own convention (eigh_gen adds a constant when the noise
    is not positive definite, /root/reference/drift/core/kltransform.py:100-119)
    and what :func:`kl_solve_qr` implements; "clamp" floors the
    eigenvalues of F instead (the gram engine's whiten_apply_floor).
    """
    import scipy.linalg as sla

    a_s = np.asarray(a_signal, dtype=np.complex128)
    a_f = np.asarray(a_fg, dtype=np.complex128)
    n = a_s.shape[0]
    S = a_s @ a_s.conj().T
    F = a_f @ a_f.conj().T
    if with_thermal:
        N = F + np.eye(n)
    elif fg_reg == "additive":
        lmax = np.linalg.eigvalsh(0.5 * (F + F.conj().T)).max()
        N = F + fg_floor * lmax * np.eye(n)
    else:
        w, q = np.linalg.eigh(0.5 * (F + F.conj().T))
        w = np.maximum(w, fg_floor * w.max())
        N = (q * w) @ q.conj().T
    evals, evecs = sla.eigh(0.5 * (S + S.conj().T), 0.5 * (N + N.conj().T))
    return evals, evecs
