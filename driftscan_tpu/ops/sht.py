"""Batched spherical harmonic transforms on the accelerator.

This replaces libsharp/healpy (used by the reference through
``cora.util.hputil`` at /root/reference/drift/core/telescope.py:1189,1300
and /root/reference/drift/pipeline/timestream.py:262,295,451,717) with a
from-scratch JAX implementation built from batched matmuls:

* ring phase stage — ``F_m(r) = sum_{p in ring r} f(p) e^{-i m phi_p}`` is
  evaluated as a batch-of-rings complex matmul ``(B, j) @ (j, m)`` over the
  padded (ring, slot) pixel layout, chunked over m to bound memory;
* Legendre stage — ``a_lm = Omega_pix sum_r lambda_lm(theta_r) F_m(r)`` is
  a per-m ``(l, ring) @ (ring, B)`` matmul.  The normalised associated
  Legendre functions are generated on device by the standard three-term
  recurrence in l, vectorised over (m-chunk, ring), with dynamic rescaling
  ("extended range" trick) so polar rings at large m neither underflow nor
  poison the upward recurrence.

Conventions: Condon-Shortley phase, orthonormal (healpy-compatible)
harmonics, so ``Y_{l,-m} = (-1)^m conj(Y_lm)`` — the identity the m-mode
packing relies on (/root/reference/drift/core/beamtransfer.py:620-624).

Quadrature is equal-area pixel weighting (a_lm ~= Omega_pix * sum_p f Y*);
optional Jacobi iterations refine it like healpy's ``iter`` parameter.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .healpix import RingGeometry, nside_for_lmax, ring_geometry

# Matmul precision of the split-path phase/Legendre contractions — the
# FLOP bulk of the BTM phase.  None inherits the library default
# (jax_default_matmul_precision=highest: full f32, no TF32).  Any other
# value must keep the beam_m accuracy tier (rel 1e-4, reference
# tests/test_functional.py:29-31).  Module state read at trace time
# (like fpencil._FILTER_PRECISION); a change requires clearing the jit
# caches of the entry points.
_SHT_PRECISION = os.environ.get("DRIFTSCAN_TPU_SHT_PRECISION") or None


def _pein(subscripts, *operands):
    """einsum at the SHT precision switch (hot split-path stages only)."""
    return jnp.einsum(subscripts, *operands, precision=_SHT_PRECISION)

# Rescaling bounds for the Legendre recurrence.  They fit the *f32
# exponent range*, so the same recurrence serves f32 tables
# (single_precision telescopes) and f64 ones.  The recurrence grows
# mantissas by at most ~sqrt(4*lmax) per step, so a 1e30 ceiling leaves
# ample headroom within the ~3.4e38 f32 limit.
_BIG = 1e30
_SMALL = 1e-30
_LOG_BIG = float(np.log(_BIG))
# exp() underflow guard within f32 exponent range
_LOG_TINY = -87.0


@functools.lru_cache(maxsize=64)
def _log_lambda_mm_prefactor(mmax: int) -> np.ndarray:
    """log lambda_mm(theta) = pref[m] + m*log(sin theta); sign is (-1)^m."""
    m = np.arange(mmax + 1, dtype=np.float64)
    ratio = np.zeros(mmax + 1)
    if mmax > 0:
        k = np.arange(1, mmax + 1, dtype=np.float64)
        ratio[1:] = np.cumsum(np.log((2 * k - 1) / (2 * k)))
    return 0.5 * (np.log((2 * m + 1) / (4 * np.pi)) + ratio)


def _legendre_chunk(mvals, cos_t, sin_t, lmax: int, logpref):
    """Normalised associated Legendre table for a chunk of m values.

    Parameters
    ----------
    mvals : (mc,) int32
        The m values of this chunk (may include padding entries > lmax,
        which produce zero rows).
    cos_t, sin_t : (nring,) float64
    lmax : static int
    logpref : (mmax+1,) float64 table from :func:`_log_lambda_mm_prefactor`.

    Returns
    -------
    lam : (lmax+1, mc, nring) float64
        ``lam[l, i, r] = lambda_{l, mvals[i]}(theta_r)`` (0 for l < m).
    """
    mc = mvals.shape[0]
    nring = cos_t.shape[0]
    f64 = jnp.float64

    m_f = mvals.astype(f64)[:, None]  # (mc, 1)
    x = cos_t[None, :].astype(f64)  # (1, nring)
    # (healpix rings never reach the poles, so sin_t > 0; the floor only
    # guards hypothetical zero inputs and must be f32-range-representable)
    log_sin = jnp.log(jnp.maximum(sin_t, 1e-30))[None, :].astype(f64)

    # log lambda_mm per (m, ring); sign (-1)^m
    safe_m = jnp.clip(mvals, 0, logpref.shape[0] - 1)
    log_lmm = logpref[safe_m][:, None] + m_f * log_sin  # (mc, nring)
    sign = jnp.where(mvals[:, None] % 2 == 0, 1.0, -1.0).astype(f64)

    ls = jnp.arange(lmax + 1)

    def step(carry, l):
        u0, u1, s = carry  # lambda_{l-2}, lambda_{l-1} mantissas, log-scale
        l_f = l.astype(f64)

        # Recurrence coefficients (guard the l<=m region against div-by-0)
        denom = jnp.maximum(l_f * l_f - m_f * m_f, 1.0)
        a = jnp.sqrt(jnp.maximum(4.0 * l_f * l_f - 1.0, 0.0) / denom)
        b = jnp.sqrt(
            jnp.maximum((l_f - 1.0) ** 2 - m_f * m_f, 0.0)
            / jnp.maximum(4.0 * (l_f - 1.0) ** 2 - 1.0, 1.0)
        )
        u_rec = a * (x * u1 - b * u0)

        is_seed = l == mvals[:, None]  # (mc, 1) broadcasting over rings
        is_next = l == mvals[:, None] + 1
        below = l < mvals[:, None]

        # Seed: mantissa = sign, scale = log|lambda_mm|
        u_new = jnp.where(
            is_seed,
            sign * jnp.ones_like(u_rec),
            jnp.where(is_next, x * jnp.sqrt(2.0 * m_f + 3.0) * u1, u_rec),
        )
        u_new = jnp.where(below, 0.0, u_new)
        s_new = jnp.where(is_seed, log_lmm, s)

        # Rescale to keep mantissas in range
        mx = jnp.maximum(jnp.abs(u_new), jnp.abs(u1))
        up = mx > _BIG
        down = (mx > 0.0) & (mx < _SMALL)
        factor = jnp.where(up, _SMALL, jnp.where(down, _BIG, 1.0))
        dlog = jnp.where(up, _LOG_BIG, jnp.where(down, -_LOG_BIG, 0.0))

        u1_out = u_new * factor
        # Previous-value mantissa: below the seed the carry is all zeros, so
        # this is consistent at the seed step too (u1 == 0 there).
        u0_out = u1 * factor
        s_out = s_new + dlog

        # Emit the true value entirely in the log domain:
        # lambda = sign(u) * exp(s + log|u|).  Polar-ring values whose true
        # magnitude underflows the f32 exponent range emit exactly 0 (they
        # are physically negligible); no intermediate ever leaves range.
        loglam = s_out + jnp.log(jnp.maximum(jnp.abs(u1_out), _SMALL * _SMALL))
        lam_l = jnp.where(
            loglam > _LOG_TINY,
            jnp.sign(u1_out) * jnp.exp(jnp.maximum(loglam, _LOG_TINY)),
            0.0,
        )

        return (u0_out, u1_out, s_out), lam_l

    zeros = jnp.zeros((mc, nring), dtype=f64)
    init = (zeros, zeros, jnp.full((mc, nring), -1e6, dtype=f64))
    _, lam = jax.lax.scan(step, init, ls)
    return lam  # (lmax+1, mc, nring)



class GeomArrays(NamedTuple):
    """Device-resident healpix ring geometry, passed to the jitted SHT
    kernels as *arguments*: embedded as HLO constants they would
    serialize to ~60+ MB per program at nside 512."""

    pix_index: jnp.ndarray  # (nring, maxlen) int32 gather map
    mask: jnp.ndarray       # (nring, maxlen) f32 validity
    twoj_h: jnp.ndarray     # (nring, maxlen) int32 azimuth numerators
    n2: jnp.ndarray         # (nring,) int32 azimuth denominators
    cos_theta: jnp.ndarray  # (nring,) f64
    sin_theta: jnp.ndarray  # (nring,) f64
    valid: jnp.ndarray      # (npix,) int32 scatter-back indices


_GEOM_DEV_CACHE = {}


def geom_arrays(nside: int) -> GeomArrays:
    """Cached device copies of the ring geometry tables for ``nside``."""
    g = _GEOM_DEV_CACHE.get(nside)
    if g is None:
        geom = ring_geometry(nside)
        g = GeomArrays(
            pix_index=jnp.asarray(np.asarray(geom.pix_index, np.int32)),
            mask=jnp.asarray(np.asarray(geom.mask, np.float32)),
            twoj_h=jnp.asarray(np.asarray(geom.twoj_h, np.int32)),
            n2=jnp.asarray(np.asarray(geom.n2, np.int32)),
            cos_theta=jnp.asarray(np.asarray(geom.cos_theta, np.float64)),
            sin_theta=jnp.asarray(np.asarray(geom.sin_theta, np.float64)),
            valid=jnp.asarray(
                np.nonzero(np.asarray(geom.mask).ravel())[0].astype(np.int32)
            ),
        )
        _GEOM_DEV_CACHE[nside] = g
    return g


def _phase_angle_tables(tj, n2_rows, mv, rdtype, promote: bool):
    """m*phi reduced mod 2*pi in integer arithmetic, returned as rdtype.

    phi[r, j] = 2*pi * tj[r, j] / n2[r] exactly (healpix azimuths are
    rational in 2*pi), so (m*phi) mod 2*pi = 2*pi*((m mod n2)*tj mod
    n2)/n2 with every product bounded by n2^2 <= (8*nside-1)^2 —
    int32-safe through nside 4096; above that (``promote``) the product
    goes through int64 before the mod (the reduced residue still fits
    int32).  An f32 angle in [0, 2*pi) then carries full f32 accuracy at
    any m, where the unreduced f64 product (the previous implementation)
    needed an f64 phase tensor twice the size and twice the bandwidth.
    """
    n2 = n2_rows[None, :, None]  # (1, R, 1) int32
    mmod = (mv[:, None, None].astype(jnp.int32) % n2 + n2) % n2
    if promote:
        r = ((mmod.astype(jnp.int64) * tj[None]) % n2.astype(jnp.int64)).astype(
            jnp.int32
        )
    else:
        r = (mmod * tj[None]) % n2
    return r.astype(rdtype) * (2.0 * np.pi / n2.astype(rdtype))


def _phase_angle(mv, g: GeomArrays, nside: int, rdtype):
    """m*phi over the full ring set (see :func:`_phase_angle_tables`)."""
    return _phase_angle_tables(
        g.twoj_h,
        g.n2,
        mv,
        rdtype,
        promote=(8 * nside - 1) ** 2 > np.iinfo(np.int32).max,
    )


def _chunk_size(nring: int, maxlen: int, nm: int, budget_bytes=None) -> int:
    """m-chunk size keeping the phase tensor under ~budget_bytes.

    The phase-stage contraction is a batch of (maxlen x B) @ (maxlen x mc)
    matmuls per ring, so mc is a matmul dimension: it is kept >= 64 so
    the products stay large enough to run near the matmul rate.  The
    budget is overridable (``DRIFTSCAN_TPU_SHT_MCHUNK_MB``): at large
    nside a smaller chunk also compiles faster.
    """
    if budget_bytes is None:
        budget_bytes = int(
            float(os.environ.get("DRIFTSCAN_TPU_SHT_MCHUNK_MB", "1024")) * 2**20
        )
    per_m = nring * maxlen * 16
    mc = max(64, min(nm, budget_bytes // max(per_m, 1)))
    return int(mc)


def _pad_rings(maps, geom: RingGeometry):
    """Gather (..., npix) maps into the padded (..., nring, maxlen) layout."""
    idx = jnp.asarray(geom.pix_index)
    mask = jnp.asarray(geom.mask)
    padded = jnp.take(maps, idx, axis=-1)
    return padded * mask.astype(padded.real.dtype)



def _scan_xs(m_chunks, lam_table):
    """Scan inputs with or without a precomputed Legendre table."""
    return m_chunks if lam_table is None else (m_chunks, lam_table)


def _split_xs(xs):
    if isinstance(xs, tuple):
        return xs
    return xs, None


_LEGENDRE_DEV_CACHE = {}


@functools.lru_cache(maxsize=1)
def _legendre_chunk_jit():
    """One shared jitted wrapper for table builds: a fresh ``jax.jit``
    per build would retrace (and recompile below the persistent-cache
    floor) on every m-window of a streaming run."""
    return jax.jit(_legendre_chunk, static_argnames=("lmax",))


def clear_legendre_cache():
    """Drop all device-cached Legendre tables (frees their device memory).

    m-windowed runs build per-window tables that are never reused once
    the window completes; callers interleaving windowed SHTs with other
    memory-hungry phases (the resident product pipeline) clear between
    phases instead of waiting for LRU eviction at the next build.
    """
    _LEGENDRE_DEV_CACHE.clear()


def pad_map(maps, nside: int):
    """Gather (..., npix) RING maps into the flat padded (ring, slot)
    layout (..., nring*maxlen) — the layout the SHT kernels consume.

    Host-side numpy in, numpy out (producers that live on device keep
    their whole pipeline padded instead — see TransitTelescope._init_trans).
    """
    geom = ring_geometry(nside)
    maps = np.asarray(maps)
    out = maps[..., np.asarray(geom.pix_index).ravel()]
    return out * np.asarray(geom.mask).ravel().astype(maps.real.dtype)


def unpad_map(padded, nside: int):
    """Inverse of :func:`pad_map`: flat padded layout -> (..., npix)."""
    geom = ring_geometry(nside)
    valid = np.nonzero(np.asarray(geom.mask).ravel())[0]
    return np.asarray(padded)[..., valid]


def _legendre_table(geom, lmax: int, mmax: int, rdtype, m_start: int = 0):
    """Device-cached Legendre table, chunked to match the m scan.

    The recurrence depends only on (nside, lmax, m) — recomputing it
    inside every analysis/synthesis call makes the scan's 300+ tiny
    sequential steps the dominant cost of large-nside SHTs.  The table is built
    once per (nside, lmax, mmax, m_start, dtype) and reused as a scan
    input; shape (nchunks, lmax+1, mc, nring), covering the mmax+1 m
    values starting at ``m_start`` (an m-window: columns at m > lmax
    are exactly zero).  ``DRIFTSCAN_TPU_LEGENDRE_CACHE_GB`` (default
    1.0) bounds the *total* bytes cached across all keys: older tables
    are LRU-evicted to make room, and a single table larger than the
    whole budget returns None (callers fall back to the in-scan
    recurrence).
    """
    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    nbytes = nchunks * mc * (lmax + 1) * geom.nring * np.dtype(rdtype).itemsize
    budget = float(os.environ.get("DRIFTSCAN_TPU_LEGENDRE_CACHE_GB", "1.0")) * 2**30
    if nbytes > budget:
        return None

    # mc is env-dependent (DRIFTSCAN_TPU_SHT_MCHUNK_MB, read per call):
    # it must be part of the key or an in-process budget change returns
    # a table whose leading chunk dim mismatches the scan's m_chunks
    key = (geom.nside, lmax, mmax, int(m_start), mc, np.dtype(rdtype).name)
    tab = _LEGENDRE_DEV_CACHE.get(key)
    if tab is not None:
        # LRU: refresh position on hit so reused tables survive eviction.
        _LEGENDRE_DEV_CACHE.pop(key)
        _LEGENDRE_DEV_CACHE[key] = tab
    if tab is None:
        # Evict least-recently-used tables until this one fits the budget.
        total = sum(int(t.nbytes) for t in _LEGENDRE_DEV_CACHE.values())
        while _LEGENDRE_DEV_CACHE and total + nbytes > budget:
            old = _LEGENDRE_DEV_CACHE.pop(next(iter(_LEGENDRE_DEV_CACHE)))
            total -= int(old.nbytes)
            del old
        # logpref must cover the largest m in the window; rows at
        # m > lmax stay identically zero (the recurrence never seeds).
        logpref = jnp.asarray(
            _log_lambda_mm_prefactor(max(lmax, m_start + mmax))
        )
        cos_t = jnp.asarray(geom.cos_theta)
        sin_t = jnp.asarray(geom.sin_theta)
        fn = _legendre_chunk_jit()
        chunks = [
            fn(
                m_start + jnp.arange(c * mc, (c + 1) * mc, dtype=jnp.int64),
                cos_t,
                sin_t,
                lmax,
                logpref,
            ).astype(rdtype)
            for c in range(nchunks)
        ]
        tab = jnp.stack(chunks)
        _LEGENDRE_DEV_CACHE[key] = tab
    return tab


@functools.partial(
    jax.jit,
    static_argnames=("nside", "lmax", "mmax", "neg_m", "ring_padded"),
)
def _analysis(maps, g, nside: int, lmax: int, mmax: int, neg_m: bool, lam_table=None, ring_padded: bool = False):
    """Core forward SHT.

    Parameters
    ----------
    maps : (B, npix) real or complex
    neg_m : also compute the negative-m coefficients (required for complex
        fields; for real fields they follow from conjugation).

    Returns
    -------
    alm_pos : (B, lmax+1, mmax+1) complex — coefficients for m >= 0
    alm_neg : (B, lmax+1, mmax) complex or None — coefficients for
        m = -1, -2, ..., -mmax (only if ``neg_m``)
    """
    geom = ring_geometry(nside)
    double = maps.dtype.itemsize >= (16 if jnp.iscomplexobj(maps) else 8)
    cdtype = jnp.complex128 if double else jnp.complex64
    rdtype = jnp.float64 if double else jnp.float32

    if ring_padded:
        shp = maps.shape[:-1] + (geom.nring, geom.maxlen)
        padded = (maps.reshape(shp) * g.mask.astype(rdtype)).astype(cdtype)
    else:
        padded = (
            jnp.take(maps, g.pix_index, axis=-1) * g.mask.astype(rdtype)
        ).astype(cdtype)
    mask = g.mask
    cos_t = g.cos_theta
    sin_t = g.sin_theta
    logpref = jnp.asarray(_log_lambda_mm_prefactor(lmax))

    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    m_padded = np.arange(nchunks * mc, dtype=np.int64)
    m_chunks = jnp.asarray(m_padded.reshape(nchunks, mc))

    pixarea = jnp.asarray(geom.pixarea, dtype=rdtype)

    def chunk_fn(_, xs):
        mv, lam = _split_xs(xs)
        # Phase stage: F[b, i, r] = sum_j padded[b, r, j] exp(-i m_i phi_rj).
        # The angle is integer-range-reduced so the whole stage (including
        # cos/sin) runs in the compute dtype with full accuracy, and no
        # complex128 intermediate appears in a single-precision run.
        phase = _phase_angle(mv, g, nside, rdtype)
        mr = mask[None].astype(rdtype)
        e_neg = jax.lax.complex(
            jnp.cos(phase) * mr, -jnp.sin(phase) * mr
        )  # (mc, nring, maxlen)
        F = jnp.einsum("brj,mrj->bmr", padded, e_neg)
        if lam is None:
            lam = _legendre_chunk(mv, cos_t, sin_t, lmax, logpref).astype(rdtype)
        # Legendre stage: a[b, l, i] = Omega * sum_r lam[l, i, r] F[b, i, r]
        a_pos = pixarea * jnp.einsum("lmr,bmr->blm", lam, F)
        if neg_m:
            G = jnp.einsum("brj,mrj->bmr", padded, jnp.conj(e_neg))
            signm = jnp.where(mv % 2 == 0, 1.0, -1.0).astype(rdtype)
            a_neg = pixarea * jnp.einsum("lmr,bmr->blm", lam, G * signm[None, :, None])
            return None, (a_pos, a_neg)
        return None, (a_pos, None)

    xs = _scan_xs(m_chunks, lam_table)
    if neg_m:
        _, (a_pos, a_neg) = jax.lax.scan(chunk_fn, None, xs)
        a_pos = jnp.moveaxis(a_pos, 0, -2).reshape(
            maps.shape[0], lmax + 1, nchunks * mc
        )[..., :nm]
        a_neg = jnp.moveaxis(a_neg, 0, -2).reshape(
            maps.shape[0], lmax + 1, nchunks * mc
        )[..., 1 : mmax + 1]
        return a_pos, a_neg
    _, (a_pos, _) = jax.lax.scan(chunk_fn, None, xs)
    a_pos = jnp.moveaxis(a_pos, 0, -2).reshape(maps.shape[0], lmax + 1, nchunks * mc)[
        ..., :nm
    ]
    return a_pos, None


@functools.partial(jax.jit, static_argnames=("nside", "lmax", "mmax"))
def _synthesis_real(alm, g, nside: int, lmax: int, mmax: int, lam_table=None):
    """Inverse SHT onto a real field.

    Parameters
    ----------
    alm : (B, lmax+1, mmax+1) complex, m >= 0 coefficients of a real field.

    Returns
    -------
    maps : (B, npix) real
    """
    geom = ring_geometry(nside)
    cdtype = alm.dtype
    rdtype = jnp.float64 if alm.dtype.itemsize >= 16 else jnp.float32

    mask = g.mask
    cos_t = g.cos_theta
    sin_t = g.sin_theta
    logpref = jnp.asarray(_log_lambda_mm_prefactor(lmax))

    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    m_padded = np.arange(nchunks * mc, dtype=np.int64)
    m_chunks = jnp.asarray(m_padded.reshape(nchunks, mc))

    B = alm.shape[0]
    alm_pad = jnp.pad(alm, ((0, 0), (0, 0), (0, nchunks * mc - nm)))
    alm_chunks = jnp.moveaxis(
        alm_pad.reshape(B, lmax + 1, nchunks, mc), 2, 0
    )  # (nchunks, B, l, mc)

    def chunk_fn(acc, xs):
        if len(xs) == 3:
            mv, a_chunk, lam = xs
        else:
            mv, a_chunk = xs
            lam = _legendre_chunk(mv, cos_t, sin_t, lmax, logpref).astype(rdtype)
        # T[b, i, r] = sum_l lam[l, i, r] a[b, l, i]
        T = jnp.einsum("lmr,blm->bmr", lam, a_chunk)
        phase = _phase_angle(mv, g, nside, rdtype)
        mr = mask[None].astype(rdtype)
        e_pos = jax.lax.complex(jnp.cos(phase) * mr, jnp.sin(phase) * mr)
        weight = jnp.where(mv == 0, 1.0, 2.0).astype(rdtype)  # m>0 counted twice
        contrib = jnp.einsum("bmr,mrj->brj", T * weight[None, :, None], e_pos)
        return acc + contrib.real.astype(rdtype), None

    acc0 = jnp.zeros((B, geom.nring, geom.maxlen), dtype=rdtype)
    xs = (
        (m_chunks, alm_chunks)
        if lam_table is None
        else (m_chunks, alm_chunks, lam_table)
    )
    acc, _ = jax.lax.scan(chunk_fn, acc0, xs)

    # Scatter the padded ring layout back to RING pixel order.
    flat = acc.reshape(B, -1)
    return flat[:, g.valid]


@functools.partial(jax.jit, static_argnames=("nside", "lmax", "mmax"))
def _synthesis_complex(alm_pos, alm_neg, g, nside: int, lmax: int, mmax: int, lam_table=None):
    """Inverse SHT of a general complex field.

    f(p) = sum_{m>=0} T+_m(r) e^{i m phi} + sum_{m>0} T-_m(r) e^{-i m phi}
    with T+_m = sum_l lam_lm a_lm and T-_m = (-1)^m sum_l lam_lm a_{l,-m}.
    """
    geom = ring_geometry(nside)
    cdtype = alm_pos.dtype
    rdtype = jnp.float64 if alm_pos.dtype.itemsize >= 16 else jnp.float32

    mask = g.mask
    cos_t = g.cos_theta
    sin_t = g.sin_theta
    logpref = jnp.asarray(_log_lambda_mm_prefactor(lmax))

    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    m_padded = np.arange(nchunks * mc, dtype=np.int64)
    m_chunks = jnp.asarray(m_padded.reshape(nchunks, mc))

    B = alm_pos.shape[0]
    pos_pad = jnp.pad(alm_pos, ((0, 0), (0, 0), (0, nchunks * mc - nm)))
    # Shift the negative block so column m holds a_{l,-m} (column 0 unused).
    neg_shift = jnp.pad(alm_neg, ((0, 0), (0, 0), (1, nchunks * mc - nm)))
    pos_chunks = jnp.moveaxis(pos_pad.reshape(B, lmax + 1, nchunks, mc), 2, 0)
    neg_chunks = jnp.moveaxis(neg_shift.reshape(B, lmax + 1, nchunks, mc), 2, 0)

    def chunk_fn(acc, xs):
        if len(xs) == 4:
            mv, a_p, a_n, lam = xs
        else:
            mv, a_p, a_n = xs
            lam = _legendre_chunk(mv, cos_t, sin_t, lmax, logpref).astype(rdtype)
        t_pos = jnp.einsum("lmr,blm->bmr", lam, a_p)
        t_neg = jnp.einsum("lmr,blm->bmr", lam, a_n)
        signm = jnp.where(mv % 2 == 0, 1.0, -1.0).astype(rdtype)
        t_neg = t_neg * signm[None, :, None]
        phase = _phase_angle(mv, g, nside, rdtype)
        mr = mask[None].astype(rdtype)
        e_pos = jax.lax.complex(jnp.cos(phase) * mr, jnp.sin(phase) * mr)
        contrib = jnp.einsum("bmr,mrj->brj", t_pos, e_pos)
        contrib += jnp.einsum("bmr,mrj->brj", t_neg, jnp.conj(e_pos))
        return acc + contrib, None

    acc0 = jnp.zeros((B, geom.nring, geom.maxlen), dtype=cdtype)
    xs = (
        (m_chunks, pos_chunks, neg_chunks)
        if lam_table is None
        else (m_chunks, pos_chunks, neg_chunks, lam_table)
    )
    acc, _ = jax.lax.scan(chunk_fn, acc0, xs)
    flat = acc.reshape(B, -1)
    return flat[:, g.valid]


@functools.partial(
    jax.jit,
    static_argnames=(
        "nside", "lmax", "mmax", "neg_m", "real_field", "uniform_neg",
        "ring_padded",
    ),
)
def _analysis_split(
    maps_re,
    maps_im,
    g,
    nside: int,
    lmax: int,
    mmax: int,
    neg_m: bool,
    lam_table=None,
    real_field: bool = False,
    uniform_neg: bool = False,
    m_lo=None,
    ring_padded: bool = False,
):
    """Split-complex forward SHT on (re, im) planes.

    Identical math to :func:`_analysis`, with the complex phase/Legendre
    contractions expanded into real einsums on (re, im) planes — the same
    FLOP count, all matmuls.  With ``real_field`` the imaginary
    plane is ignored (may be None) and its einsums are skipped — half the
    phase-stage work.

    ``m_lo`` (a *traced* scalar, so every same-width window shares one
    compiled program) shifts the computation to the m-window
    [m_lo, m_lo + mmax]: the m-chunk scan simply starts there, so a
    window costs its share of the full transform — the memory-streaming
    axis for band limits whose full (l, m) coefficient tables exceed
    device memory.  ``uniform_neg`` selects the window layout for the negative
    block (column j <-> m = m_lo + j, same width as pos; any m = 0
    column is zeroed by the caller); otherwise the legacy layout
    (column j <-> m = j + 1, requires m_lo = 0).

    Returns (pos_re, pos_im, neg_re, neg_im); the negative blocks are
    zeros when ``neg_m`` is False.
    """
    geom = ring_geometry(nside)
    rdtype = maps_re.dtype

    maskr = g.mask.astype(rdtype)
    if ring_padded:
        # maps are already in the padded (ring, slot) layout — a pure
        # reshape, instead of a per-call 200M-element pad *gather* at
        # nside 1024; producers keep the pixel grid padded.
        shp = maps_re.shape[:-1] + (geom.nring, geom.maxlen)
        p_re = maps_re.reshape(shp) * maskr
        p_im = None if real_field else maps_im.reshape(shp) * maskr
    else:
        idx = g.pix_index
        p_re = jnp.take(maps_re, idx, axis=-1) * maskr
        p_im = None if real_field else jnp.take(maps_im, idx, axis=-1) * maskr

    cos_t = g.cos_theta
    sin_t = g.sin_theta
    logpref = jnp.asarray(_log_lambda_mm_prefactor(lmax))

    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    m_chunks = jnp.asarray(
        np.arange(nchunks * mc, dtype=np.int64).reshape(nchunks, mc)
    )
    if m_lo is not None:
        m_chunks = m_chunks + jnp.asarray(m_lo, jnp.int64)

    pixarea = jnp.asarray(geom.pixarea, dtype=rdtype)

    # Belt/cap split for the phase stage.  The equatorial belt (rows
    # nside-1 .. 3*nside-1, 2/3 of all pixels) has a CONSTANT ring
    # length (4*nside) and only TWO azimuth offsets (phi0 in
    # {pi/J, 0}, strictly alternating starting with pi/J) — so its
    # phase projection is two big (B*nbelt, J) @ (J, mc) matmuls
    # against (mc, J) tables instead of ~2*nside tiny per-ring matmuls
    # against a (mc, nring, J) tensor.  Only the polar caps (1/3 of
    # pixels) keep the general per-ring path.
    J = geom.maxlen
    ncap_n = nside - 1
    belt_lo, belt_hi = nside - 1, 3 * nside
    nb = belt_hi - belt_lo
    cap_tj = jnp.concatenate([g.twoj_h[:ncap_n], g.twoj_h[belt_hi:]], axis=0)
    cap_n2 = jnp.concatenate([g.n2[:ncap_n], g.n2[belt_hi:]], axis=0)
    cap_mask = jnp.concatenate([maskr[:ncap_n], maskr[belt_hi:]], axis=0)

    def chunk_fn(_, xs):
        mv, lam_xs = _split_xs(xs)

        cs_b, ss_b = _belt_phase_tables(mv, J, rdtype)
        cap_phase = _phase_angle_tables(
            cap_tj, cap_n2, mv, rdtype,
            promote=(8 * nside - 1) ** 2 > np.iinfo(np.int32).max,
        )
        c_cap = jnp.cos(cap_phase) * cap_mask[None]
        s_cap = jnp.sin(cap_phase) * cap_mask[None]

        def project(p):
            """(B, nring, J) -> (p.c, p.s) stitched (B, mc, nring)."""
            pb = [
                p[:, belt_lo:belt_hi:2],  # parity pi/J rows
                p[:, belt_lo + 1 : belt_hi : 2],
            ]
            pc = jnp.concatenate([p[:, :ncap_n], p[:, belt_hi:]], axis=1)

            outs = []
            for tabs in (cs_b, ss_b):
                belt = jnp.zeros((p.shape[0], mv.shape[0], nb), dtype=rdtype)
                for blk, tab, off in zip(pb, tabs, (0, 1)):
                    proj = _pein("bnj,mj->bmn", blk, tab)
                    belt = belt.at[..., off::2].set(proj)
                outs.append(belt)
            c_all, s_all = outs

            if ncap_n > 0:
                capc = _pein("brj,mrj->bmr", pc, c_cap)
                caps = _pein("brj,mrj->bmr", pc, s_cap)
                c_all = jnp.concatenate(
                    [capc[..., :ncap_n], c_all, capc[..., ncap_n:]], axis=-1
                )
                s_all = jnp.concatenate(
                    [caps[..., :ncap_n], s_all, caps[..., ncap_n:]], axis=-1
                )
            return c_all, s_all

        # F = sum_j p e^{-im phi}:  F.re = pr.c + pi.s ; F.im = pi.c - pr.s
        rc, rs = project(p_re)
        if real_field:
            ic = is_ = jnp.zeros_like(rc)
        else:
            ic, is_ = project(p_im)
        f_re = rc + is_
        f_im = ic - rs

        lam = (
            lam_xs
            if lam_xs is not None
            else _legendre_chunk(mv, cos_t, sin_t, lmax, logpref).astype(rdtype)
        )
        a_re = pixarea * _pein("lmr,bmr->blm", lam, f_re)
        a_im = pixarea * _pein("lmr,bmr->blm", lam, f_im)

        if neg_m:
            # G = sum_j p e^{+im phi}: G.re = pr.c - pi.s ; G.im = ic + rs
            g_re = rc - is_
            g_im = ic + rs
            signm = jnp.where(mv % 2 == 0, 1.0, -1.0).astype(rdtype)
            n_re = pixarea * _pein(
                "lmr,bmr->blm", lam, g_re * signm[None, :, None]
            )
            n_im = pixarea * _pein(
                "lmr,bmr->blm", lam, g_im * signm[None, :, None]
            )
            return None, (a_re, a_im, n_re, n_im)
        return None, (a_re, a_im, a_re[..., :0], a_im[..., :0])

    _, (a_re, a_im, n_re, n_im) = jax.lax.scan(
        chunk_fn, None, _scan_xs(m_chunks, lam_table)
    )

    B = maps_re.shape[0]

    def _stitch(x, take):
        x = jnp.moveaxis(x, 0, -2).reshape(B, lmax + 1, -1)
        return x[..., :take]

    pos_re = _stitch(a_re, nm)
    pos_im = _stitch(a_im, nm)
    if neg_m and not uniform_neg:
        # legacy layout: columns m = 1 .. mmax
        neg_re = _stitch(n_re, nm)[..., 1 : mmax + 1]
        neg_im = _stitch(n_im, nm)[..., 1 : mmax + 1]
    elif neg_m:
        # uniform window layout: column j <-> m = m_lo + j
        neg_re = _stitch(n_re, nm)
        neg_im = _stitch(n_im, nm)
    else:
        neg_re = jnp.zeros((B, lmax + 1, 0), dtype=rdtype)
        neg_im = jnp.zeros((B, lmax + 1, 0), dtype=rdtype)
    return pos_re, pos_im, neg_re, neg_im


def _belt_phase_tables(mv, J, rdtype):
    """cos/sin((m * pi * (2j + par)) / J mod 2pi) per belt parity.

    Returns (cs, ss), each a [par=pi/J, par=0] list of (mc, J) tables —
    the same integer range reduction as the analysis belt stage.
    """
    n2b = 2 * J
    int64_belt = (2 * J) ** 2 > np.iinfo(np.int32).max
    mmod = (mv % n2b).astype(jnp.int64 if int64_belt else jnp.int32)
    tj = jnp.arange(J, dtype=mmod.dtype) * 2
    cs, ss = [], []
    for par in (1, 0):  # belt parity alternates pi/J, 0, pi/J, ...
        r = (mmod[:, None] * (tj[None, :] + par)) % n2b
        ang = r.astype(rdtype) * rdtype.type(np.pi / J)
        cs.append(jnp.cos(ang))
        ss.append(jnp.sin(ang))
    return cs, ss


def _cap_arrays(g, nside: int, rdtype):
    """m-invariant polar-cap geometry (rows outside the belt), hoisted
    out of the per-chunk scan bodies: the concatenations are ~33 MB of
    int32 at nside 1024 and must not be re-materialised per m-chunk."""
    ncap_n = nside - 1
    belt_hi = 3 * nside
    maskr = g.mask.astype(rdtype)
    cap_tj = jnp.concatenate([g.twoj_h[:ncap_n], g.twoj_h[belt_hi:]], axis=0)
    cap_n2 = jnp.concatenate([g.n2[:ncap_n], g.n2[belt_hi:]], axis=0)
    cap_mask = jnp.concatenate([maskr[:ncap_n], maskr[belt_hi:]], axis=0)
    return cap_tj, cap_n2, cap_mask


def _phase_unproject(t_c, t_s, mv, g, nside: int, rdtype, cap=None):
    """out[b, r, j] = sum_m t_c[b,m,r] cos(m phi_rj) + t_s[b,m,r] sin(..).

    The synthesis-side phase stage, belt/cap split exactly like the
    analysis projection (see _analysis_split): the equatorial belt's
    constant ring length and two alternating azimuth offsets collapse
    its per-ring einsums into two (B*nbelt, mc) @ (mc, J) matmuls;
    only the polar caps keep the general per-ring contraction with a
    half-size phase tensor.  Invalid cap slots come out zero (the cap
    tables are masked); belt rows are always full.
    """
    geom = ring_geometry(nside)
    J = geom.maxlen
    ncap_n = nside - 1
    belt_lo, belt_hi = nside - 1, 3 * nside
    maskr = g.mask.astype(rdtype)
    B = t_c.shape[0]

    cs_b, ss_b = _belt_phase_tables(mv, J, rdtype)
    out = jnp.zeros((B, geom.nring, J), dtype=rdtype)
    for off, ctab, stab in zip((0, 1), cs_b, ss_b):
        tc = t_c[:, :, belt_lo + off : belt_hi : 2]  # (B, mc, nb_par)
        ts = t_s[:, :, belt_lo + off : belt_hi : 2]
        blk = _pein("bmn,mj->bnj", tc, ctab)
        blk = blk + _pein("bmn,mj->bnj", ts, stab)
        out = out.at[:, belt_lo + off : belt_hi : 2].set(blk)

    if ncap_n > 0:
        cap_tj, cap_n2, cap_mask = (
            cap if cap is not None else _cap_arrays(g, nside, rdtype)
        )
        cap_phase = _phase_angle_tables(
            cap_tj, cap_n2, mv, rdtype,
            promote=(8 * nside - 1) ** 2 > np.iinfo(np.int32).max,
        )
        c_cap = jnp.cos(cap_phase) * cap_mask[None]
        s_cap = jnp.sin(cap_phase) * cap_mask[None]
        tcc = jnp.concatenate([t_c[:, :, :ncap_n], t_c[:, :, belt_hi:]], axis=2)
        tsc = jnp.concatenate([t_s[:, :, :ncap_n], t_s[:, :, belt_hi:]], axis=2)
        cap = _pein("bmr,mrj->brj", tcc, c_cap)
        cap = cap + _pein("bmr,mrj->brj", tsc, s_cap)
        out = out.at[:, :ncap_n].set(cap[:, :ncap_n])
        out = out.at[:, belt_hi:].set(cap[:, ncap_n:])
    return out


@functools.partial(jax.jit, static_argnames=("nside", "lmax", "mmax"))
def _synthesis_real_split(a_re, a_im, g, nside: int, lmax: int, mmax: int, lam_table=None):
    """Split-complex inverse SHT onto a real field (complex-free backends).

    Same math as :func:`_synthesis_real` on (re, im) planes of the m >= 0
    coefficients: the map is sum_m w_m * Re(T_m e^{i m phi}) with
    w_0 = 1, w_{m>0} = 2.  Returns (B, npix) real.
    """
    geom = ring_geometry(nside)
    rdtype = a_re.dtype

    mask = g.mask
    cos_t = g.cos_theta
    sin_t = g.sin_theta
    logpref = jnp.asarray(_log_lambda_mm_prefactor(lmax))

    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    m_chunks = jnp.asarray(
        np.arange(nchunks * mc, dtype=np.int64).reshape(nchunks, mc)
    )

    B = a_re.shape[0]

    def to_chunks(x):
        x = jnp.pad(x, ((0, 0), (0, 0), (0, nchunks * mc - nm)))
        return jnp.moveaxis(x.reshape(B, lmax + 1, nchunks, mc), 2, 0)

    re_chunks, im_chunks = to_chunks(a_re), to_chunks(a_im)
    cap = _cap_arrays(g, nside, rdtype)  # hoisted: m-invariant

    def chunk_fn(acc, xs):
        if len(xs) == 4:
            mv, ar, ai, lam = xs
        else:
            mv, ar, ai = xs
            lam = _legendre_chunk(mv, cos_t, sin_t, lmax, logpref).astype(rdtype)
        t_re = _pein("lmr,blm->bmr", lam, ar)
        t_im = _pein("lmr,blm->bmr", lam, ai)
        weight = jnp.where(mv == 0, 1.0, 2.0).astype(rdtype)[None, :, None]
        # Re(T e^{i m phi}) = T.re * cos - T.im * sin
        contrib = _phase_unproject(
            t_re * weight, -(t_im * weight), mv, g, nside, rdtype, cap=cap
        )
        return acc + contrib, None

    acc0 = jnp.zeros((B, geom.nring, geom.maxlen), dtype=rdtype)
    xs = (
        (m_chunks, re_chunks, im_chunks)
        if lam_table is None
        else (m_chunks, re_chunks, im_chunks, lam_table)
    )
    acc, _ = jax.lax.scan(chunk_fn, acc0, xs)
    flat = acc.reshape(B, -1)
    return flat[:, g.valid]


@functools.partial(jax.jit, static_argnames=("nside", "lmax", "mmax"))
def _synthesis_complex_split(
    p_re, p_im, n_re, n_im, g, nside: int, lmax: int, mmax: int, lam_table=None
):
    """Split-complex inverse SHT of a general complex field.

    Same math as :func:`_synthesis_complex` on (re, im) planes; the
    negative block holds a_{l,-m} for m = 1..mmax.  Returns (map_re,
    map_im), each (B, npix).
    """
    geom = ring_geometry(nside)
    rdtype = p_re.dtype

    mask = g.mask
    cos_t = g.cos_theta
    sin_t = g.sin_theta
    logpref = jnp.asarray(_log_lambda_mm_prefactor(lmax))

    nm = mmax + 1
    mc = _chunk_size(geom.nring, geom.maxlen, nm)
    nchunks = (nm + mc - 1) // mc
    m_chunks = jnp.asarray(
        np.arange(nchunks * mc, dtype=np.int64).reshape(nchunks, mc)
    )

    B = p_re.shape[0]

    def pos_chunks(x):
        x = jnp.pad(x, ((0, 0), (0, 0), (0, nchunks * mc - nm)))
        return jnp.moveaxis(x.reshape(B, lmax + 1, nchunks, mc), 2, 0)

    def neg_chunks(x):
        # shift so column m holds a_{l,-m} (column 0 unused)
        x = jnp.pad(x, ((0, 0), (0, 0), (1, nchunks * mc - nm)))
        return jnp.moveaxis(x.reshape(B, lmax + 1, nchunks, mc), 2, 0)

    chunks = (
        pos_chunks(p_re), pos_chunks(p_im), neg_chunks(n_re), neg_chunks(n_im)
    )
    cap = _cap_arrays(g, nside, rdtype)  # hoisted: m-invariant

    def chunk_fn(acc, xs):
        if len(xs) == 6:
            mv, pr, pi, nr, ni, lam = xs
        else:
            mv, pr, pi, nr, ni = xs
            lam = _legendre_chunk(mv, cos_t, sin_t, lmax, logpref).astype(rdtype)
        tp_re = _pein("lmr,blm->bmr", lam, pr)
        tp_im = _pein("lmr,blm->bmr", lam, pi)
        signm = jnp.where(mv % 2 == 0, 1.0, -1.0).astype(rdtype)[None, :, None]
        tn_re = _pein("lmr,blm->bmr", lam, nr) * signm
        tn_im = _pein("lmr,blm->bmr", lam, ni) * signm
        # T+ e^{i m phi} + T- e^{-i m phi}
        acc_re, acc_im = acc
        acc_re = acc_re + _phase_unproject(
            tp_re + tn_re, -(tp_im - tn_im), mv, g, nside, rdtype, cap=cap
        )
        acc_im = acc_im + _phase_unproject(
            tp_im + tn_im, tp_re - tn_re, mv, g, nside, rdtype, cap=cap
        )
        return (acc_re, acc_im), None

    acc0 = (
        jnp.zeros((B, geom.nring, geom.maxlen), dtype=rdtype),
        jnp.zeros((B, geom.nring, geom.maxlen), dtype=rdtype),
    )
    xs = chunks if lam_table is None else chunks + (lam_table,)
    (acc_re, acc_im), _ = jax.lax.scan(chunk_fn, acc0, (m_chunks,) + xs)
    return (
        acc_re.reshape(B, -1)[:, g.valid],
        acc_im.reshape(B, -1)[:, g.valid],
    )


def analysis_split(
    maps_z,
    lmax: int,
    mmax: Optional[int] = None,
    neg_m: bool = False,
    m_window: Optional[tuple] = None,
    nside: Optional[int] = None,
    ring_padded: bool = False,
):
    """Forward SHT of split-complex maps (ops.zarray.Z in, Z out).

    maps_z : Z with arrays (..., npix) — or (..., nring*maxlen) with
    ``ring_padded=True`` (requires ``nside``), where the maps are
    already in the padded (ring, slot) layout (see :func:`pad_map`) and
    the slow entry gather is skipped.
    Returns (pos Z (..., lmax+1, mmax+1), neg Z (..., lmax+1, mmax) or None).

    ``m_window=(m0, m1)`` computes only the m in [m0, m1): the m-chunk
    scan starts at m0, so a window costs its share of the full
    transform.  Both outputs then have width m1 - m0 in the *uniform*
    layout (column j <-> m = m0 + j; the m = 0 negative column is
    zeroed) — the streaming axis for band limits whose full coefficient
    tables exceed device memory.
    """
    from . import zarray as za

    mmax = lmax if mmax is None else mmax
    npix = maps_z.re.shape[-1]
    if ring_padded:
        if nside is None:
            raise ValueError("ring_padded input requires explicit nside")
        geom = ring_geometry(nside)
        if npix != geom.nring * geom.maxlen:
            raise ValueError(
                f"padded npix {npix} != nring*maxlen for nside {nside}"
            )
    else:
        nside = int(np.sqrt(npix / 12))
        if 12 * nside * nside != npix:
            raise ValueError(f"npix {npix} is not a valid healpix size")

    lead = maps_z.re.shape[:-1]
    fr = maps_z.re.reshape((-1, npix))
    fi = maps_z.im.reshape((-1, npix))

    if m_window is not None:
        m0, m1 = int(m_window[0]), int(m_window[1])
        if not (0 <= m0 < m1):
            raise ValueError(f"invalid m_window {m_window}")
        # m1 may exceed mmax + 1: coefficients at m > lmax are exactly
        # zero (the Legendre recurrence has no l >= m rows there), so a
        # constant window width can be shared across band limits.
        width = m1 - m0
        # Window tables are cached per (nside, lmax, width, m0): in the
        # m-streaming runs every unit chunk of a (nside, lmax) bucket
        # re-enters the same window, and the in-scan recurrence's ~lmax
        # sequential tiny steps dominate the chunk cost at large nside
        # (the phase/Legendre matmuls are milliseconds).  m_lo is traced
        # and the table is a scan input: every same-shaped window reuses
        # one compiled program.
        lam = _legendre_table(
            ring_geometry(nside), lmax, width - 1, fr.dtype, m_start=m0
        )
        pr, pi, nr, ni = _analysis_split(
            fr, fi, geom_arrays(nside), nside, lmax, width - 1, neg_m, lam,
            uniform_neg=True, m_lo=np.int64(m0), ring_padded=ring_padded,
        )
        if m0 == 0 and neg_m:
            # the uniform m = 0 column is the (meaningless) conjugate
            # duplicate: zero it
            nr = nr.at[..., 0].set(0.0)
            ni = ni.at[..., 0].set(0.0)
        pos = za.Z(
            pr.reshape(lead + (lmax + 1, width)),
            pi.reshape(lead + (lmax + 1, width)),
        )
        if not neg_m:
            return pos, None
        neg = za.Z(
            nr.reshape(lead + (lmax + 1, width)),
            ni.reshape(lead + (lmax + 1, width)),
        )
        return pos, neg

    lam = _legendre_table(ring_geometry(nside), lmax, mmax, fr.dtype)
    pr, pi, nr, ni = _analysis_split(
        fr, fi, geom_arrays(nside), nside, lmax, mmax, neg_m, lam,
        ring_padded=ring_padded,
    )
    pos = za.Z(pr.reshape(lead + (lmax + 1, mmax + 1)), pi.reshape(lead + (lmax + 1, mmax + 1)))
    if not neg_m:
        return pos, None
    neg = za.Z(nr.reshape(lead + (lmax + 1, mmax)), ni.reshape(lead + (lmax + 1, mmax)))
    return pos, neg


def synthesis_split(pos_z, neg_z, nside: int):
    """Inverse SHT of split-complex coefficients (ops.zarray.Z in, Z out).

    pos_z : Z with arrays (..., lmax+1, mmax+1) — m >= 0 coefficients.
    neg_z : Z with arrays (..., lmax+1, mmax) for m = -1..-mmax, or None
        for a real field (the map's imaginary plane is then zero).
    Returns Z with arrays (..., npix).
    """
    from . import zarray as za

    lead = pos_z.re.shape[:-2]
    lmax = pos_z.re.shape[-2] - 1
    mmax = pos_z.re.shape[-1] - 1
    pr = pos_z.re.reshape((-1, lmax + 1, mmax + 1))
    pi = pos_z.im.reshape((-1, lmax + 1, mmax + 1))
    lam = _legendre_table(ring_geometry(nside), lmax, mmax, pr.dtype)
    if neg_z is None:
        maps = _synthesis_real_split(pr, pi, geom_arrays(nside), nside, lmax, mmax, lam)
        return za.Z(
            maps.reshape(lead + (maps.shape[-1],)), jnp.zeros(lead + (maps.shape[-1],), maps.dtype)
        )
    nr = neg_z.re.reshape((-1, lmax + 1, mmax))
    ni = neg_z.im.reshape((-1, lmax + 1, mmax))
    mr, mi = _synthesis_complex_split(pr, pi, nr, ni, geom_arrays(nside), nside, lmax, mmax, lam)
    return za.Z(
        mr.reshape(lead + (mr.shape[-1],)), mi.reshape(lead + (mi.shape[-1],))
    )


# ------------------------------------------------------------------
# Public, batched API
# ------------------------------------------------------------------


def analysis(
    maps,
    lmax: int,
    mmax: Optional[int] = None,
    nside: Optional[int] = None,
    neg_m: bool = False,
    iters: int = 0,
    ring_padded: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Forward SHT of a batch of maps.

    maps : (..., npix); any leading batch shape.
    iters : number of Jacobi refinement iterations (like healpy's ``iter``)
        — each adds one synthesis+analysis pass and sharpens the equal-area
        quadrature towards the least-squares coefficients.
    Returns (alm_pos, alm_neg or None) with alm_pos (..., lmax+1, mmax+1).
    """
    maps = jnp.asarray(maps)
    mmax = lmax if mmax is None else mmax
    npix = maps.shape[-1]
    if ring_padded:
        if nside is None:
            raise ValueError("ring_padded input requires explicit nside")
        geom = ring_geometry(nside)
        if npix != geom.nring * geom.maxlen:
            raise ValueError(
                f"padded npix {npix} != nring*maxlen for nside {nside}"
            )
    else:
        if nside is None:
            nside = int(np.sqrt(npix / 12))
        if 12 * nside * nside != npix:
            raise ValueError(f"npix {npix} is not a valid healpix size")
    lead = maps.shape[:-1]
    flat = maps.reshape((-1, npix))
    real_field = not jnp.iscomplexobj(flat)
    if iters and not real_field and not neg_m:
        raise ValueError("refinement of a complex field requires neg_m=True")
    if iters and ring_padded:
        raise ValueError("Jacobi refinement requires compact RING maps")
    double = flat.dtype.itemsize >= (16 if not real_field else 8)
    lam = _legendre_table(
        ring_geometry(nside), lmax, mmax, jnp.float64 if double else jnp.float32
    )
    g = geom_arrays(nside)
    pos, neg = _analysis(
        flat, g, nside, lmax, mmax, neg_m, lam,
        ring_padded=ring_padded,
    )

    for _ in range(iters):
        if neg_m:
            resid = flat - _synthesis_complex(pos, neg, g, nside, lmax, mmax, lam)
            dpos, dneg = _analysis(resid, g, nside, lmax, mmax, True, lam)
            pos = pos + dpos
            neg = neg + dneg
        else:
            resid = flat - _synthesis_real(pos, g, nside, lmax, mmax, lam).astype(
                flat.dtype
            )
            dpos, _ = _analysis(resid, g, nside, lmax, mmax, False, lam)
            pos = pos + dpos

    pos = pos.reshape(lead + (lmax + 1, mmax + 1))
    if neg is not None:
        neg = neg.reshape(lead + (lmax + 1, mmax))
    return pos, neg


def synthesis_real(alm, nside: int):
    """Inverse SHT of m>=0 coefficients of a real field onto healpix maps."""
    alm = jnp.asarray(alm)
    lead = alm.shape[:-2]
    lmax = alm.shape[-2] - 1
    mmax = alm.shape[-1] - 1
    flat = alm.reshape((-1, lmax + 1, mmax + 1))
    lam = _legendre_table(
        ring_geometry(nside),
        lmax,
        mmax,
        jnp.float64 if alm.dtype.itemsize >= 16 else jnp.float32,
    )
    maps = _synthesis_real(flat, geom_arrays(nside), nside, lmax, mmax, lam)
    return maps.reshape(lead + (maps.shape[-1],))


def synthesis_complex(alm_pos, alm_neg, nside: int):
    """Inverse SHT of a general complex field (pos and neg m blocks)."""
    alm_pos = jnp.asarray(alm_pos)
    alm_neg = jnp.asarray(alm_neg)
    lead = alm_pos.shape[:-2]
    lmax = alm_pos.shape[-2] - 1
    mmax = alm_pos.shape[-1] - 1
    fp = alm_pos.reshape((-1, lmax + 1, mmax + 1))
    fn = alm_neg.reshape((-1, lmax + 1, mmax))
    lam = _legendre_table(
        ring_geometry(nside),
        lmax,
        mmax,
        jnp.float64 if alm_pos.dtype.itemsize >= 16 else jnp.float32,
    )
    maps = _synthesis_complex(fp, fn, geom_arrays(nside), nside, lmax, mmax, lam)
    return maps.reshape(lead + (maps.shape[-1],))


# ------------------------------------------------------------------
# driftscan/cora compatible wrappers (numpy in / numpy out)
#
# With DRIFTSCAN_TPU_SPLIT_COMPLEX=1 these route through the
# split-complex kernels (host-side plane split, device matmul stages) —
# the same engine as the BTM hot path; by default they use the native
# complex kernels.
# ------------------------------------------------------------------


def _split_backend() -> bool:
    from .. import backend

    return backend.split_complex()


def _dev_plane(x):
    """Host real plane -> device array."""
    return jnp.asarray(np.ascontiguousarray(x))


def pack_fftlike(pos: np.ndarray, neg: Optional[np.ndarray], lside: int) -> np.ndarray:
    """Pack (l, m>=0) and (l, m<0) blocks into the (lside+1, 2*lside+1)
    FFT-like layout the reference stores transfer matrices in
    (positive m at [l, m], negative at [l, 2*lside+1+m])."""
    lead = pos.shape[:-2]
    lmax_in = pos.shape[-2] - 1
    mmax_in = pos.shape[-1] - 1
    out = np.zeros(lead + (lside + 1, 2 * lside + 1), dtype=np.complex128)
    lmax_o = min(lmax_in, lside)
    mmax_o = min(mmax_in, lside)
    out[..., : lmax_o + 1, : mmax_o + 1] = pos[..., : lmax_o + 1, : mmax_o + 1]
    if neg is not None:
        for m in range(1, mmax_o + 1):
            out[..., : lmax_o + 1, -m] = neg[..., : lmax_o + 1, m - 1]
    return out


def sphtrans_complex(
    hpmap, lmax: Optional[int] = None, lside: Optional[int] = None, centered=False
) -> np.ndarray:
    """Forward SHT of a complex map, packed like ``hputil.sphtrans_complex``.

    Only the ``centered=False`` (FFT-like) layout used by the reference
    (/root/reference/drift/core/telescope.py:1189) is supported.
    """
    if centered:
        raise NotImplementedError("centered alm layout not supported")
    hpmap = np.asarray(hpmap)
    nside = int(np.sqrt(hpmap.shape[-1] / 12))
    lmax = 3 * nside - 1 if lmax is None else lmax
    lside = lmax if lside is None else lside
    if _split_backend():
        from . import zarray as za

        maps_z = za.Z(_dev_plane(hpmap.real), _dev_plane(hpmap.imag))
        pos_z, neg_z = analysis_split(maps_z, lmax, neg_m=True)
        pos = np.asarray(pos_z.re, np.float64) + 1j * np.asarray(pos_z.im, np.float64)
        neg = np.asarray(neg_z.re, np.float64) + 1j * np.asarray(neg_z.im, np.float64)
    else:
        pos, neg = analysis(hpmap, lmax, neg_m=True)
        pos, neg = np.asarray(pos), np.asarray(neg)
    return pack_fftlike(pos, neg, lside)


def sphtrans_complex_pol(hpmaps, lmax=None, lside=None, centered=False):
    """Per-Stokes scalar transforms of a stack of complex maps."""
    return sphtrans_complex(np.asarray(hpmaps), lmax=lmax, lside=lside, centered=centered)


def sphtrans_sky(skymap, lmax: Optional[int] = None) -> np.ndarray:
    """Forward SHT of a real sky [freq, (pol), pix] -> [..., l, m] (m >= 0).

    Equivalent of ``hputil.sphtrans_sky`` used at
    /root/reference/drift/pipeline/timestream.py:717.
    """
    skymap = np.asarray(skymap)
    nside = int(np.sqrt(skymap.shape[-1] / 12))
    lmax = 3 * nside - 1 if lmax is None else lmax
    if _split_backend():
        lead = skymap.shape[:-1]
        flat = _dev_plane(skymap.reshape(-1, skymap.shape[-1]))
        lam = _legendre_table(ring_geometry(nside), lmax, lmax, flat.dtype)
        pr, pi, _, _ = _analysis_split(
            flat, None, geom_arrays(nside), nside, lmax, lmax, False, lam,
            real_field=True,
        )
        pos = np.asarray(pr, np.float64) + 1j * np.asarray(pi, np.float64)
        return pos.reshape(lead + pos.shape[-2:])
    pos, _ = analysis(skymap, lmax)
    return np.asarray(pos)


def sphtrans_inv_sky(alm, nside: int) -> np.ndarray:
    """Inverse SHT onto real sky maps [freq, pol, pix].

    Equivalent of ``hputil.sphtrans_inv_sky`` used at
    /root/reference/drift/pipeline/timestream.py:262.
    """
    alm = np.asarray(alm)
    if _split_backend():
        lead = alm.shape[:-2]
        lmax, mmax = alm.shape[-2] - 1, alm.shape[-1] - 1
        ar = _dev_plane(alm.real.reshape((-1,) + alm.shape[-2:]))
        ai = _dev_plane(alm.imag.reshape((-1,) + alm.shape[-2:]))
        lam = _legendre_table(ring_geometry(nside), lmax, mmax, ar.dtype)
        maps = _synthesis_real_split(ar, ai, geom_arrays(nside), nside, lmax, mmax, lam)
        out = np.asarray(maps, np.float64)
        return out.reshape(lead + (out.shape[-1],))
    return np.asarray(synthesis_real(alm, nside))


__all__ = [
    "analysis",
    "synthesis_real",
    "synthesis_complex",
    "sphtrans_complex",
    "sphtrans_complex_pol",
    "sphtrans_sky",
    "sphtrans_inv_sky",
    "nside_for_lmax",
    "pack_fftlike",
]
