"""Dense linear algebra for the m-mode pipeline.

Replaces the reference's scipy/LAPACK usage
(/root/reference/drift/core/kltransform.py:55-143,
 /root/reference/drift/core/beamtransfer.py:35-143,
 /root/reference/drift/util/blockla.py) with batched jnp operations.

Key design points (SURVEY.md section 7 'hard parts' #2, #3):

* the generalised Hermitian eigenproblem ``A v = lambda B v`` is solved by
  Cholesky whitening (B = L L^H, eigh of L^-1 A L^-H), with the same
  diagonal-regularisation fallback as the reference's ``eigh_gen`` — but
  driven by a NaN check on the Cholesky rather than LAPACK error codes;
* data-dependent rank cuts (matrix image / nullspace) become *masked*
  fixed-shape operations so everything vmaps and shards over m.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ------------------------------------------------------------------
# Generalised Hermitian eigenproblem
# ------------------------------------------------------------------


@jax.jit
def _whitened_eigh(A, B):
    """eigh of A v = w B v via Cholesky whitening.

    Returns (evals ascending, evecs with columns v, chol_ok flag).
    Rows/columns where B is singular produce NaNs, which the caller
    detects and regularises — mirroring the reference ladder
    (/root/reference/drift/core/kltransform.py:89-119).
    """
    L = jnp.linalg.cholesky(B)
    Li_A = jax.scipy.linalg.solve_triangular(L, A, lower=True)
    C = jax.scipy.linalg.solve_triangular(L, Li_A.conj().T, lower=True).conj().T
    # Hermitise against roundoff
    C = 0.5 * (C + C.conj().T)
    w, u = jnp.linalg.eigh(C)
    v = jax.scipy.linalg.solve_triangular(L.conj().T, u, lower=False)
    ok = jnp.isfinite(w).all() & jnp.isfinite(v.real).all() & jnp.isfinite(v.imag).all()
    return w, v, ok


def eigh_gen(A, B, message: str = ""):
    """Solve ``A v = lambda B v`` with regularisation fallback.

    API-compatible with the reference ``kltransform.eigh_gen``: returns
    (evals, evecs (columns), add_const) where ``add_const`` is the constant
    added to diag(B) when B was not positive definite.
    """
    A = np.asarray(A)
    B = np.asarray(B)

    if (A == 0).all():
        return (
            np.zeros(A.shape[0], dtype=A.real.dtype),
            np.identity(A.shape[0], dtype=A.dtype),
            0.0,
        )

    w, v, ok = _whitened_eigh(jnp.asarray(A), jnp.asarray(B))
    if bool(ok):
        return np.asarray(w), np.asarray(v), 0.0

    # B not positive definite: add a constant diagonal, same formula as the
    # reference (/root/reference/drift/core/kltransform.py:107-110).
    evb = np.asarray(jnp.linalg.eigvalsh(jnp.asarray(B)))
    add_const = 1e-15 * evb[-1] - 2.0 * evb[0] + 1e-60
    Breg = B + add_const * np.identity(B.shape[0], dtype=B.dtype)
    w, v, ok = _whitened_eigh(jnp.asarray(A), jnp.asarray(Breg))
    if not bool(ok):
        raise np.linalg.LinAlgError(
            f"Generalised eigenproblem failed even after regularisation {message}"
        )
    return np.asarray(w), np.asarray(v), float(add_const)


@jax.jit
def eigh_gen_batched(A, B):
    """Batched generalised eigh with automatic per-item regularisation.

    A, B : (batch, n, n).  Items whose B is not positive definite get a
    diagonal shift before the (single) whitened solve; everything stays
    on device so the batch shards over the mesh.

    Definiteness is probed with one Cholesky (a third of an eigh's cost)
    and the shift uses Gershgorin eigenvalue bounds instead of the
    reference's exact extremal eigenvalues
    (/root/reference/drift/core/kltransform.py:107-110): both guarantee
    B + c*I is PD, and under vmap an exact-eigenvalue retry would run the
    expensive solve twice for every item.

    Returns (evals (batch, n) ascending, evecs (batch, n, n) columns,
    add_const (batch,)).
    """

    def solve_one(a, b):
        L = jnp.linalg.cholesky(b)
        ok = jnp.isfinite(L.real).all() & jnp.isfinite(L.imag).all()

        diag = jnp.real(jnp.diagonal(b))
        radius = jnp.abs(b).sum(axis=1) - jnp.abs(jnp.diagonal(b))
        lo = (diag - radius).min()
        hi = (diag + radius).max()
        add_const = jnp.where(
            ok, 0.0, 1e-15 * hi - 2.0 * jnp.minimum(lo, 0.0) + 1e-30
        ).astype(diag.dtype)

        breg = b + add_const * jnp.eye(b.shape[0], dtype=b.dtype)
        w, v, _ = _whitened_eigh(a, breg)

        # All-zero A -> zero evals, identity evecs (reference convention)
        zero = (a == 0).all()
        w = jnp.where(zero, jnp.zeros_like(w), w)
        v = jnp.where(zero, jnp.eye(v.shape[0], dtype=v.dtype), v)
        return w, v, jnp.where(zero, 0.0, add_const)

    return jax.vmap(solve_one)(A, B)


def inv_gen(A):
    """Inverse with pseudo-inverse fallback (reference inv_gen parity).

    Host numpy: per-m matrices are small and this avoids requiring
    complex support on the accelerator.
    """
    A = np.asarray(A)
    try:
        inv = np.linalg.inv(A)
        if not np.isfinite(inv).all():
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(A)
    return inv


# ------------------------------------------------------------------
# Matrix image / nullspace (host-facing, dynamic shapes)
# ------------------------------------------------------------------


def svd_gen(A, errmsg=None, *args, **kwargs):
    """SVD with diagonal-regularisation retry (reference ladder parity,
    /root/reference/drift/core/beamtransfer.py:35-65).  Modern LAPACK
    drivers essentially never fail to converge, so the fallback is a
    safety net."""
    import logging

    res = np.linalg.svd(A, *args, **kwargs)
    parts = res if isinstance(res, tuple) else (res,)
    if all(np.isfinite(p).all() for p in parts):
        return res
    sv = np.linalg.svd(A, compute_uv=False)[0]
    At = A + sv * 1e-10 * np.eye(A.shape[0], A.shape[1])
    logging.getLogger(__name__).info(
        "Matrix SVD did not converge. Regularised. %s", errmsg or ""
    )
    return np.linalg.svd(At, *args, **kwargs)


def matrix_image(A, rtol: float = 1e-8, atol: Optional[float] = None, errmsg=""):
    """Orthonormal basis of the image of A and its singular spectrum.

    Parity with /root/reference/drift/core/beamtransfer.py:68-104; the
    SVD routes through the :func:`svd_gen` regularisation ladder.
    """
    A = np.asarray(A)
    if A.shape[0] == 0:
        return np.array([], dtype=A.dtype).reshape(0, 0), np.array([], dtype=np.float64)
    u, s, _ = svd_gen(A, errmsg=errmsg, full_matrices=False)
    if atol is None:
        cut = int((s > s[0] * rtol).sum()) if s.size else 0
    else:
        cut = int((s > atol).sum())
    return np.ascontiguousarray(u[:, :cut]), s


def matrix_nullspace(A, rtol: float = 1e-8, atol: Optional[float] = None, errmsg=""):
    """Orthonormal basis of the nullspace of A^H (left nullspace)."""
    A = np.asarray(A)
    if A.shape[0] == 0:
        return np.array([], dtype=A.dtype).reshape(0, 0), np.array([], dtype=np.float64)
    u, s, _ = svd_gen(A, errmsg=errmsg, full_matrices=True)
    s_ext = np.zeros(u.shape[1])
    s_ext[: s.size] = s
    if atol is None:
        cut = int((s >= s[0] * rtol).sum()) if s.size else 0
    else:
        cut = int((s >= atol).sum())
    return np.ascontiguousarray(u[:, cut:]), s


# ------------------------------------------------------------------
# Padded, batched triple-SVD (the BTM compression hot loop)
# ------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("npol", "nl"))
def triple_svd_batched(bfr, npol: int, nl: int, polsvcut: float = 1e-4):
    """The per-(m, freq) triple SVD of the noise-weighted beam matrix.

    Batched, fixed-shape implementation of
    /root/reference/drift/core/beamtransfer.py:802-924:

    1. SVD1 projects onto the image of the full beam (rtol 1e-10);
    2. SVD2 projects onto the nullspace of the polarised response
       (rtol = polsvcut), filtering polarisation;
    3. SVD3 re-diagonalises the Stokes-I response, ordering modes by
       sensitivity.

    Rank cuts become row masks, so outputs are padded to
    ``svd_len = min(ntel, nl)`` with zero rows and a per-item mode count.

    Parameters
    ----------
    bfr : (batch, ntel, npol * nl) complex
        Noise-weighted beam matrices.

    Returns
    -------
    ut : (batch, svd_len, ntel)
        Projection telescope -> SVD basis (rows beyond nmodes are zero).
    beam : (batch, svd_len, npol * nl)
        Projection sky -> SVD basis.
    sig : (batch, svd_len) singular values of the Stokes-I stage.
    nmodes : (batch,) int32 number of valid modes.
    """
    ntel = bfr.shape[-2]
    svd_len = min(nl, ntel)

    def one(bf):
        if npol == 1:
            ut2 = None
            bf2 = bf
            pol_ok = jnp.asarray(True)
        else:
            # --- SVD1: image of the full beam ---
            u1, s1, _ = jnp.linalg.svd(bf, full_matrices=False)
            smax1 = s1[0]
            mask1 = s1 > smax1 * 1e-10
            ut1 = (u1 * mask1[None, :]).conj().T  # (K1, ntel)
            bf1 = ut1 @ bf  # (K1, npol*nl)
            pol_ok = (s1 > 0.0).any()

            # --- SVD2: nullspace of the polarised response ---
            K1 = bf1.shape[0]
            bfp = bf1.reshape(K1, npol, nl)[:, 1:].reshape(K1, (npol - 1) * nl)
            u2, s2, _ = jnp.linalg.svd(bfp, full_matrices=True)  # u2 (K1, K1)
            s2_ext = jnp.zeros(K1, dtype=s2.dtype).at[: s2.shape[0]].set(s2)
            keep2 = s2_ext < s2[0] * polsvcut  # null directions
            ut2 = ((u2 * keep2[None, :]).conj().T) @ ut1  # (K1, ntel)
            bf2 = ut2 @ bf

        # --- SVD3: image of the Stokes-I response ---
        K2 = bf2.shape[0]
        bft = bf2.reshape(K2, npol, nl)[:, 0]  # (K2, nl)
        u3, s3, _ = jnp.linalg.svd(bft, full_matrices=False)  # (K2, K3)
        # Reference uses rtol=0 here (keep every s > 0); a tiny relative
        # floor avoids keeping pure-roundoff modes from the padded rows.
        mask3 = s3 > s3[0] * 1e-13
        mask3 = mask3 & pol_ok
        u3m = u3 * mask3[None, :]
        if npol == 1:
            ut3 = u3m.conj().T  # (K3, ntel) since bf2 = bf
        else:
            ut3 = (u3m.conj().T) @ ut2
        beam = ut3 @ bf
        sig = s3 * mask3
        nmodes = mask3.sum().astype(jnp.int32)

        # Pad/trim to svd_len rows
        K3 = ut3.shape[0]
        if K3 < svd_len:
            pad = [(0, svd_len - K3), (0, 0)]
            ut3 = jnp.pad(ut3, pad)
            beam = jnp.pad(beam, pad)
            sig = jnp.pad(sig, (0, svd_len - K3))
        else:
            ut3 = ut3[:svd_len]
            beam = beam[:svd_len]
            sig = sig[:svd_len]
        return ut3, beam, sig, nmodes

    return jax.vmap(one)(bfr)


@functools.partial(jax.jit, static_argnames=("npol", "nl"))
def triple_svd_split_batched(bfr_re, bfr_im, npol: int, nl: int, polsvcut: float = 1e-4):
    """Split-complex triple SVD (see :func:`triple_svd_batched`).

    Uses Gram-eigendecomposition SVDs (ops.zarray.svd_eigh) on real
    (re, im) planes.  Singular values below ~sqrt(jitter) of the
    maximum (~1e-6 relative) are noise of the Gram method, so the image
    cuts are floored at 1e-5 relative — modes that faint carry 1e-10 of
    the peak sensitivity in power and are discarded by the svcut (default
    1e-6) downstream anyway.

    Returns (ut Z-planes, beam Z-planes, sig, nmodes) with the same padded
    shapes as the native version.
    """
    from . import zarray as za

    ntel = bfr_re.shape[-2]
    svd_len = min(nl, ntel)

    gram_floor = 1e-5

    def one(bf_re, bf_im):
        bf = za.Z(bf_re, bf_im)

        if npol == 1:
            ut2 = None
            bf2 = bf
            pol_ok = jnp.asarray(True)
        else:
            u1, s1, _ = za.svd_eigh(bf)
            mask1 = s1 > s1[0] * jnp.maximum(1e-10, gram_floor)
            ut1 = za.Z(
                (u1.re * mask1[None, :]).T, -(u1.im * mask1[None, :]).T
            )  # u1^H with masked columns
            bf1 = za.einsum("ij,jk->ik", ut1, bf)
            pol_ok = (s1 > 0.0).any()

            K1 = bf1.re.shape[0]
            bfp = za.Z(
                bf1.re.reshape(K1, npol, nl)[:, 1:].reshape(K1, (npol - 1) * nl),
                bf1.im.reshape(K1, npol, nl)[:, 1:].reshape(K1, (npol - 1) * nl),
            )
            # Left-nullspace of the polarised response, as the explicit
            # complement of the *resolved* polarised directions.  Two f32
            # traps, both measured to change retained SVD spectra by tens
            # of percent at product scale:  (1) a single f32 Gram resolves
            # singular values only to ~1e-3 relative — too coarse for the
            # polsvcut (1e-4) classification — so the directions come from
            # multi-level Gram deflation (accurate to ~3e-5);  (2) an
            # eigh's *small-eigenvalue* columns are useless as a null
            # basis: the deflated remainder's Gram is numerically singular
            # along every previously-deflated direction, so its
            # noise-level eigenvectors mix the true null space with
            # already-extracted polarised directions.  Projecting out the
            # resolved polarised columns (mutually orthogonal across
            # bands; CGS2) sidesteps both.
            from . import fpencil

            bands2 = fpencil.gram_bands(bfp, levels=3, band_rel=3e-2)
            cut2 = jnp.max(bands2.s) * polsvcut
            maskp = (bands2.s >= cut2).astype(bf_re.dtype)  # (levels, K1)
            qp = za.Z(
                bands2.q.re * maskp[:, None, :],
                bands2.q.im * maskp[:, None, :],
            )

            def _reject_pol(x):
                for _ in range(2):  # CGS2
                    proj = za.einsum("lji,jk->lik", qp.conj(), x)
                    x = x - za.einsum("lij,ljk->ik", qp, proj)
                return x

            ut2 = _reject_pol(ut1)
            bf2 = za.einsum("ij,jk->ik", ut2, bf)

        K2 = bf2.re.shape[0]
        bft = za.Z(
            bf2.re.reshape(K2, npol, nl)[:, 0],
            bf2.im.reshape(K2, npol, nl)[:, 0],
        )
        u3, s3, _ = za.svd_eigh(bft, gram_side="left")
        mask3 = (s3 > s3[0] * gram_floor) & pol_ok
        u3m = za.Z(u3.re * mask3[None, :], u3.im * mask3[None, :])
        if npol == 1:
            ut3 = u3m.conj().transpose(1, 0)
        else:
            ut3 = za.einsum("ji,jk->ik", u3m.conj(), ut2)
        beam = za.einsum("ij,jk->ik", ut3, bf)
        sig = s3 * mask3
        nmodes = mask3.sum().astype(jnp.int32)

        K3 = ut3.re.shape[0]
        if K3 < svd_len:
            pad = [(0, svd_len - K3), (0, 0)]
            ut3 = za.Z(jnp.pad(ut3.re, pad), jnp.pad(ut3.im, pad))
            beam = za.Z(jnp.pad(beam.re, pad), jnp.pad(beam.im, pad))
            sig = jnp.pad(sig, (0, svd_len - K3))
        else:
            ut3 = za.Z(ut3.re[:svd_len], ut3.im[:svd_len])
            beam = za.Z(beam.re[:svd_len], beam.im[:svd_len])
            sig = sig[:svd_len]
        return ut3.re, ut3.im, beam.re, beam.im, sig, nmodes

    return jax.vmap(one)(bfr_re, bfr_im)


@jax.jit
def svd_simple_batched(bfr):
    """Plain SVD compression used by BeamTransferFullSVD / TempSVD.

    bfr : (batch, ntel, k).  Returns (ut (batch, kk, ntel), sig (batch, kk))
    with kk = min(ntel, k), where ut = u^H.
    """
    u, s, _ = jnp.linalg.svd(bfr, full_matrices=False)
    return jnp.swapaxes(u, -1, -2).conj(), s


# ------------------------------------------------------------------
# Block-diagonal linear algebra (blockla parity, batched)
# ------------------------------------------------------------------


def svd_dm(matrix, full_matrices: bool = True):
    """Batched SVD of the blocks of a block-diagonal matrix (host)."""
    u, s, v = np.linalg.svd(np.asarray(matrix), full_matrices=full_matrices)
    return u, s, v


def multiply_dm_v(matrix, vector, conj: bool = False):
    """Batched matrix @ vector over blocks (host)."""
    m = np.asarray(matrix)
    if conj:
        m = np.swapaxes(m, -1, -2).conj()
    return np.einsum("bij,bj->bi", m, np.asarray(vector))


def multiply_dm_dm(matrix1, matrix2):
    """Batched matrix @ matrix over blocks (host)."""
    return np.einsum("bij,bjk->bik", np.asarray(matrix1), np.asarray(matrix2))


def pinv_dm(matrix, rcond: float = 1e-15, **kwargs):
    """Batched pseudo-inverse over blocks (host)."""
    return np.linalg.pinv(np.asarray(matrix), rcond=rcond)


def pinv(A, rcond: float = 1e-15):
    return np.linalg.pinv(np.asarray(A), rcond=rcond)


__all__ = [
    "eigh_gen",
    "eigh_gen_batched",
    "inv_gen",
    "matrix_image",
    "matrix_nullspace",
    "triple_svd_batched",
    "svd_simple_batched",
    "svd_dm",
    "multiply_dm_v",
    "multiply_dm_dm",
    "pinv_dm",
    "pinv",
]
