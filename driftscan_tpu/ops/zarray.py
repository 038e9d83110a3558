"""Split-complex arithmetic: complex linear algebra on real planes.

The m-mode pipeline is complex-valued end to end.  The factored KL
engine (ops.fpencil) and the ``DRIFTSCAN_TPU_SPLIT_COMPLEX`` paths keep
it on an explicit (real, imag) representation, and this module
implements the complex operations they need:

* ``Z`` — a pytree pair of real arrays;
* complex contractions as 4 real contractions;
* Hermitian eigendecomposition via the real-symmetric embedding
  ``[[A, -B], [B, A]]`` (eigenvalues double up; even-indexed eigenvectors
  re-assemble into complex ones);
* SVD via the Gram-matrix eigendecomposition (one-sided Jacobi-style),
  adequate down to ~sqrt(eps) of the top singular value;
* Cholesky / triangular solves through the same real embedding.

Everything is jit/vmap compatible and dtype-preserving (f32 in -> f32 out).
"""

from __future__ import annotations

from typing import NamedTuple

import os

import jax
import jax.numpy as jnp
import numpy as np


class Z(NamedTuple):
    """A complex array split into real and imaginary planes."""

    re: jnp.ndarray
    im: jnp.ndarray

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def conj(self):
        return Z(self.re, -self.im)

    def transpose(self, *axes):
        return Z(self.re.transpose(*axes), self.im.transpose(*axes))

    def reshape(self, *shape):
        return Z(self.re.reshape(*shape), self.im.reshape(*shape))

    def astype(self, dtype):
        return Z(self.re.astype(dtype), self.im.astype(dtype))

    def __add__(self, other):
        if isinstance(other, Z):
            return Z(self.re + other.re, self.im + other.im)
        return Z(self.re + other, self.im)

    def __sub__(self, other):
        if isinstance(other, Z):
            return Z(self.re - other.re, self.im - other.im)
        return Z(self.re - other, self.im)

    def __mul__(self, other):
        if isinstance(other, Z):
            return Z(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return Z(self.re * other, self.im * other)

    __rmul__ = __mul__

    def abs2(self):
        return self.re**2 + self.im**2


def of(x) -> Z:
    """Split a (numpy or jax, complex or real) array into a Z pair."""
    if isinstance(x, Z):
        return x
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return Z(jnp.real(x), jnp.imag(x))
    return Z(x, jnp.zeros_like(x))


def to_numpy(z: Z) -> np.ndarray:
    """Assemble a Z back into a host complex array."""
    re = np.asarray(z.re)
    im = np.asarray(z.im)
    dt = np.complex128 if re.dtype == np.float64 else np.complex64
    return re.astype(dt) + 1j * im.astype(dt)


def einsum(subscripts: str, a: Z, b: Z, **kwargs) -> Z:
    """Complex einsum of two operands via four real einsums."""
    rr = jnp.einsum(subscripts, a.re, b.re, **kwargs)
    ii = jnp.einsum(subscripts, a.im, b.im, **kwargs)
    ri = jnp.einsum(subscripts, a.re, b.im, **kwargs)
    ir = jnp.einsum(subscripts, a.im, b.re, **kwargs)
    return Z(rr - ii, ri + ir)


def matmul(a: Z, b: Z) -> Z:
    return Z(
        a.re @ b.re - a.im @ b.im,
        a.re @ b.im + a.im @ b.re,
    )


def embed_herm(h: Z) -> jnp.ndarray:
    """Real-symmetric embedding [[A, -B], [B, A]] of a Hermitian H = A+iB."""
    top = jnp.concatenate([h.re, -h.im], axis=-1)
    bot = jnp.concatenate([h.im, h.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# Assembly strategy for the interleaved embedding: "gather" (concat +
# take with a fixed permutation) or "stack" (stack/reshape row mixes +
# two transposes for the column mix).  The gather form was the round-2
# workaround for a 32x HLO-temp blowup from trailing-2 intermediates;
# the stack form only ever creates a *sublane*-2 intermediate and no
# gathers.  Env-selectable; read once, before first trace.
_INTERLEAVE_IMPL = os.environ.get("DRIFTSCAN_TPU_INTERLEAVE", "gather")


def _rowmix_stack(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """(..., p, q) pair -> (..., 2p, q) with rows x0, y0, x1, y1, ..."""
    p = x.shape[-2]
    s = jnp.stack([x, y], axis=-2)  # (..., p, 2, q): sublane-2 transient
    return s.reshape(x.shape[:-2] + (2 * p, x.shape[-1]))


def interleave(m: Z) -> jnp.ndarray:
    """Interleaved real embedding of a general complex matrix M = A + iB.

    Maps each complex entry to the 2x2 block [[a, -b], [b, a]] at rows
    (2i, 2i+1), cols (2j, 2j+1).  Unlike the block embedding this is a
    *ring homomorphism that preserves triangularity*: the interleaved
    embedding of an upper-triangular complex matrix with real diagonal is
    a real upper-triangular matrix — which makes real QR/triangular-solve
    kernels directly usable for complex factorisations (see
    fpencil.kl_solve_qr).
    """
    p, q = m.re.shape[-2], m.re.shape[-1]

    if _INTERLEAVE_IMPL == "stack":
        even = _rowmix_stack(m.re, m.im)  # content of even columns
        odd = _rowmix_stack(-m.im, m.re)
        # column interleave = row interleave of the transpose
        allt = _rowmix_stack(
            jnp.swapaxes(even, -1, -2), jnp.swapaxes(odd, -1, -2)
        )
        return jnp.swapaxes(allt, -1, -2)

    # Assemble with concatenate + gather only: an intermediate with a
    # *trailing* dimension of 2 can be padded many-fold by a tiled
    # layout (a 440 MB embedding once took 13.7 GB of HLO temp).
    def rowmix(x, y):
        # (..., 2p, q) with rows x0, y0, x1, y1, ...
        both = jnp.concatenate([x, y], axis=-2)
        idx = jnp.arange(2 * p) // 2 + (jnp.arange(2 * p) % 2) * p
        return jnp.take(both, idx, axis=-2)

    even = rowmix(m.re, m.im)  # content of even columns
    odd = rowmix(-m.im, m.re)  # content of odd columns
    both = jnp.concatenate([even, odd], axis=-1)
    cidx = jnp.arange(2 * q) // 2 + (jnp.arange(2 * q) % 2) * q
    return jnp.take(both, cidx, axis=-1)


def deinterleave(e: jnp.ndarray) -> Z:
    """Inverse of :func:`interleave` (reads the (re, im) block entries)."""
    return Z(e[..., 0::2, 0::2], e[..., 1::2, 0::2])


def unembed_vecs(v2n: jnp.ndarray) -> Z:
    """Complex vectors from the columns of a 2n-real eigenvector matrix."""
    n = v2n.shape[-2] // 2
    return Z(v2n[..., :n, :], v2n[..., n:, :])


_JITTER_CACHE = {}


def _jitter_matrix(n: int, dtype) -> Z:
    """A fixed random Hermitian matrix of unit scale (cached per size).

    The cache holds host numpy arrays (device arrays created inside a jit
    trace would leak tracers); jnp.asarray at the use site is free.
    """
    key = (n, np.dtype(dtype).name)
    if key not in _JITTER_CACHE:
        rng = np.random.default_rng(1234567)
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        hmat = (a + a.conj().T) / (2 * np.sqrt(n))
        _JITTER_CACHE[key] = (
            np.ascontiguousarray(hmat.real, dtype=dtype),
            np.ascontiguousarray(hmat.imag, dtype=dtype),
        )
    re, im = _JITTER_CACHE[key]
    return Z(jnp.asarray(re), jnp.asarray(im))


def eigh(h: Z, jitter: float = 1e-12):
    """Eigendecomposition of a Hermitian split matrix.

    Returns (w (n,) ascending, v Z(n, n) with eigenvector columns),
    matching jnp.linalg.eigh semantics.  The 2n real-symmetric embedding
    has every eigenvalue twice; we keep the even-indexed copies.  Within
    each doubled pair the two real eigenvectors span {v, iv}, so either
    one reassembles into a valid (unit) complex eigenvector.

    Degenerate *distinct* complex eigenvalues would make that selection
    ambiguous (it could pick v and iv of the same mode), so a fixed
    Hermitian perturbation of relative size `jitter` splits ties first.
    Set jitter=0 to disable.
    """
    n = h.shape[-1]
    if jitter:
        scale = jitter * jnp.maximum(
            jnp.max(jnp.abs(h.re), axis=(-2, -1), keepdims=True),
            jnp.max(jnp.abs(h.im), axis=(-2, -1), keepdims=True),
        )
        r = _jitter_matrix(n, h.dtype)
        h = Z(h.re + scale * r.re, h.im + scale * r.im)
    E = embed_herm(h)
    w2, v2 = jnp.linalg.eigh(E)
    idx = jnp.arange(n) * 2
    w = w2[..., idx]
    v = unembed_vecs(v2[..., :, idx])
    # Columns of the embedding are unit-norm in R^2n == unit complex norm,
    # but within (jitter-split) near-degenerate subspaces the selected
    # complex vectors can be slightly non-orthogonal: polish with two
    # Newton steps of V <- V (3I - V^H V)/2 (mixes only degenerate modes).
    eye = jnp.eye(n, dtype=v.dtype)
    for _ in range(2):
        g = einsum("...ji,...jk->...ik", v.conj(), v)
        corr = Z(1.5 * eye - 0.5 * g.re, -0.5 * g.im)
        v = einsum("...ij,...jk->...ik", v, corr)
    return w, v


def eigvalsh(h: Z):
    n = h.shape[-1]
    E = embed_herm(h)
    w2 = jnp.linalg.eigvalsh(E)
    return w2[..., jnp.arange(n) * 2]


def cholesky(h: Z) -> Z:
    """Cholesky factor L (lower, complex) of Hermitian PD H.

    The *block* embedding chol([[A, -B], [B, A]]) does not give the
    complex factor, but the :func:`interleave` embedding does: it is a
    ring homomorphism with interleave(M)^T = interleave(M^H), and the
    interleaved image of a complex lower-triangular matrix with real
    positive diagonal is a real lower-triangular matrix with positive
    diagonal — so by uniqueness of the Cholesky factorisation,
    chol(interleave(H)) = interleave(L) exactly.
    """
    return deinterleave(jnp.linalg.cholesky(interleave(h)))


def whiten_eigh(s: Z, n: Z, floor: float = 0.0):
    """Solve the generalised Hermitian problem S v = w N v (split form).

    Uses the eigendecomposition of N for whitening (rather than Cholesky,
    which has no cheap real embedding): N = Q diag(d) Q^H, W = Q d^-1/2,
    C = W^H S W, eigh(C) -> (w, U), v = W U.

    Parameters
    ----------
    floor
        Relative floor on the eigenvalues of N (d below floor * d_max are
        clamped), regularising near-singular noise covariances.

    Returns
    -------
    w : (n,) ascending generalised eigenvalues
    v : Z (n, n) eigenvectors (columns), N-orthonormal
    dmin : smallest eigenvalue of N before clamping (diagnostic)
    """
    d, q = eigh(n)
    dmax = d[..., -1]
    dmin = d[..., 0]
    # Floor at the eigh resolution (~eps * dmax) even when no explicit
    # floor is given: roundoff makes the smallest eigenvalues of an
    # ill-conditioned N come out <= 0, and 1/sqrt of those is inf -> NaN.
    # The clamped values are numerically meaningless anyway.  All
    # constants stay inside the f32 exponent range.
    eps = jnp.finfo(d.dtype).eps
    dfloor = jnp.maximum(floor, eps) * dmax[..., None] + 1e-30
    dclamp = jnp.maximum(d, dfloor)
    inv_sqrt = 1.0 / jnp.sqrt(dclamp)

    wmat = q * inv_sqrt[..., None, :]  # Q d^-1/2 (columns scaled)

    # C = W^H S W
    sw = einsum("...ij,...jk->...ik", s, wmat)
    c = einsum("...ji,...jk->...ik", wmat.conj(), sw)
    # Hermitise
    c = Z(0.5 * (c.re + jnp.swapaxes(c.re, -1, -2)), 0.5 * (c.im - jnp.swapaxes(c.im, -1, -2)))

    w, u = eigh(c)
    v = einsum("...ij,...jk->...ik", wmat, u)
    return w, v, dmin


def svd_eigh(m: Z, gram_side: str = "auto", full_matrices: bool = False):
    """SVD of a split matrix via the Gram-matrix eigendecomposition.

    For M (p, q): if q <= p form H = M^H M (q, q), eigh -> V, s^2; then
    U = M V / s.  Otherwise work on M M^H.  Accuracy of small singular
    values is limited to ~sqrt(eps) * s_max — fine for subspace cuts at
    the 1e-4..1e-6 level used in the pipeline (f64 planes give ~1e-8).

    Returns (u Z(p, k), s (k,) descending, vh Z(k, q)), k = min(p, q).
    With ``full_matrices`` and ``gram_side='left'``, u keeps all p columns
    (the trailing ones spanning the left nullspace) and s has length p.
    """
    p, q = m.shape[-2], m.shape[-1]
    if gram_side == "auto":
        gram_side = "right" if q <= p else "left"
    if full_matrices and gram_side != "left":
        raise NotImplementedError("full_matrices requires gram_side='left'")

    if gram_side == "right":
        h = einsum("...ji,...jk->...ik", m.conj(), m)  # M^H M (q, q)
        h = Z(
            0.5 * (h.re + jnp.swapaxes(h.re, -1, -2)),
            0.5 * (h.im - jnp.swapaxes(h.im, -1, -2)),
        )
        w, v = eigh(h)  # ascending
        w = w[..., ::-1]
        v = Z(v.re[..., ::-1], v.im[..., ::-1])
        s = jnp.sqrt(jnp.maximum(w, 0.0))
        k = min(p, q)
        v = Z(v.re[..., :k], v.im[..., :k])
        s = s[..., :k]
        sinv = jnp.where(s > 0, 1.0 / jnp.maximum(s, 1e-300), 0.0)
        u = einsum("...ij,...jk->...ik", m, v)
        u = Z(u.re * sinv[..., None, :], u.im * sinv[..., None, :])
        vh = v.conj().transpose(*range(v.re.ndim - 2), v.re.ndim - 1, v.re.ndim - 2)
        return u, s, vh

    # left gram: M M^H (p, p)
    h = einsum("...ik,...jk->...ij", m, m.conj())
    h = Z(
        0.5 * (h.re + jnp.swapaxes(h.re, -1, -2)),
        0.5 * (h.im - jnp.swapaxes(h.im, -1, -2)),
    )
    w, u = eigh(h)
    w = w[..., ::-1]
    u = Z(u.re[..., ::-1], u.im[..., ::-1])
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    k = p if full_matrices else min(p, q)
    u = Z(u.re[..., :k], u.im[..., :k])
    s = s[..., :k]
    sinv = jnp.where(s > 0, 1.0 / jnp.maximum(s, 1e-300), 0.0)
    # V = M^H U / s ; vh = V^H = (U^H M) / s
    vh = einsum("...ji,...jk->...ik", u.conj(), m)
    vh = Z(vh.re * sinv[..., :, None], vh.im * sinv[..., :, None])
    return u, s, vh


def pinv(m: Z, rcond: float = 1e-6) -> Z:
    """Moore-Penrose pseudo-inverse via svd_eigh."""
    u, s, vh = svd_eigh(m)
    smax = s[..., 0]
    sinv = jnp.where(
        s > rcond * smax[..., None], 1.0 / jnp.maximum(s, 1e-300), 0.0
    )
    v = vh.conj().transpose(*range(vh.re.ndim - 2), vh.re.ndim - 1, vh.re.ndim - 2)
    ut = u.conj().transpose(*range(u.re.ndim - 2), u.re.ndim - 1, u.re.ndim - 2)
    vs = Z(v.re * sinv[..., None, :], v.im * sinv[..., None, :])
    return einsum("...ij,...jk->...ik", vs, ut)
