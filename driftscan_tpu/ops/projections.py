"""Backend-dispatched projection kernels for the product pipeline.

Each function takes/returns host numpy and runs the device computation in
either native complex (the default) or split-complex (re, im) form,
selected by :func:`driftscan_tpu.backend.split_complex`.  These are the
jitted einsums behind BeamTransfer's projection API and the KL
covariance build.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from . import zarray as za


@jax.jit
def _proj_sky_native(beam, cl):
    return jnp.einsum("fapl,pqlfg,gbql->fagb", beam, cl, beam.conj(), optimize=True)


@jax.jit
def _proj_sky_split(b_re, b_im, cl):
    t_re = jnp.einsum("fapl,pqlfg->faqlg", b_re, cl, optimize=True)
    t_im = jnp.einsum("fapl,pqlfg->faqlg", b_im, cl, optimize=True)
    out = za.einsum(
        "faqlg,gbql->fagb", za.Z(t_re, t_im), za.Z(b_re, -b_im), optimize=True
    )
    return out.re, out.im


def sky_covariance_projection(beam4: np.ndarray, cl: np.ndarray) -> np.ndarray:
    """matf[f,a,g,b] = sum_{p,q,l} B[f,a,p,l] C[p,q,l,f,g] conj(B[g,b,q,l]).

    The reference's quadruple (pol^2 x freq^2) loop of matmuls
    (/root/reference/drift/core/beamtransfer.py:1168-1187) as one fused
    contraction.  `cl` must be real (angular power spectra are).
    """
    if backend.split_complex():
        re, im = _proj_sky_split(
            np.ascontiguousarray(beam4.real),
            np.ascontiguousarray(beam4.imag),
            np.ascontiguousarray(np.asarray(cl, dtype=beam4.real.dtype)),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(_proj_sky_native(jnp.asarray(beam4), jnp.asarray(cl)))


@jax.jit
def _diag_native(beam_ut, dmat):
    return jnp.einsum("fat,ft,fbt->fab", beam_ut, dmat, beam_ut.conj())


@jax.jit
def _diag_split(u_re, u_im, dmat):
    x = za.Z(u_re * dmat[:, None, :], u_im * dmat[:, None, :])
    out = za.einsum("fat,fbt->fab", x, za.Z(u_re, -u_im))
    return out.re, out.im


def diag_noise_projection(beam_ut: np.ndarray, dmat: np.ndarray) -> np.ndarray:
    """blocks[f,a,b] = sum_t U[f,a,t] d[f,t] conj(U[f,b,t]) (d real)."""
    if backend.split_complex():
        re, im = _diag_split(
            np.ascontiguousarray(beam_ut.real),
            np.ascontiguousarray(beam_ut.imag),
            np.ascontiguousarray(np.asarray(dmat, dtype=beam_ut.real.dtype)),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(_diag_native(jnp.asarray(beam_ut), jnp.asarray(dmat)))


@jax.jit
def _matvec_native(mats, vecs):
    return jnp.einsum("fij,fj...->fi...", mats, vecs)


@jax.jit
def _matvec_split(m_re, m_im, v_re, v_im):
    out = za.einsum("fij,fj...->fi...", za.Z(m_re, m_im), za.Z(v_re, v_im))
    return out.re, out.im


def block_matvec(mats: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Batched (block-diagonal) matrix @ vector."""
    if backend.split_complex():
        vecs = np.asarray(vecs)
        re, im = _matvec_split(
            np.ascontiguousarray(np.asarray(mats).real),
            np.ascontiguousarray(np.asarray(mats).imag),
            np.ascontiguousarray(vecs.real),
            np.ascontiguousarray(vecs.imag),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(_matvec_native(jnp.asarray(mats), jnp.asarray(vecs)))


class LazyComplex:
    """Device-resident complex result; ``materialize()`` fetches to numpy.

    ``kind`` is "split" (parts = (re, im) device planes) or "complex"
    (parts = (array,)).  Generation stages keep results lazy so the
    device->host fetch overlaps the next chunk's device compute instead
    of serialising behind it.
    """

    def __init__(self, kind: str, *parts):
        self.kind = kind
        self.parts = parts

    def materialize(self) -> np.ndarray:
        if self.kind == "split":
            out = np.asarray(self.parts[0]).astype(np.complex128)
            out += 1j * np.asarray(self.parts[1])
            return out
        return np.asarray(self.parts[0])


class TripleSVDLazy:
    """Device-resident triple-SVD products for one batch.

    Produced by :func:`triple_svd` with ``lazy=True``; ``materialize()``
    returns the same numpy ``(ut, beam, sig, nmodes)`` as the eager
    call.  ``beam_lazy()`` exposes the device-side sky->SVD beam for
    chaining (pseudo-inverse, KL handoff) without a host round-trip.
    """

    def __init__(self, kind: str, n_in: int, arrs: tuple):
        self.kind = kind
        self.n_in = n_in
        self.arrs = arrs

    def beam_lazy(self) -> LazyComplex:
        if self.kind == "split":
            _, _, br, bi, _, _ = self.arrs
            return LazyComplex("split", br, bi)
        _, beam, _, _ = self.arrs
        return LazyComplex("complex", beam)

    def materialize(self):
        n = self.n_in
        if self.kind == "split":
            ur, ui, br, bi, sig, nmodes = self.arrs
            ut = np.asarray(ur)[:n] + 1j * np.asarray(ui)[:n]
            beam = np.asarray(br)[:n] + 1j * np.asarray(bi)[:n]
            return ut, beam, np.asarray(sig)[:n], np.asarray(nmodes)[:n]
        ut, beam, sig, nmodes = self.arrs
        return (
            np.asarray(ut)[:n],
            np.asarray(beam)[:n],
            np.asarray(sig)[:n],
            np.asarray(nmodes)[:n],
        )


def block_pinv(mats: np.ndarray, rcond: float = 1e-6) -> np.ndarray:
    """Batched pseudo-inverse of (possibly complex) blocks."""
    if backend.split_complex():
        m = np.asarray(mats)
        out = za.pinv(
            za.Z(
                jnp.asarray(np.ascontiguousarray(m.real)),
                jnp.asarray(np.ascontiguousarray(m.imag)),
            ),
            rcond=rcond,
        )
        return za.to_numpy(out)
    return np.asarray(jnp.linalg.pinv(jnp.asarray(mats), rcond=rcond))


def block_pinv_lazy(beam: LazyComplex, rcond: float = 1e-6) -> LazyComplex:
    """Batched pseudo-inverse chained on a device-resident input.

    Consumes :class:`LazyComplex` device parts directly (no host
    round-trip of the input) and returns the result lazy.
    """
    if beam.kind == "split":
        out = za.pinv(za.Z(beam.parts[0], beam.parts[1]), rcond=rcond)
        return LazyComplex("split", out.re, out.im)
    return LazyComplex(
        "complex", jnp.linalg.pinv(beam.parts[0], rcond=rcond)
    )


def triple_svd(
    bfm_w: np.ndarray,
    npol: int,
    nl: int,
    polsvcut: float,
    mesh=None,
    lazy: bool = False,
):
    """Dispatching triple SVD: returns numpy (ut, beam, sig, nmodes).

    With a multi-device mesh the leading (unit) axis is sharded and each
    device SVDs its own slice (padding the batch to the device count).
    """
    from . import linalg

    n_in = bfm_w.shape[0]
    if mesh is not None and mesh.devices.size > 1:
        import jax.sharding as jsh

        ndev = mesh.devices.size
        pad = (-n_in) % ndev
        if pad:
            bfm_w = np.concatenate(
                [bfm_w, np.repeat(bfm_w[-1:], pad, axis=0)]
            )
        shard = jsh.NamedSharding(mesh, jsh.PartitionSpec(mesh.axis_names[0]))

        def place(x):
            return jax.device_put(x, shard)

    else:

        def place(x):
            return jnp.asarray(x)

    if backend.split_complex():
        arrs = linalg.triple_svd_split_batched(
            place(np.ascontiguousarray(bfm_w.real)),
            place(np.ascontiguousarray(bfm_w.imag)),
            npol=npol,
            nl=nl,
            polsvcut=polsvcut,
        )
        res = TripleSVDLazy("split", n_in, arrs)
    else:
        arrs = linalg.triple_svd_batched(
            place(bfm_w), npol=npol, nl=nl, polsvcut=polsvcut
        )
        res = TripleSVDLazy("complex", n_in, arrs)
    if lazy:
        return res
    return res.materialize()


# ------------------------------------------------------------------
# m-batched variants (one compile serves every m-chunk of generate())
# ------------------------------------------------------------------


@jax.jit
def _proj_sky_native_m(beam, cl):
    return jnp.einsum(
        "mfapl,pqlfg,mgbql->mfagb", beam, cl, beam.conj(), optimize=True
    )


@jax.jit
def _proj_sky_split_m(b_re, b_im, cl):
    t_re = jnp.einsum("mfapl,pqlfg->mfaqlg", b_re, cl, optimize=True)
    t_im = jnp.einsum("mfapl,pqlfg->mfaqlg", b_im, cl, optimize=True)
    out = za.einsum(
        "mfaqlg,mgbql->mfagb", za.Z(t_re, t_im), za.Z(b_re, -b_im), optimize=True
    )
    return out.re, out.im


def sky_covariance_projection_m(beam5: np.ndarray, cl: np.ndarray) -> np.ndarray:
    """m-batched sky covariance projection: (M,F,S,P,L) -> (M,F,S,F,S)."""
    if backend.split_complex():
        re, im = _proj_sky_split_m(
            np.ascontiguousarray(beam5.real),
            np.ascontiguousarray(beam5.imag),
            np.ascontiguousarray(np.asarray(cl, dtype=beam5.real.dtype)),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(_proj_sky_native_m(jnp.asarray(beam5), jnp.asarray(cl)))


@jax.jit
def _diag_native_m(beam_ut, dmat):
    return jnp.einsum("mfat,ft,mfbt->mfab", beam_ut, dmat, beam_ut.conj())


@jax.jit
def _diag_split_m(u_re, u_im, dmat):
    x = za.Z(u_re * dmat[None, :, None, :], u_im * dmat[None, :, None, :])
    out = za.einsum("mfat,mfbt->mfab", x, za.Z(u_re, -u_im))
    return out.re, out.im


def diag_noise_projection_m(beam_ut: np.ndarray, dmat: np.ndarray) -> np.ndarray:
    """m-batched diagonal noise projection: (M,F,S,T), (F,T) -> (M,F,S,S)."""
    if backend.split_complex():
        re, im = _diag_split_m(
            np.ascontiguousarray(beam_ut.real),
            np.ascontiguousarray(beam_ut.imag),
            np.ascontiguousarray(np.asarray(dmat, dtype=beam_ut.real.dtype)),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(_diag_native_m(jnp.asarray(beam_ut), jnp.asarray(dmat)))


@jax.jit
def _band_proj_native(g, cl):
    # proj[b, k, q] = sum_{l,f,h} G[k,f,l] C_b[l,f,h] conj(G[q,h,l])
    return jnp.einsum("kfl,blfh,qhl->bkq", g, cl, g.conj(), optimize=True)


@jax.jit
def _band_proj_split(g_re, g_im, cl):
    t_re = jnp.einsum("kfl,blfh->bklh", g_re, cl, optimize=True)
    t_im = jnp.einsum("kfl,blfh->bklh", g_im, cl, optimize=True)
    out = za.einsum(
        "bklh,qhl->bkq", za.Z(t_re, t_im), za.Z(g_re, -g_im), optimize=True
    )
    return out.re, out.im


@jax.jit
def _simple_svd_native(bfr):
    from . import linalg

    return linalg.svd_simple_batched(bfr)


@jax.jit
def _simple_svd_split(b_re, b_im):
    u, s, _ = za.svd_eigh(za.Z(b_re, b_im))
    ut = u.conj().transpose(0, 2, 1)
    return ut.re, ut.im, s


def simple_svd(bfm_w: np.ndarray):
    """Batched plain SVD compression (BeamTransferFullSVD / TempSVD).

    bfm_w : (batch, ntel, k) complex.  Returns (ut (batch, kk, ntel)
    with ut = u^H, sig (batch, kk)) as numpy, kk = min(ntel, k).
    Native XLA SVD on complex-capable backends; Gram-eigendecomposition
    SVD (ops.zarray.svd_eigh) on split-complex ones — replacing the
    reference's per-m LAPACK svd (drift/core/beamtransfer.py:1500,1652).
    """
    bfm_w = np.asarray(bfm_w)
    if backend.split_complex():
        ur, ui, s = _simple_svd_split(
            np.ascontiguousarray(bfm_w.real),
            np.ascontiguousarray(bfm_w.imag),
        )
        return np.asarray(ur) + 1j * np.asarray(ui), np.asarray(s)
    ut, s = _simple_svd_native(jnp.asarray(bfm_w))
    return np.asarray(ut), np.asarray(s)


@jax.jit
def _fisher_trace_native(da, cb):
    # F[a, b] = sum_ij D_a[i, j] C_b[j, i]  (D pre-weighted)
    af = da.reshape(da.shape[0], -1)
    bf = jnp.swapaxes(cb, -1, -2).reshape(cb.shape[0], -1)
    return af @ bf.T


@jax.jit
def _fisher_trace_split(da_re, da_im, cb_re, cb_im):
    af = za.Z(da_re.reshape(da_re.shape[0], -1), da_im.reshape(da_im.shape[0], -1))
    bt_re = jnp.swapaxes(cb_re, -1, -2).reshape(cb_re.shape[0], -1)
    bt_im = jnp.swapaxes(cb_im, -1, -2).reshape(cb_im.shape[0], -1)
    out = za.einsum("ax,bx->ab", af, za.Z(bt_re, bt_im))
    return out.re, out.im


def fisher_trace_block(proj_a: np.ndarray, proj_b: np.ndarray, w: np.ndarray):
    """F[a, b] = sum_ij C_a[i, j] C_b[j, i] w_i w_j for two band chunks.

    One (chunk_a, nkl^2) @ (nkl^2, chunk_b) device matmul replaces the
    reference's per-band-pair trace loop
    (/root/reference/drift/core/psestimation.py:775-815).  ``w`` is the
    real inverse-covariance weight vector (1/(1+lambda)); the weights are
    folded into the A side.
    """
    proj_a = np.asarray(proj_a)
    proj_b = np.asarray(proj_b)
    da = proj_a * np.asarray(w)[None, :, None] * np.asarray(w)[None, None, :]
    if backend.split_complex():
        re, im = _fisher_trace_split(
            np.ascontiguousarray(da.real),
            np.ascontiguousarray(da.imag),
            np.ascontiguousarray(proj_b.real),
            np.ascontiguousarray(proj_b.imag),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(
        _fisher_trace_native(jnp.asarray(da), jnp.asarray(proj_b))
    ).astype(np.complex128)


def band_covariance_projection(g: np.ndarray, clarray: np.ndarray) -> np.ndarray:
    """Project every band's angular power spectrum into the KL basis at once.

    g : (nkl, nfreq, lside) complex — the KL modes rotated to the
        (temperature) sky basis at one m.
    clarray : (nbands, lside, nfreq, nfreq) real band spectra.

    Returns (nbands, nkl, nkl) complex — one fused contraction replacing
    the reference's per-band sandwich of projections
    (/root/reference/drift/core/psestimation.py:701-773).
    """
    if backend.split_complex():
        re, im = _band_proj_split(
            np.ascontiguousarray(g.real),
            np.ascontiguousarray(g.imag),
            np.ascontiguousarray(np.asarray(clarray, dtype=g.real.dtype)),
        )
        return np.asarray(re) + 1j * np.asarray(im)
    return np.asarray(_band_proj_native(jnp.asarray(g), jnp.asarray(clarray)))


@functools.partial(
    jax.jit,
    static_argnames=(
        "with_thermal", "fg_levels", "sig_levels", "band_rel", "fg_floor",
        "method", "fg_reg_rel",),
)
def _kl_factored_m(
    b_re,
    b_im,
    ls,
    lf,
    inv_sqrt_nc,
    with_thermal: bool,
    fg_levels: int,
    sig_levels: int,
    band_rel: float,
    fg_floor: float,
    method: str = "qr",
    fg_reg_rel: float = 0.0,
):
    from . import fpencil

    def one(bre, bim):
        b4 = za.Z(bre, bim)
        a_s = fpencil.beam_factor(b4, ls) * inv_sqrt_nc
        a_f = fpencil.beam_factor(b4, lf) * inv_sqrt_nc
        kl = fpencil.kl_solve(
            a_s,
            a_f,
            with_thermal=with_thermal,
            fg_levels=fg_levels,
            sig_levels=sig_levels,
            band_rel=band_rel,
            fg_floor=fg_floor,
            method=method,
            fg_reg_rel=fg_reg_rel,
        )
        return kl.evals, kl.evecs.re, kl.evecs.im

    return jax.vmap(one)(b_re, b_im)


def kl_factored_batched(
    bsvd5: np.ndarray,
    ls: np.ndarray,
    lf: np.ndarray,
    nc: float = 1.0,
    with_thermal: bool = True,
    fg_levels: int = 8,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    fg_floor: float = 1e-6,
    method: str = "qr",
    fg_reg_rel: float = 0.0,
    mesh=None,
    bsvd_dev=None,
    dev_mask=None,
    lazy: bool = False,
):
    """m-batched KL pencil solve on *factored* covariances, mesh-sharded.

    Solves ``S v = w (nc I + F) v`` per m with S/F given by their per-l
    Cholesky factor tables (ops.fpencil) projected through the SVD beams —
    never forming the ill-conditioned dense covariances (the reference
    instead builds them densely per m,
    /root/reference/drift/core/kltransform.py:258-341).

    Parameters
    ----------
    bsvd5 : (M, F, S, npol, nl) complex
        svcut-masked sky -> SVD projections for the m batch.
    ls, lf : (nl, npol, F, npol*F) real
        Signal / foreground factor tables (mstep.prepare_cl_factors).
    nc : float
        Scale of the (identity) projected instrumental noise — 1 with
        thermal noise on, the reference's 1 mK floor scaling otherwise.
    mesh : jax.sharding.Mesh, optional
        If given (and more than one device), the m axis is sharded over
        the mesh and every device solves its own m-modes.

    Returns
    -------
    evals : (M, n) ascending; evecs : (M, n, n) complex columns.
    """
    b_re, b_im, dt = _kl_pencil_planes(bsvd5, bsvd_dev, dev_mask)
    ls = np.asarray(ls, dtype=dt)
    lf = np.asarray(lf, dtype=dt)
    inv_sqrt_nc = np.asarray(1.0 / np.sqrt(nc), dtype=dt)

    kwargs = dict(
        with_thermal=with_thermal,
        fg_levels=fg_levels,
        sig_levels=sig_levels,
        band_rel=band_rel,
        fg_floor=fg_floor,
        method=method,
        fg_reg_rel=fg_reg_rel,
    )

    M = b_re.shape[0]
    b_re, b_im = _kl_pencil_shard(b_re, b_im, mesh)

    w, v_re, v_im = _kl_factored_m(b_re, b_im, ls, lf, inv_sqrt_nc, **kwargs)
    if lazy:
        return KLSolveLazy(M, w, LazyComplex("split", v_re, v_im))
    evecs = (np.asarray(v_re) + 1j * np.asarray(v_im))[:M]
    return np.asarray(w)[:M], evecs


@jax.jit
def _kl_support_stats(v_re, v_im, row_mask):
    p = v_re * v_re + v_im * v_im
    return jnp.einsum("mij,mi->mj", p, row_mask), p.sum(axis=1)


class KLSolveLazy:
    """Device-resident batched KL solve; fetch only what gets written.

    The full eigenvector block is (M, n, n) — by far the largest product
    of the KL stage — while with threshold subsetting only the retained
    tail columns reach the eigenfiles.  This handle keeps the solve on
    device and exposes:

    - ``evals()``: the (M, n) spectrum (small, always fetched);
    - ``support_stats(row_mask)``: the compact-support/total column
      norms used for genuine-vs-padding classification, reduced on
      device so classification never needs the full block;
    - ``evecs_tail(kmax)``: just the last ``kmax`` columns;
    - ``evecs_full()``: the old full fetch (subset=False, fallbacks).
    """

    def __init__(self, M, w, evecs: LazyComplex, ok=None):
        self.M = M
        self._w = w
        self._evecs = evecs
        self._ok = ok

    def evals(self):
        return np.asarray(self._w)[: self.M]

    def ok(self):
        return None if self._ok is None else np.asarray(self._ok)[: self.M]

    def support_stats(self, row_mask):
        v_re, v_im = self._evecs.parts
        mask = np.zeros((v_re.shape[0], v_re.shape[1]), dtype=v_re.dtype)
        mask[: self.M] = row_mask
        sup, tot = _kl_support_stats(v_re, v_im, mask)
        return np.asarray(sup)[: self.M], np.asarray(tot)[: self.M]

    def evecs_tail(self, kmax):
        v_re, v_im = self._evecs.parts
        kmax = int(min(kmax, v_re.shape[-1]))
        out = np.asarray(v_re[:, :, v_re.shape[-1] - kmax :]).astype(
            np.complex128
        )
        out += 1j * np.asarray(v_im[:, :, v_im.shape[-1] - kmax :])
        return out[: self.M]

    def evecs_full(self):
        return self._evecs.materialize()[: self.M]


def _kl_pencil_planes(bsvd5, bsvd_dev, dev_mask):
    """Resolve the KL pencil's (re, im) beam planes and their dtype.

    ``bsvd_dev`` (a LazyComplex from BeamTransfer.device_beam_svd) keeps
    the planes on device — identical values to the host ``bsvd5`` path,
    no upload.  ``dev_mask`` (M, F, S) applies the svcut column mask on
    device (the host path arrives pre-masked).
    """
    if bsvd_dev is not None:
        if bsvd_dev.kind == "split":
            b_re, b_im = bsvd_dev.parts
        else:
            arr = bsvd_dev.parts[0]
            b_re, b_im = jnp.real(arr), jnp.imag(arr)
        if dev_mask is not None:
            m5 = jnp.asarray(dev_mask, dtype=b_re.dtype)[:, :, :, None, None]
            b_re = b_re * m5
            b_im = b_im * m5
    else:
        b_re = np.ascontiguousarray(bsvd5.real)
        b_im = np.ascontiguousarray(bsvd5.imag)
    return b_re, b_im, np.dtype(b_re.dtype)


def _kl_pencil_shard(b_re, b_im, mesh):
    """Pad + shard the m axis over the mesh (jnp ops for device inputs)."""
    if mesh is None or mesh.devices.size <= 1:
        return b_re, b_im
    import jax.sharding as jsh

    xp = jnp if isinstance(b_re, jax.Array) else np
    ndev = mesh.devices.size
    pad = (-b_re.shape[0]) % ndev
    if pad:
        b_re = xp.concatenate([b_re, xp.repeat(b_re[-1:], pad, axis=0)])
        b_im = xp.concatenate([b_im, xp.repeat(b_im[-1:], pad, axis=0)])
    shard = jsh.NamedSharding(mesh, jsh.PartitionSpec(mesh.axis_names[0]))
    return jax.device_put(b_re, shard), jax.device_put(b_im, shard)


@functools.partial(
    jax.jit, static_argnames=("cut", "k", "levels", "fg_reg_rel")
)
def _kl_factored_topband_m(
    b_re, b_im, ls, lf, inv_sqrt_nc, cut, k, levels, fg_reg_rel=0.0
):
    from . import fpencil

    def one(bre, bim):
        b4 = za.Z(bre, bim)
        a_s = fpencil.beam_factor(b4, ls) * inv_sqrt_nc
        a_f = fpencil.beam_factor(b4, lf) * inv_sqrt_nc
        res, ok = fpencil.kl_solve_qr_topband(
            a_s, a_f, cut=cut, k=k, levels=levels, fg_reg_rel=fg_reg_rel
        )
        return res.evals, res.evecs.re, res.evecs.im, ok

    return jax.vmap(one)(b_re, b_im)


def kl_factored_batched_topband(
    bsvd5: np.ndarray,
    ls: np.ndarray,
    lf: np.ndarray,
    cut: float,
    nc: float = 1.0,
    k: int = 0,
    levels: int = 6,
    fg_reg_rel: float = 0.0,
    mesh=None,
    bsvd_dev=None,
    dev_mask=None,
    lazy: bool = False,
):
    """m-batched retained-band KL solve (fpencil.kl_solve_qr_topband).

    Same conventions as :func:`kl_factored_batched`, but only the
    eigenpairs with eigenvalue >= ``cut`` (the caller's KL retention
    threshold) are computed — everything below is exact zeros with zero
    eigenvector columns.  ``k=0`` sizes the filter basis at n/8
    (minimum 8).  Returns (evals (M, n), evecs (M, n, n), ok (M,)
    bool): any False certificate means that m's band overflowed the
    budget — re-solve those with the exact engine.
    """
    b_re, b_im, dt = _kl_pencil_planes(bsvd5, bsvd_dev, dev_mask)
    ls = np.asarray(ls, dtype=dt)
    lf = np.asarray(lf, dtype=dt)
    inv_sqrt_nc = np.asarray(1.0 / np.sqrt(nc), dtype=dt)

    n = b_re.shape[1] * b_re.shape[2]
    if not k:
        k = max(n // 8, 8)

    M = b_re.shape[0]
    b_re, b_im = _kl_pencil_shard(b_re, b_im, mesh)

    w, v_re, v_im, ok = _kl_factored_topband_m(
        b_re, b_im, ls, lf, inv_sqrt_nc,
        cut=float(cut), k=int(min(k, n)), levels=int(levels),
        fg_reg_rel=float(fg_reg_rel),
    )
    if lazy:
        return KLSolveLazy(M, w, LazyComplex("split", v_re, v_im), ok=ok)
    evecs = (np.asarray(v_re) + 1j * np.asarray(v_im))[:M]
    return np.asarray(w)[:M], evecs, np.asarray(ok)[:M]


@functools.partial(
    jax.jit,
    static_argnames=(
        "fg_threshold", "fg_floor", "nc1", "fg_reg_rel", "sig_levels",
        "band_rel",
    ),
)
def _doublekl_factored_m(
    b_re,
    b_im,
    ls,
    lf,
    inv_sqrt_nc,
    fg_threshold: float,
    fg_floor: float,
    nc1,
    fg_reg_rel: float,
    sig_levels: int,
    band_rel: float,
):
    from . import fpencil

    def one(bre, bim):
        b4 = za.Z(bre, bim)
        a_s = fpencil.beam_factor(b4, ls) * inv_sqrt_nc
        a_f = fpencil.beam_factor(b4, lf) * inv_sqrt_nc
        f_evals, evals, v, nkept = fpencil.doublekl_solve_qr(
            a_s,
            a_f,
            fg_threshold=fg_threshold,
            fg_floor=fg_floor,
            nc1=nc1,
            fg_reg_rel=fg_reg_rel,
            sig_levels=sig_levels,
            band_rel=band_rel,
        )
        return f_evals, evals, v.re, v.im, nkept

    return jax.vmap(one)(b_re, b_im)


def doublekl_factored_batched(
    bsvd5: np.ndarray,
    ls: np.ndarray,
    lf: np.ndarray,
    nc: float = 1.0,
    nc1: float | None = None,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    fg_reg_rel: float = 1e-14,
    sig_levels: int = 2,
    band_rel: float = 3e-2,
    mesh=None,
):
    """m-batched two-stage (DoubleKL) factored pencil, mesh-sharded.

    Stage 1 solves the S/F pencil per m; stage 2 re-solves S/(nc I + F)
    on the modes whose S/F exceeds ``fg_threshold`` (mask-static —
    dropped modes emerge with eval 0 / zero columns; the caller compacts
    using ``nkept``).  Accuracy notes as :func:`fpencil.doublekl_solve_qr`;
    reference semantics: /root/reference/drift/core/doublekl.py:30-88.

    Returns (f_evals (M, n) ascending, evals (M, n) ascending,
    evecs (M, n, n) complex columns, nkept (M,) int).
    """
    import jax.sharding as jsh

    b_re = np.ascontiguousarray(bsvd5.real)
    b_im = np.ascontiguousarray(bsvd5.imag)
    dt = b_re.dtype
    ls = np.asarray(ls, dtype=dt)
    lf = np.asarray(lf, dtype=dt)
    inv_sqrt_nc = np.asarray(1.0 / np.sqrt(nc), dtype=dt)

    M = b_re.shape[0]
    if mesh is not None and mesh.devices.size > 1:
        ndev = mesh.devices.size
        pad = (-M) % ndev
        if pad:
            b_re = np.concatenate([b_re, np.repeat(b_re[-1:], pad, axis=0)])
            b_im = np.concatenate([b_im, np.repeat(b_im[-1:], pad, axis=0)])
        ax = mesh.axis_names[0]
        shard = jsh.NamedSharding(mesh, jsh.PartitionSpec(ax))
        b_re = jax.device_put(b_re, shard)
        b_im = jax.device_put(b_im, shard)

    f_ev, ev, v_re, v_im, nkept = _doublekl_factored_m(
        b_re,
        b_im,
        ls,
        lf,
        inv_sqrt_nc,
        fg_threshold=fg_threshold,
        fg_floor=fg_floor,
        nc1=None if nc1 is None else float(nc1 / nc),
        fg_reg_rel=fg_reg_rel,
        sig_levels=sig_levels,
        band_rel=band_rel,
    )
    evecs = (np.asarray(v_re) + 1j * np.asarray(v_im))[:M]
    return (
        np.asarray(f_ev)[:M],
        np.asarray(ev)[:M],
        evecs,
        np.asarray(nkept)[:M],
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "cut", "k", "levels", "fg_threshold", "fg_floor", "nc1", "fg_reg_rel"
    ),
)
def _doublekl_factored_topband_m(
    b_re, b_im, ls, lf, inv_sqrt_nc,
    cut, k, levels, fg_threshold, fg_floor, nc1, fg_reg_rel,
):
    from . import fpencil

    def one(bre, bim):
        b4 = za.Z(bre, bim)
        a_s = fpencil.beam_factor(b4, ls) * inv_sqrt_nc
        a_f = fpencil.beam_factor(b4, lf) * inv_sqrt_nc
        f_evals, evals, v, nkept, ok = fpencil.doublekl_solve_qr_topband(
            a_s,
            a_f,
            cut=cut,
            k=k,
            levels=levels,
            fg_threshold=fg_threshold,
            fg_floor=fg_floor,
            nc1=nc1,
            fg_reg_rel=fg_reg_rel,
        )
        return f_evals, evals, v.re, v.im, nkept, ok

    return jax.vmap(one)(b_re, b_im)


def doublekl_factored_batched_topband(
    bsvd5: np.ndarray,
    ls: np.ndarray,
    lf: np.ndarray,
    cut: float,
    nc: float = 1.0,
    nc1: float | None = None,
    fg_threshold: float = 100.0,
    fg_floor: float = 1e-6,
    fg_reg_rel: float = 1e-14,
    k: int = 0,
    levels: int = 6,
    mesh=None,
):
    """m-batched two-stage DoubleKL through the top-band engine.

    Same conventions and outputs as :func:`doublekl_factored_batched`
    plus a trailing per-m ``ok`` certificate array (the AND of both
    stages); stage 1 computes only the modes it keeps (S/F >
    ``fg_threshold``), stage 2 only those above the final retention
    ``cut`` — everything below either cut is exact zeros.
    """
    import jax.sharding as jsh

    b_re = np.ascontiguousarray(bsvd5.real)
    b_im = np.ascontiguousarray(bsvd5.imag)
    dt = b_re.dtype
    ls = np.asarray(ls, dtype=dt)
    lf = np.asarray(lf, dtype=dt)
    inv_sqrt_nc = np.asarray(1.0 / np.sqrt(nc), dtype=dt)

    n = b_re.shape[1] * b_re.shape[2]
    if not k:
        k = max(n // 8, 8)

    M = b_re.shape[0]
    if mesh is not None and mesh.devices.size > 1:
        ndev = mesh.devices.size
        pad = (-M) % ndev
        if pad:
            b_re = np.concatenate([b_re, np.repeat(b_re[-1:], pad, axis=0)])
            b_im = np.concatenate([b_im, np.repeat(b_im[-1:], pad, axis=0)])
        ax = mesh.axis_names[0]
        shard = jsh.NamedSharding(mesh, jsh.PartitionSpec(ax))
        b_re = jax.device_put(b_re, shard)
        b_im = jax.device_put(b_im, shard)

    f_ev, ev, v_re, v_im, nkept, ok = _doublekl_factored_topband_m(
        b_re, b_im, ls, lf, inv_sqrt_nc,
        cut=float(cut),
        k=int(min(k, n)),
        levels=int(levels),
        fg_threshold=float(fg_threshold),
        fg_floor=float(fg_floor),
        nc1=None if nc1 is None else float(nc1 / nc),
        fg_reg_rel=float(fg_reg_rel),
    )
    evecs = (np.asarray(v_re) + 1j * np.asarray(v_im))[:M]
    return (
        np.asarray(f_ev)[:M],
        np.asarray(ev)[:M],
        evecs,
        np.asarray(nkept)[:M],
        np.asarray(ok)[:M],
    )


def generalised_eigh_batched(A: np.ndarray, B: np.ndarray):
    """m-batched generalised Hermitian eigensolve.

    A, B : (M, n, n).  Returns (w (M, n) ascending, v (M, n, n) columns).
    B must be positive definite (callers pad invalid rows with identity).
    """
    from . import linalg

    if backend.split_complex():
        w, v, _ = za.whiten_eigh(_host_split(A), _host_split(B))
        return np.asarray(w), za.to_numpy(v)
    w, v, _ = linalg.eigh_gen_batched(jnp.asarray(A), jnp.asarray(B))
    return np.asarray(w), np.asarray(v)


def _host_split(x) -> za.Z:
    """Split a host complex array into device-dtype (re, im) planes.

    The split-complex kernels take real planes, never complex arrays.
    """
    x = np.asarray(x)
    return za.Z(
        jnp.asarray(np.ascontiguousarray(x.real)),
        jnp.asarray(np.ascontiguousarray(x.imag)),
    )


def _bucket_pad(A, B):
    """Pad a Hermitian pencil to the next power-of-two size.

    Padding dims get S = -I, N = I: their generalised eigenvalues are
    exactly -1 (below any genuine eigenvalue of a PSD signal), so they
    sort first and slice off deterministically, and the block-diagonal
    structure keeps genuine eigenvectors confined to the original
    subspace.  One compile then serves every per-m size in a bucket.
    """
    n = A.shape[0]
    nb = 1 << max(n - 1, 7).bit_length()
    if nb == n:
        return A, B, 0
    Ap = np.zeros((nb, nb), dtype=A.dtype)
    Bp = np.eye(nb, dtype=B.dtype)
    Ap[:n, :n] = A
    Bp[:n, :n] = B
    pad = np.arange(n, nb)
    Ap[pad, pad] = -1.0
    return Ap, Bp, nb - n


def generalised_eigh(A: np.ndarray, B: np.ndarray, message: str = ""):
    """Dispatching generalised Hermitian eigensolve (see linalg.eigh_gen)."""
    from . import linalg

    if not backend.split_complex():
        return linalg.eigh_gen(A, B, message=message)

    n = A.shape[0]
    if (A == 0).all():
        return (
            np.zeros(n, dtype=A.real.dtype),
            np.identity(n, dtype=A.dtype),
            0.0,
        )

    Ap, Bp, npad = _bucket_pad(A, B)

    def solve(a, b):
        w, v, dmin = za.whiten_eigh(_host_split(a), _host_split(b))
        # ascending: the npad marker eigenvalues (-1) come first
        return (
            np.asarray(w)[npad:],
            za.to_numpy(v)[:n, npad:],
            float(dmin),
        )

    w, v, dmin = solve(Ap, Bp)
    add_const = 0.0
    if not (np.isfinite(w).all() and dmin > 0):
        # Mirror the reference's regularisation ladder
        evb = np.sort(np.asarray(za.eigvalsh(_host_split(B))))
        add_const = 1e-15 * evb[-1] - 2.0 * evb[0] + 1e-30
        Breg = B + add_const * np.identity(n, dtype=B.dtype)
        Ap, Bp, npad = _bucket_pad(A, Breg)
        w, v, _ = solve(Ap, Bp)
    return w, v, float(add_const)
