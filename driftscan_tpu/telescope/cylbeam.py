"""Cylinder feed beam models.

Functional parity with /root/reference/drift/telescope/cylbeam.py: a feed
illuminates a parabolic cylinder; the E-W beam is the Fraunhofer
diffraction pattern of the feed's aperture distribution (computed once per
(fwhm, width) on the host by FFT and interpolated), and the N-S beam is
the ExpTan model.  The per-pixel evaluation is jnp so it batches/fuses on
the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import kernels


def polpattern(angpos, dipole):
    """Unit polarisation vectors for a dipole direction at each position.

    angpos : (npix, 2) spherical; dipole : (2,) spherical or (3,) cartesian.
    Returns (npix, 2) vectors in the (theta_hat, phi_hat) basis.
    """
    dipole = jnp.asarray(dipole)
    if dipole.shape[0] == 2:
        dipole = kernels.sph_to_cart(dipole)
    cart = kernels.sph_to_cart(jnp.asarray(angpos))
    return kernels.polpattern(cart, dipole)


def beam_dipole(theta, phi, squint):
    """Beam of a dipole above a ground plane."""
    return (1 - jnp.sin(theta) ** 2 * jnp.sin(phi) ** 2) ** (squint / 2) * jnp.sin(
        0.5 * jnp.pi * jnp.cos(theta)
    )


def beam_exptan(sintheta, fwhm):
    """ExpTan feed illumination model (see ops.kernels.beam_exptan)."""
    return kernels.beam_exptan(jnp.asarray(sintheta), fwhm)


@functools.lru_cache(maxsize=1024)
def fraunhofer_cylinder(fwhm_x: float, width: float, res: float = 1.0):
    """1-D Fraunhofer diffraction pattern of an ExpTan feed on a cylinder.

    Physics per the reference cylinder model
    (/root/reference/drift/telescope/cylbeam.py:52-95): a feed at the
    focus illuminates the aperture with an ExpTan profile in the angle to
    the cylinder surface (``sin(angle) = 2u / (1 + u^2)`` for normalised
    aperture coordinate ``u``); the far-field E-W beam is the Fourier
    transform of that aperture distribution, evaluated against
    ``sin(theta)`` in units of the cylinder width.

    Construction: the aperture is sampled directly on an fft-ordered,
    ``res * 16``-fold zero-padded grid (no shift/pack step), transformed,
    peak-normalised and trimmed to the physical region (a margin past
    |sin(theta)| = 1).

    Returns (sin_theta, amplitude) numpy sample arrays for interpolation,
    in ascending sin_theta order.
    """
    half = 256  # aperture samples per unit of u
    n = int(res * 16) * 2 * half  # padded grid length

    # fft-ordered integer offsets -> aperture coordinate u in [-1, 1]
    offs = np.fft.fftfreq(n, 1.0 / n)
    u = offs / half
    inside = np.abs(u) <= 1.0

    st = 2.0 * u / (1.0 + u * u)  # sin(feed -> surface angle)
    alpha = np.log(2.0) / (2.0 * np.tan(0.5 * fwhm_x) ** 2)
    tan2 = st * st / np.maximum(1.0 - st * st, 1e-100)
    aperture = np.where(inside, np.exp(-alpha * tan2), 0.0)

    pattern = np.fft.fft(aperture).real
    sin_theta = np.fft.fftfreq(n, 1.0 / (2.0 * half)) / width

    keep = np.abs(sin_theta) < 1.1
    order = np.argsort(sin_theta[keep])
    return (
        sin_theta[keep][order],
        (pattern / pattern.max())[keep][order],
    )


def _basis(zenith, rot):
    that, phat = kernels.thetaphi_plane_cart(jnp.asarray(zenith))
    zhat = kernels.sph_to_cart(jnp.asarray(zenith))
    return kernels.rotate_ypr(jnp.asarray(rot), phat, -that, zhat)


def beam_amp(angpos, zenith, width, fwhm_x, fwhm_y, rot=(0.0, 0.0, 0.0)):
    """Amplitude beam of a cylinder feed over the sky.

    E-W from the Fraunhofer pattern of an ExpTan feed of ``fwhm_x`` on a
    cylinder of ``width`` wavelengths; N-S an ExpTan of ``fwhm_y``.
    """
    xhat, yhat, zhat = _basis(zenith, rot)

    kx, fx = fraunhofer_cylinder(float(fwhm_x), float(width))

    cvec = kernels.sph_to_cart(jnp.asarray(angpos))
    horizon = (cvec @ kernels.sph_to_cart(jnp.asarray(zenith)) > 0.0).astype(
        jnp.float64
    )

    ew_amp = jnp.interp(cvec @ xhat, jnp.asarray(kx), jnp.asarray(fx))
    ns_amp = kernels.beam_exptan(cvec @ yhat, fwhm_y)

    return ew_amp * ns_amp * horizon


def _basis_np(zenith, rot):
    """Host numpy copy of the rotated (xhat, yhat, zhat) feed basis.

    The basis is three 3-vectors; computing it eagerly on the
    accelerator would cost ~10 op dispatches and a fetch, so pin the
    tiny computation to the local CPU backend.
    """
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        xhat, yhat, zhat = _basis(np.asarray(zenith, dtype=np.float64), rot)
        return np.asarray(xhat), np.asarray(yhat), np.asarray(zhat)


@functools.partial(jax.jit, static_argnames=("polarised",))
@functools.partial(jax.jit, static_argnames=("polarised",))
def _beam_device_kernel(
    cart, horizon, fx, kx0, inv_step, xhat, yhat, dipole, fwhm_ns, *, polarised
):
    """On-device cylinder beam: uniform-grid interp of the Fraunhofer
    table times the ExpTan N-S profile (and the dipole polarisation
    pattern when ``polarised``).

    The Fraunhofer abscissae are a uniform grid by construction
    (fftfreq), so the E-W lookup is direct index arithmetic — one gather
    instead of a searchsorted chain.

    jitted into ONE program: eager op-by-op dispatch of this ~15-op
    chain over a 12.6M-pixel grid makes ~15 full passes over memory per
    (freq, beamclass), with 512 evals per m-window at production scale;
    fused it is a few memory passes.
    """
    x = cart @ xhat
    t = (x - kx0) * inv_step
    i0 = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, fx.shape[0] - 2)
    frac = t - i0.astype(t.dtype)
    # Two 1-D element gathers, NOT one pair gather: any gather whose
    # output carries the 2-wide pair axis materialises [npix, 2] (XLA
    # emits offset dims minor, then transposes), which a tiled layout
    # can pad many-fold at nside 1024.  1-D outputs stay flat.
    ew0 = jnp.take(fx, i0)
    ew1 = jnp.take(fx, i0 + 1)
    ew = ew0 * (1.0 - frac) + ew1 * frac
    ns = kernels.beam_exptan(cart @ yhat, fwhm_ns)
    amp = ew * ns * horizon
    if not polarised:
        return amp
    return amp[:, None] * kernels.polpattern(cart, dipole)


def beam_device(cart, horizon, zenith, width, fwhm_ew, fwhm_ns, pol=None,
                rot=(0.0, 0.0, 0.0)):
    """Evaluate a cylinder beam directly on the accelerator.

    Same physics as :func:`beam_amp` / :func:`beam_x` / :func:`beam_y`
    (``pol`` in {None, "x", "y"}; for "y" pass the fwhms already
    swapped), but taking the device-resident pixel grid ``cart``
    ((npix, 3) cartesian) and ``horizon`` mask as inputs, so only the
    ~KB Fraunhofer table crosses the host link instead of the ~npix-sized
    beam map.  The table length is padded to a power of two (edge value;
    arguments stay inside the physical region) so every frequency of a
    band shares one compiled program.
    """
    kx, fx = fraunhofer_cylinder(float(fwhm_ew), float(width))
    step = kx[1] - kx[0]
    n = len(fx)
    npad = (1 << (n - 1).bit_length()) - n
    if npad:
        fx = np.concatenate([fx, np.full(npad, fx[-1])])
    xhat, yhat, zhat = _basis_np(zenith, rot)
    dt = np.dtype(cart.dtype)
    dipole = yhat if pol == "y" else xhat
    return _beam_device_kernel(
        cart,
        horizon,
        jnp.asarray(fx.astype(dt)),
        jnp.asarray(dt.type(kx[0])),
        jnp.asarray(dt.type(1.0 / step)),
        jnp.asarray(xhat.astype(dt)),
        jnp.asarray(yhat.astype(dt)),
        jnp.asarray(dipole.astype(dt)),
        jnp.asarray(dt.type(fwhm_ns)),
        polarised=pol is not None,
    )


# ------------------------------------------------------------------
# Device-resident beam bank: one upload for a whole frequency band
# ------------------------------------------------------------------
#
# Each on-device eval above still pays ~7 small host->device transfers
# (Fraunhofer table + scalars/axes) per (freq, beamclass), x512 per
# m-window at production scale.  The bank packs every frequency's tables and
# parameters into two arrays uploaded ONCE (~33 MB for 256 freqs), so a
# beam eval is a single dispatch indexing device-resident rows.

_PAR_LEN = 12  # kx0, inv_step, fwhm_ns, xhat(3), yhat(3), dipole(3)


def _bank_row(zenith, width, fwhm_ew, fwhm_ns, pol, rot=(0.0, 0.0, 0.0)):
    """Host (params (12,), kx (n,), fx (n,)) for one (freq, class)."""
    kx, fx = fraunhofer_cylinder(float(fwhm_ew), float(width))
    step = kx[1] - kx[0]
    xhat, yhat, zhat = _basis_np(zenith, rot)
    dipole = yhat if pol == "y" else xhat
    par = np.concatenate(
        [[kx[0], 1.0 / step, fwhm_ns], xhat, yhat, dipole]
    )
    return par, fx


def build_beam_bank(zenith, widths, fwhm_e, fwhm_h, polarised, dtype=np.float32):
    """(params (nfreq, C, 12), fx (nfreq, C, nfx)) host arrays.

    ``widths`` is the per-frequency cylinder width in wavelengths.
    C = 2 (X then Y dipole) when ``polarised``, else 1 (amplitude beam,
    fwhm_h in both planes — matching beam_amp's use in
    UnpolarisedCylinderTelescope).  Rows are edge-padded to the widest
    table so one compiled program serves the whole band.
    """
    rows = []
    for w in widths:
        if polarised:
            rows.append(
                [
                    _bank_row(zenith, w, fwhm_e, fwhm_h, "x"),
                    # beam_y swaps the fwhm order (H-plane east-west)
                    _bank_row(zenith, w, fwhm_h, fwhm_e, "y"),
                ]
            )
        else:
            rows.append([_bank_row(zenith, w, fwhm_h, fwhm_h, None)])
    nfx = max(len(fx) for r in rows for _, fx in r)
    nfx = 1 << (nfx - 1).bit_length()
    C = len(rows[0])
    params = np.zeros((len(rows), C, _PAR_LEN), dtype=dtype)
    tables = np.zeros((len(rows), C, nfx), dtype=dtype)
    for i, r in enumerate(rows):
        for c, (par, fx) in enumerate(r):
            params[i, c] = par
            tables[i, c, : len(fx)] = fx
            tables[i, c, len(fx):] = fx[-1]  # edge padding
    return params, tables


@functools.partial(jax.jit, static_argnames=("polarised",))
def _beam_bank_kernel(cart, horizon, fx_rows, par_rows, *, polarised):
    """All beamclasses of one frequency from bank rows, one dispatch.

    fx_rows (C, nfx), par_rows (C, 12) — device-resident slices of the
    bank.  Returns (C, npix[, 2]).
    """

    def one(fx, par):
        return _beam_device_kernel(
            cart, horizon, fx, par[0], par[1], par[3:6], par[6:9],
            par[9:12], par[2], polarised=polarised,
        )

    return jax.vmap(one)(fx_rows, par_rows)


def beam_x(angpos, zenith, width, fwhm_e, fwhm_h, rot=(0.0, 0.0, 0.0)):
    """(npix, 2) polarised beam of the X (east-pointing) dipole."""
    xhat, yhat, zhat = _basis(zenith, rot)
    cart = kernels.sph_to_cart(jnp.asarray(angpos))
    pvec = kernels.polpattern(cart, xhat)
    amp = beam_amp(angpos, zenith, width, fwhm_e, fwhm_h, rot=rot)
    return amp[:, None] * pvec


def beam_y(angpos, zenith, width, fwhm_e, fwhm_h, rot=(0.0, 0.0, 0.0)):
    """(npix, 2) polarised beam of the Y (north-pointing) dipole."""
    xhat, yhat, zhat = _basis(zenith, rot)
    cart = kernels.sph_to_cart(jnp.asarray(angpos))
    pvec = kernels.polpattern(cart, yhat)
    # Note swapped fwhm order: H-plane east-west, E-plane north-south.
    amp = beam_amp(angpos, zenith, width, fwhm_h, fwhm_e, rot=rot)
    return amp[:, None] * pvec
