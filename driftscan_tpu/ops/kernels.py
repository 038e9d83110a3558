"""Beam/fringe pixel kernels — the `_fast_tools` replacement.

The reference implements these hot loops in Cython+OpenMP
(/root/reference/drift/util/_fast_tools.pyx).  Here they are fused
elementwise pipelines over the pixel axis plus two scalar reductions, which
XLA fuses into a handful of memory passes; all functions are jit-compatible
and batch over leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def sph_to_cart(sph):
    """(..., 2) spherical polar (theta, phi) -> (..., 3) cartesian units."""
    theta = sph[..., 0]
    phi = sph[..., 1]
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def thetaphi_plane_cart(sph):
    """Unit vectors (theta_hat, phi_hat) at spherical positions (..., 2)."""
    theta = sph[..., 0]
    phi = sph[..., 1]
    ct, st = jnp.cos(theta), jnp.sin(theta)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    that = jnp.stack([ct * cp, ct * sp, -st], axis=-1)
    phat = jnp.stack([-sp, cp, jnp.zeros_like(sp)], axis=-1)
    return that, phat


def sph_dot(a, b):
    """Dot product of unit vectors given in spherical polars."""
    return jnp.sum(sph_to_cart(a) * sph_to_cart(b), axis=-1)


def fringe(angpos_cart, zenith, uv):
    """Interferometric fringe exp(2 pi i n.u) at each sky position.

    Equivalent of ``_fast_tools.fringe``
    (/root/reference/drift/util/_fast_tools.pyx:18-82), vectorised.

    Parameters
    ----------
    angpos_cart : (npix, 3)
        Cartesian unit vectors of the sky positions (precompute once per
        nside with :func:`sph_to_cart`).
    zenith : (2,)
        Zenith in spherical polars.
    uv : (..., 2)
        Baseline(s) in wavelengths, (u, v) coordinates; leading axes batch.

    Returns
    -------
    fringe : (..., npix) complex
    """
    that, phat = thetaphi_plane_cart(jnp.asarray(zenith))
    uhat, vhat = phat, -that
    uv = jnp.asarray(uv)
    uv3 = uv[..., 0:1] * uhat + uv[..., 1:2] * vhat  # (..., 3)
    # Match the pixel-grid precision so single-precision runs stay in
    # complex64.
    uv3 = uv3.astype(angpos_cart.dtype)
    du = jnp.einsum("...k,pk->...p", uv3, angpos_cart)
    phase = (2 * jnp.pi * du).astype(angpos_cart.dtype)
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def beam_solid_angle(beam, horizon):
    """Omega = Int |beam|^2 over the visible sky (equal-area pixels).

    ``beam`` may be scalar (..., npix) or polarised (..., npix, 2).
    """
    power = jnp.abs(beam) ** 2
    if beam.ndim >= 2 and beam.shape[-1] == 2:
        power = power.sum(axis=-1)
    npix = power.shape[-1]
    return jnp.sum(power * horizon, axis=-1) * (4 * jnp.pi / npix)


def unpolarised_visibility(beam_i, beam_j, fringe_map, horizon, pxarea=None):
    """Normalised visibility transfer map for an unpolarised feed pair.

    Mirrors UnpolarisedTelescope._beam_map_single
    (/root/reference/drift/core/telescope.py:1156-1176).

    ``pxarea`` must be passed explicitly for ring-padded inputs (the
    padding slots inflate the trailing axis, so 4*pi/shape is wrong).
    """
    if pxarea is None:
        pxarea = 4 * jnp.pi / beam_i.shape[-1]
    om_i = jnp.sum(jnp.abs(beam_i) ** 2 * horizon, axis=-1) * pxarea
    om_j = jnp.sum(jnp.abs(beam_j) ** 2 * horizon, axis=-1) * pxarea
    omega_a = jnp.sqrt(om_i * om_j)
    return horizon * fringe_map * beam_i * jnp.conj(beam_j) / omega_a[..., None]


def stokes_visibility(beam_i, beam_j, fringe_map, horizon, pxarea=None):
    """Stokes I/Q/U/V visibility transfer maps for a polarised feed pair.

    Fused equivalent of ``_construct_pol_real`` / ``_construct_pol_complex``
    (/root/reference/drift/util/_fast_tools.pyx:94-242): beams are
    (..., npix, 2) field patterns in the (theta_hat, phi_hat) basis; the
    output is (..., 4, npix), normalised by the geometric mean beam solid
    angle.
    """
    if pxarea is None:
        pxarea = 4 * jnp.pi / beam_i.shape[-2]
    pw_i = jnp.sum(jnp.abs(beam_i) ** 2, axis=-1)
    pw_j = jnp.sum(jnp.abs(beam_j) ** 2, axis=-1)
    om_i = jnp.sum(pw_i * horizon, axis=-1) * pxarea
    om_j = jnp.sum(pw_j * horizon, axis=-1) * pxarea
    prefactor = 1.0 / jnp.sqrt(om_i * om_j)

    tc = prefactor[..., None] * fringe_map * horizon

    bit, bip = beam_i[..., 0], beam_i[..., 1]
    bjt, bjp = jnp.conj(beam_j[..., 0]), jnp.conj(beam_j[..., 1])

    s_i = tc * (bit * bjt + bip * bjp)
    s_q = tc * (bit * bjt - bip * bjp)
    s_u = tc * (bit * bjp + bip * bjt)
    s_v = 1j * tc * (bit * bjp - bip * bjt)

    return jnp.stack([s_i, s_q, s_u, s_v], axis=-2)


def horizon_mask(angpos_cart, zenith):
    """1.0 above the horizon, 0.0 below (matches visibility.horizon)."""
    zc = sph_to_cart(jnp.asarray(zenith))
    proj = angpos_cart @ zc
    return (proj > 0.0).astype(angpos_cart.dtype)


def beam_exptan(sintheta, fwhm):
    """ExpTan beam amplitude model.

    Mirrors ``_fast_tools.beam_exptan``
    (/root/reference/drift/util/_fast_tools.pyx:245-282) including the
    documented extra factor of two relative to eq. 35 of arXiv:1401.2095.
    """
    alpha = jnp.log(2.0) / (2 * jnp.tan(fwhm / 2.0) ** 2)
    st2 = sintheta**2
    tan2 = st2 / (1.0 - st2 + 1e-100)
    return jnp.exp(-alpha * tan2)


def rotate_ypr(rot, xhat, yhat, zhat):
    """Rotate an orthonormal basis by yaw, pitch and roll angles.

    Yaw rotates about z, pitch about the new x, roll about the new y
    (matches the caput.interferometry.rotate_ypr contract the reference's
    cylinder beams rely on; /root/reference/drift/telescope/cylbeam.py:129).
    """
    yaw, pitch, roll = rot

    def _rot(axis, vec, ang):
        # Rodrigues rotation of `vec` about unit `axis`.
        axis = axis / jnp.linalg.norm(axis)
        c, s = jnp.cos(ang), jnp.sin(ang)
        return (
            vec * c
            + jnp.cross(axis, vec) * s
            + axis * jnp.dot(axis, vec) * (1 - c)
        )

    # Yaw about z
    xh = _rot(zhat, xhat, yaw)
    yh = _rot(zhat, yhat, yaw)
    zh = zhat
    # Pitch about x
    yh2 = _rot(xh, yh, pitch)
    zh2 = _rot(xh, zh, pitch)
    # Roll about y
    xh3 = _rot(yh2, xh, roll)
    zh3 = _rot(yh2, zh2, roll)
    return xh3, yh2, zh3


# ------------------------------------------------------------------
# Fused, jitted visibility-map pipelines (one dispatch per batch)
# ------------------------------------------------------------------


@jax.jit
def unpol_visibility_map(beam_i, beam_j, uv, zenith, angpos_cart, horizon, pxarea=None):
    """fringe + normalised unpolarised visibility, fused under one jit."""
    fr = fringe(angpos_cart, zenith, uv)
    return unpolarised_visibility(beam_i, beam_j, fr, horizon, pxarea=pxarea)


@jax.jit
def stokes_visibility_map(beam_i, beam_j, uv, zenith, angpos_cart, horizon, pxarea=None):
    """fringe + Stokes products, fused under one jit."""
    fr = fringe(angpos_cart, zenith, uv)
    return stokes_visibility(beam_i, beam_j, fr, horizon, pxarea=pxarea)


@jax.jit
def unpol_visibility_map_split(beam_i, beam_j, uv, zenith, angpos_cart, horizon, pxarea=None):
    """Split-complex fused unpolarised visibility map."""
    from . import zarray as za

    fr = fringe_split(angpos_cart, zenith, uv)
    return unpolarised_visibility_split(
        za.of(beam_i), za.of(beam_j), fr, horizon, pxarea=pxarea
    )


@jax.jit
def stokes_visibility_map_split(beam_i, beam_j, uv, zenith, angpos_cart, horizon, pxarea=None):
    """Split-complex fused Stokes visibility maps."""
    from . import zarray as za

    fr = fringe_split(angpos_cart, zenith, uv)
    return stokes_visibility_split(
        za.of(beam_i), za.of(beam_j), fr, horizon, pxarea=pxarea
    )


# ------------------------------------------------------------------
# Split-complex variants (DRIFTSCAN_TPU_SPLIT_COMPLEX; see backend.py)
# ------------------------------------------------------------------


def fringe_split(angpos_cart, zenith, uv):
    """Split-complex fringe: Z(cos(2 pi n.u), sin(2 pi n.u))."""
    from . import zarray as za

    that, phat = thetaphi_plane_cart(jnp.asarray(zenith))
    uhat, vhat = phat, -that
    uv = jnp.asarray(uv)
    uv3 = (uv[..., 0:1] * uhat + uv[..., 1:2] * vhat).astype(angpos_cart.dtype)
    du = jnp.einsum("...k,pk->...p", uv3, angpos_cart)
    phase = (2 * jnp.pi * du).astype(angpos_cart.dtype)
    return za.Z(jnp.cos(phase), jnp.sin(phase))


def unpolarised_visibility_split(beam_i, beam_j, fr, horizon, pxarea=None):
    """Split-complex unpolarised visibility map.

    beam_i, beam_j : Z (..., npix); fr : Z fringe; horizon : real mask.
    """
    from . import zarray as za

    if pxarea is None:
        pxarea = 4 * jnp.pi / beam_i.shape[-1]
    om_i = jnp.sum(beam_i.abs2() * horizon, axis=-1) * pxarea
    om_j = jnp.sum(beam_j.abs2() * horizon, axis=-1) * pxarea
    inv_om = (1.0 / jnp.sqrt(om_i * om_j))[..., None]
    bb = beam_i * beam_j.conj()
    out = bb * fr
    return za.Z(out.re * horizon * inv_om, out.im * horizon * inv_om)


def stokes_visibility_split(beam_i, beam_j, fr, horizon, pxarea=None):
    """Split-complex Stokes I/Q/U/V visibility maps.

    beam_i, beam_j : Z (..., npix, 2); output Z (..., 4, npix).
    """
    from . import zarray as za

    if pxarea is None:
        pxarea = 4 * jnp.pi / beam_i.shape[-2]
    pw_i = beam_i.abs2().sum(axis=-1)
    pw_j = beam_j.abs2().sum(axis=-1)
    om_i = jnp.sum(pw_i * horizon, axis=-1) * pxarea
    om_j = jnp.sum(pw_j * horizon, axis=-1) * pxarea
    pref = (1.0 / jnp.sqrt(om_i * om_j))[..., None]

    tc = za.Z(fr.re * horizon * pref, fr.im * horizon * pref)

    bit = za.Z(beam_i.re[..., 0], beam_i.im[..., 0])
    bip = za.Z(beam_i.re[..., 1], beam_i.im[..., 1])
    bjt = za.Z(beam_j.re[..., 0], -beam_j.im[..., 0])  # conj
    bjp = za.Z(beam_j.re[..., 1], -beam_j.im[..., 1])

    tt = bit * bjt
    pp = bip * bjp
    tp = bit * bjp
    pt = bip * bjt

    s_i = tc * (tt + pp)
    s_q = tc * (tt - pp)
    s_u = tc * (tp + pt)
    v0 = tc * (tp - pt)
    s_v = za.Z(-v0.im, v0.re)  # multiply by i

    re = jnp.stack([s_i.re, s_q.re, s_u.re, s_v.re], axis=-2)
    im = jnp.stack([s_i.im, s_q.im, s_u.im, s_v.im], axis=-2)
    return za.Z(re, im)


def polpattern(angpos_cart, dipole_cart):
    """Unit polarisation vectors of a dipole at each sky position.

    Mirrors ``cylbeam.polpattern``
    (/root/reference/drift/telescope/cylbeam.py:10-42): project the dipole
    direction onto the local (theta_hat, phi_hat) plane and normalise.
    """
    theta = jnp.arccos(jnp.clip(angpos_cart[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(angpos_cart[..., 1], angpos_cart[..., 0])
    sph = jnp.stack([theta, phi], axis=-1)
    that, phat = thetaphi_plane_cart(sph)
    vt = that @ dipole_cart
    vp = phat @ dipole_cart
    norm = jnp.sqrt(vt**2 + vp**2)
    norm = jnp.where(norm > 0, norm, 1.0)
    return jnp.stack([vt / norm, vp / norm], axis=-1)
