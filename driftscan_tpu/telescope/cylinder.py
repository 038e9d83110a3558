"""Cylinder telescopes.

Behaviour matches the reference cylinder models
(/root/reference/drift/telescope/cylinder.py): N-S oriented parabolic
cylinders, regularly spaced feeds along each axis, optional exclusion of
intra-cylinder baselines, and Fraunhofer-diffraction beams (cylbeam).
The YAML property names are part of the config contract.
"""

from __future__ import annotations

import numpy as np

from .. import config
from ..core import telescope
from . import cylbeam

# FWHM of the fiducial dipole illumination (radians); the e/h width
# properties scale it.
_DIPOLE_FWHM = 2.0 * np.pi / 3.0


class CylinderTelescope(telescope.TransitTelescope):
    """Common functionality for N-S oriented cylinder telescopes.

    Config attributes mirror the reference: number/width/spacing of the
    cylinders, feeds per cylinder and their spacing, whether in-cylinder
    correlations are kept, and the E/H plane feed beam widths.
    """

    num_cylinders = config.Property(proptype=int, default=2)
    num_feeds = config.Property(proptype=int, default=6)

    cylinder_width = config.Property(proptype=float, default=20.0)
    feed_spacing = config.Property(proptype=float, default=0.5)

    in_cylinder = config.Property(proptype=bool, default=True)

    touching = config.Property(proptype=bool, default=True)
    cylspacing = config.Property(proptype=float, default=0.0)

    non_commensurate = config.Property(proptype=bool, default=False)

    e_width = config.Property(proptype=float, default=0.7)
    h_width = config.Property(proptype=float, default=1.0)

    _fwhm_e = _DIPOLE_FWHM
    _fwhm_h = _DIPOLE_FWHM

    @property
    def fwhm_e(self):
        """Full width half max of the E-plane antenna beam."""
        return self._fwhm_e * self.e_width

    @property
    def fwhm_h(self):
        """Full width half max of the H-plane antenna beam."""
        return self._fwhm_h * self.h_width

    @property
    def u_width(self):
        return self.cylinder_width

    @property
    def v_width(self):
        return 0.0

    def _unique_baselines(self):
        """Optionally exclude intra-cylinder (u == 0) baselines."""
        base_map, base_mask = super()._unique_baselines()
        if self.in_cylinder:
            return base_map, base_mask

        # Separations with no east-west component connect feeds on the
        # same cylinder; drop them and relabel the survivors.
        du = (
            self.feedpositions[:, np.newaxis, 0]
            - self.feedpositions[np.newaxis, :, 0]
        )
        base_mask = base_mask & (du != 0.0)
        return telescope._remap_keyarray(base_map, base_mask), base_mask

    @property
    def cylinder_spacing(self):
        if self.touching:
            return self.cylinder_width
        if self.cylspacing is None:
            raise ValueError("Need to set cylinder spacing if not touching.")
        return self.cylspacing

    def _cylinder_layout(self, cylinder_index):
        """(nfeed_cyl, spacing) for one cylinder.

        With ``non_commensurate`` each successive cylinder drops one feed
        and stretches the spacing so the arrays stay co-extensive.
        """
        if self.non_commensurate:
            nf = self.num_feeds - cylinder_index
            return nf, self.feed_spacing * nf / (nf - 1.0)

        # commensurate layout: every cylinder identical
        return self.num_feeds, self.feed_spacing

    def feed_positions_cylinder(self, cylinder_index):
        """(num_feeds, 2) feed positions on one cylinder."""
        if not 0 <= cylinder_index < self.num_cylinders:
            raise ValueError("Cylinder index is invalid.")

        nf, sp = self._cylinder_layout(cylinder_index)
        x = np.full(nf, cylinder_index * self.cylinder_spacing)
        y = sp * np.arange(nf)
        return np.column_stack([x, y])

    @property
    def _single_feedpositions(self):
        return np.concatenate(
            [
                self.feed_positions_cylinder(ci)
                for ci in range(self.num_cylinders)
            ]
        )

    def _feed_beam(self, pattern, freq, fwhm_ew, fwhm_ns):
        """Evaluate a cylbeam pattern at the current sky grid and
        frequency (cylinder width in wavelengths)."""
        return pattern(
            self._angpos,
            self.zenith,
            self.cylinder_width / self.wavelengths[freq],
            fwhm_ew,
            fwhm_ns,
        )

    def _feed_beam_device(self, freq, fwhm_ew, fwhm_ns, pol):
        """Accelerator-evaluated cylbeam at the current grid (see
        cylbeam.beam_device); only valid after ``_init_trans``."""
        return cylbeam.beam_device(
            self._angpos_cart,
            self._horizon,
            self.zenith,
            self.cylinder_width / self.wavelengths[freq],
            fwhm_ew,
            fwhm_ns,
            pol=pol,
        )

    _beam_bank = None

    def _beam_bank_rows(self, freq, polarised):
        """Device rows (params (C, 12), fx (C, nfx)) for one frequency.

        The whole band's Fraunhofer tables and beam parameters are
        packed host-side once and uploaded in a single transfer
        (cylbeam.build_beam_bank) — per-frequency beam evals are then
        one device dispatch instead of ~7 small uploads.
        """
        import jax.numpy as jnp

        if self._beam_bank is None:
            params, tables = cylbeam.build_beam_bank(
                self.zenith,
                self.cylinder_width / self.wavelengths,
                self.fwhm_e,
                self.fwhm_h,
                polarised,
                dtype=np.float32 if self.single_precision else np.float64,
            )
            self._beam_bank = (jnp.asarray(params), jnp.asarray(tables))
        params, tables = self._beam_bank
        return params[freq], tables[freq]

    def _beam_device_eval_all_cyl(self, freq, polarised):
        par, fx = self._beam_bank_rows(int(freq), polarised)
        return cylbeam._beam_bank_kernel(
            self._angpos_cart, self._horizon, fx, par, polarised=polarised
        )


class UnpolarisedCylinderTelescope(
    CylinderTelescope, telescope.SimpleUnpolarisedTelescope
):
    """Unpolarised cylinder telescope (amplitude beam only)."""

    def beam(self, feed, freq):
        return self._feed_beam(cylbeam.beam_amp, freq, self.fwhm_h, self.fwhm_h)

    def _beam_device_eval(self, feed, freq):
        """On-device beam (None -> host fallback).

        Gated on the beam methods being this class's own: a subclass
        that overrides the beam physics must fall back to evaluating its
        Python on the host.
        """
        cls = type(self)
        if (
            cls.beam is not UnpolarisedCylinderTelescope.beam
            or cls._feed_beam is not CylinderTelescope._feed_beam
            or not self.single_precision
        ):
            return None
        return self._feed_beam_device(freq, self.fwhm_h, self.fwhm_h, None)

    def _beam_device_eval_all(self, feed, freq):
        """Bank-based eval of every beamclass at ``freq`` in one
        dispatch (None -> per-class fallback; same override gate as
        ``_beam_device_eval``)."""
        cls = type(self)
        if (
            cls.beam is not UnpolarisedCylinderTelescope.beam
            or cls._feed_beam is not CylinderTelescope._feed_beam
            or cls._beam_device_eval
            is not UnpolarisedCylinderTelescope._beam_device_eval
            or not self.single_precision
        ):
            return None
        out = self._beam_device_eval_all_cyl(freq, polarised=False)
        base = int(self.beamclass[feed])
        return {base: out[0]}


class PolarisedCylinderTelescope(
    CylinderTelescope, telescope.SimplePolarisedTelescope
):
    """Polarised cylinder telescope with X/Y dipole feeds."""

    def beamx(self, feed, freq):
        return self._feed_beam(cylbeam.beam_x, freq, self.fwhm_e, self.fwhm_h)

    def beamy(self, feed, freq):
        return self._feed_beam(cylbeam.beam_y, freq, self.fwhm_e, self.fwhm_h)

    def _beam_device_eval(self, feed, freq):
        """On-device X/Y dipole beam (None -> host fallback; see the
        unpolarised variant for the override gate)."""
        cls = type(self)
        if (
            cls.beamx is not PolarisedCylinderTelescope.beamx
            or cls.beamy is not PolarisedCylinderTelescope.beamy
            or cls.beam is not telescope.SimplePolarisedTelescope.beam
            or cls._feed_beam is not CylinderTelescope._feed_beam
            or not self.single_precision
        ):
            return None
        # beam_y swaps the fwhm order (H-plane east-west, E-plane
        # north-south) — mirror beamx/beamy above.
        if self.beamclass[feed] % 2 == 0:
            return self._feed_beam_device(freq, self.fwhm_e, self.fwhm_h, "x")
        return self._feed_beam_device(freq, self.fwhm_h, self.fwhm_e, "y")

    def _beam_device_eval_all(self, feed, freq):
        """Both dipole beams at ``freq`` in one bank dispatch (None ->
        per-class fallback; same override gate as ``_beam_device_eval``)."""
        cls = type(self)
        if (
            cls.beamx is not PolarisedCylinderTelescope.beamx
            or cls.beamy is not PolarisedCylinderTelescope.beamy
            or cls.beam is not telescope.SimplePolarisedTelescope.beam
            or cls._feed_beam is not CylinderTelescope._feed_beam
            or cls._beam_device_eval
            is not PolarisedCylinderTelescope._beam_device_eval
            or not self.single_precision
        ):
            return None
        out = self._beam_device_eval_all_cyl(freq, polarised=True)
        base = int(self.beamclass[feed]) & ~1
        return {base: out[0], base + 1: out[1]}
