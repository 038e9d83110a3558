"""Abstract transit-telescope model and the batched transfer-matrix driver.

Functional parity with /root/reference/drift/core/telescope.py (fresh
implementation).  Metadata (feed layout, unique-baseline discovery,
frequency binning, noise model) is host-side numpy; the hot path — beam
map construction, fringes, Stokes products and the spherical harmonic
transform — is batched JAX over (baseline, frequency) work units instead
of the reference's per-unit Python loop over Cython kernels
(/root/reference/drift/core/telescope.py:818-828).
"""

from __future__ import annotations

import abc
import logging
import os
from functools import cached_property

import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import healpix, kernels, sht

logger = logging.getLogger(__name__)

# Speed of light (m/s) — for wavelength conversion from MHz channels.
C_LIGHT = 299792458.0
# Sidereal day in seconds (used in the radiometer noise model).
T_SIDEREAL = 23.9344696 * 3600.0


def in_range(arr, min, max):
    """True if all entries lie in [min, max)."""
    arr = np.asarray(arr)
    return bool(((arr >= min) & (arr < max)).all())


def out_of_range(arr, min, max):
    return not in_range(arr, min, max)


def map_half_plane(arr):
    """Map 2D separations into the half plane with positive u (E pointing)."""
    arr = np.asarray(arr)
    west = (arr[:, 0] < 0.0) | ((arr[:, 0] == 0.0) & (arr[:, 1] < 0.0))
    return np.where(west[:, np.newaxis], -arr, arr)


def _label_classes(mask, *keys):
    """Dense labels for equal key tuples inside ``mask``; -1 elsewhere.

    Labels are assigned in lexicographic key order (complex keys sort by
    real part, then imaginary — the ordering the conjugation logic in
    :meth:`TransitTelescope._get_unique` relies on).
    """
    mask = np.asarray(mask, dtype=bool)
    sel = np.nonzero(mask.ravel())[0]

    cols = []
    for k in keys:
        k = np.asarray(k).ravel()[sel]
        if np.iscomplexobj(k):
            cols.extend([k.real, k.imag])
        else:
            cols.append(k)

    # np.lexsort keys run last-to-first; we want keys[0] most significant.
    order = np.lexsort(tuple(cols[::-1]))
    boundary = np.zeros(sel.size, dtype=bool)
    for c in cols:
        cs = c[order]
        boundary[1:] |= cs[1:] != cs[:-1]

    labels = np.full(mask.size, -1, dtype=np.int64)
    labels[sel[order]] = np.cumsum(boundary)
    return labels.reshape(mask.shape)


def _class_representatives(labels, mask):
    """First (row-major) (i, j) index inside ``mask`` for every class."""
    flat = labels.ravel()
    sel = np.nonzero(np.asarray(mask, dtype=bool).ravel())[0]
    labs = flat[sel]
    if labs.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    first = np.full(labs.max() + 1, -1, dtype=np.int64)
    first[labs[::-1]] = sel[::-1]  # reversed fill leaves the earliest index
    return np.column_stack(np.unravel_index(first, labels.shape))


def _remap_keyarray(keyarray, mask=None):
    """Assign dense integer labels to the equivalence classes of keys."""
    if mask is None:
        mask = np.ones(keyarray.shape, bool)
    return _label_classes(mask, keyarray)


def _merge_keyarray(keys1, keys2, mask1=None, mask2=None):
    """Merge two key maps into labels for their joint equivalence classes."""
    cmask = np.ones(np.shape(keys1), dtype=bool)
    if mask1 is not None:
        cmask &= mask1
    if mask2 is not None:
        cmask &= mask2

    ckeys = _label_classes(cmask, keys1, keys2)
    if mask1 is None and mask2 is None:
        return ckeys
    return ckeys, cmask


def _get_indices(keyarray, mask=None):
    """One representative (i, j) feed pair per equivalence class."""
    if mask is None:
        mask = np.ones(keyarray.shape, bool)
    return _class_representatives(keyarray, mask)


def sht_unit_chunks(n_units: int, npix: int, npol: int = 1):
    """Split a unit batch into SHT-call chunks bounded by a memory budget.

    The beam-map + SHT program materialises several pixel-grid temporaries
    per unit (fringe phases, Stokes products, ring layout); an unbounded
    unit batch at large nside exhausts device memory (1024 units at
    nside 256 need a 6 GB phase table alone).  The budget is
    ``DRIFTSCAN_TPU_SHT_BUDGET_GB`` (default 2.0) — the analogue of the
    reference's ``mem_chunk`` streaming ceiling
    (/root/reference/drift/core/beamtransfer.py:186,533-544).

    Returns a list of slice lengths (each a power of two, covering
    ``n_units``).
    """
    import os

    budget = float(os.environ.get("DRIFTSCAN_TPU_SHT_BUDGET_GB", "2.0")) * 2**30
    per_unit = npix * 4.0 * 8.0 * max(npol, 1)  # ~8 f32 pixel temporaries
    # No lower floor above 1: at nside 1024 a polarised unit's pixel
    # temporaries are ~1.6 GB, so a forced 8-unit chunk would need
    # ~13 GB whatever the budget.
    cap = max(1, int(budget / max(per_unit, 1.0)))
    cap = 1 << (cap.bit_length() - 1)  # round down to a power of two

    chunks = []
    left = n_units
    while left > 0:
        take = min(cap, left)
        chunks.append(take)
        left -= take
    return chunks


def max_lm(baselines, wavelengths, uwidth, vwidth=0.0):
    """Maximum (l, m) a baseline is sensitive to.

    Same angular-scale law as the reference
    (/root/reference/drift/core/telescope.py:99-122):
    ``mmax = ceil(2 pi u_max)``, ``lmax = ceil(hypot(mmax, 2 pi v_max))``.
    """
    umax = (np.abs(baselines[..., 0]) + uwidth) / wavelengths
    vmax = (np.abs(baselines[..., 1]) + vwidth) / wavelengths

    mmax = np.ceil(2 * np.pi * umax).astype(np.int64)
    lmax = np.ceil((mmax**2 + (2 * np.pi * vmax) ** 2) ** 0.5).astype(np.int64)
    return lmax, mmax


class Observer(config.Reader):
    """Minimal observer location (replaces caput.time.Observer)."""

    latitude = config.Property(proptype=float, default=45.0)
    longitude = config.Property(proptype=float, default=0.0)
    altitude = config.Property(proptype=float, default=0.0)

    def __init__(self, longitude=0.0, latitude=45.0, altitude=0.0, **kwargs):
        self.longitude = longitude
        self.latitude = latitude
        self.altitude = altitude


class TransitTelescope(Observer, metaclass=abc.ABCMeta):
    """Base class for a transit interferometer.

    Subclasses implement ``feedpositions``, ``beamclass``, ``u_width``,
    ``v_width`` and the beam function(s); everything else — frequency
    binning, unique-baseline discovery, lmax/mmax determination, the
    transfer-matrix driver and the noise model — lives here.

    Config attributes mirror /root/reference/drift/core/telescope.py:211-243.
    """

    freq_lower = config.Property(proptype=config.float_or_none, default=None)
    freq_upper = config.Property(proptype=config.float_or_none, default=None)

    freq_start = config.Property(proptype=float, default=800.0)
    freq_end = config.Property(proptype=float, default=400.0)
    num_freq = config.Property(proptype=int, default=1024)

    freq_mode = config.enum(["centre", "centre_nyquist", "edge"], default="centre")

    channel_bin = config.Property(proptype=int, default=1)
    channel_range = config.Property(proptype=list)
    channel_list = config.Property(proptype=list)

    tsys_flat = config.Property(proptype=float, default=50.0, key="tsys")
    ndays = config.Property(proptype=int, default=733)

    accuracy_boost = config.Property(proptype=float, default=1.0)
    l_boost = config.Property(proptype=float, default=1.0)
    force_lmax = config.Property(proptype=int, default=None)
    force_mmax = config.Property(proptype=int, default=None)

    minlength = config.Property(proptype=float, default=0.0)
    maxlength = config.Property(proptype=float, default=1.0e7)

    auto_correlations = config.Property(proptype=bool, default=False)

    local_origin = config.Property(proptype=bool, default=True)

    skip_freq = config.list_type(type_=int, default=[])
    skip_baselines = config.list_type(type_=int, default=[])

    beam_cache_size = config.Property(proptype=int, default=200)

    # Run the beam-map + SHT hot path in complex64.  The reference is
    # complex128 throughout; single precision is ample for the BTM itself
    # (test tolerances are rel 1e-4) and halves its memory traffic.
    single_precision = config.Property(proptype=bool, default=False)

    # Tolerance (decimal places) when comparing baselines for equivalence.
    _bl_tol = 6

    def __init__(self, latitude=45, longitude=0, **kwargs):
        Observer.__init__(self, longitude, latitude, **kwargs)

    # Attributes whose leading underscore would normally exclude them from
    # pickling but should be kept.
    _pickle_keys = []

    def __getstate__(self):
        return {
            k: v
            for k, v in self.__dict__.items()
            if k in self._pickle_keys or not k.startswith("_")
        }

    # ======================= location =========================

    @property
    def zenith(self):
        """Zenith direction in spherical polars [theta, phi]."""
        theta = np.pi / 2.0 - np.radians(self.latitude)
        phi = np.remainder(np.radians(self.longitude), 2 * np.pi)
        phi = 0.0 if self.local_origin else phi
        return np.array([theta, phi])

    # ======================= baselines ========================

    _baselines = None
    _redundancy = None
    _uniquepairs = None
    _feedmap = None
    _feedmask = None
    _feedconj = None

    @property
    def baselines(self):
        """The unique baselines (nbase, 2) in metres."""
        if self._baselines is None:
            self.calculate_feedpairs()
        return self._baselines

    @property
    def redundancy(self):
        if self._redundancy is None:
            self.calculate_feedpairs()
        return self._redundancy

    @property
    def nbase(self):
        return self.npairs

    @property
    def npairs(self):
        return self.uniquepairs.shape[0]

    @property
    def uniquepairs(self):
        if self._uniquepairs is None:
            self.calculate_feedpairs()
        return self._uniquepairs

    @property
    def feedmap(self):
        if self._feedmap is None:
            self.calculate_feedpairs()
        return self._feedmap

    @property
    def feedmask(self):
        if self._feedmask is None:
            self.calculate_feedpairs()
        return self._feedmask

    @property
    def feedconj(self):
        if self._feedconj is None:
            self.calculate_feedpairs()
        return self._feedconj

    def calculate_feedpairs(self):
        """Compute unique feed pairs, their redundancy and baselines.

        Pipeline: (1) label ordered feed pairs by joint (baseline, beam)
        equivalence and join each class with its reversed-pair class
        (:meth:`_get_unique`); (2) orient every class representative to
        point east; (3) relabel classes in (u, v, beamclass_j,
        beamclass_i) order.  Output contract (labels, representative
        choice, redundancy, ordering) matches the reference
        (/root/reference/drift/core/telescope.py:507-700).
        """
        fmap, mask, conj = self._get_unique()

        conj = self._orient_east(fmap, mask, conj)
        fmap = self._rank_pairs(fmap, mask, conj)

        tmask = mask & ~conj
        self._feedmap, self._feedmask, self._feedconj = fmap, mask, conj
        self._uniquepairs = _class_representatives(fmap, tmask)
        if self._uniquepairs.shape[0] == 0:
            raise ValueError(
                "telescope has no included feed pairs — check "
                "auto_correlations (needed for zero-baseline arrays such "
                "as focal planes) and the min/max baseline-length cuts"
            )
        self._redundancy = np.bincount(fmap[tmask])
        self._baselines = (
            self.feedpositions[self._uniquepairs[:, 0]]
            - self.feedpositions[self._uniquepairs[:, 1]]
        )

    def _pair_separations(self, pairs):
        """Feed-position separations for an (n, 2) array of index pairs."""
        return self.feedpositions[pairs[:, 0]] - self.feedpositions[pairs[:, 1]]

    def _orient_east(self, fmap, mask, conj):
        """Flip the conjugation flag of classes whose representative
        separation points west, so every effective baseline has u >= 0."""
        reps = _class_representatives(fmap, mask & ~conj)
        sep = self._pair_separations(reps)
        west = (sep[:, 0] < 0.0) | ((sep[:, 0] == 0.0) & (sep[:, 1] < 0.0))
        flip = np.zeros_like(conj)
        flip[mask] = west[fmap[mask]]
        return conj ^ flip

    def _rank_pairs(self, fmap, mask, conj):
        """Relabel classes in lexicographic (u, v, bc_j, bc_i) order of
        their (east-pointing) representatives."""
        reps = _class_representatives(fmap, mask & ~conj)
        sep = self._pair_separations(reps)
        ci = self.beamclass[reps[:, 0]].astype(np.int32)
        cj = self.beamclass[reps[:, 1]].astype(np.int32)

        order = np.lexsort((ci, cj, sep[:, 1], sep[:, 0]))
        rank = np.empty(order.size, dtype=np.int64)
        rank[order] = np.arange(order.size)

        out = np.full_like(fmap, -1)
        out[mask] = rank[fmap[mask]]
        return out

    def _unique_baselines(self):
        """Key map of equivalent baseline separations + inclusion mask.

        Subclass hook: returns any key array whose equal entries mark
        interchangeable separations (reversed pairs carry the negated
        separation and therefore a different key), plus a symmetric
        inclusion mask.
        """
        sep = self.feedpositions[:, np.newaxis] - self.feedpositions[np.newaxis, :]
        key = np.around(sep[..., 0] + 1.0j * sep[..., 1], self._bl_tol)

        blen = np.hypot(sep[..., 0], sep[..., 1])
        mask = (blen >= self.minlength) & (blen <= self.maxlength)
        if not self.auto_correlations:
            mask &= blen > 0.0

        return _label_classes(mask, key), mask

    def _unique_beams(self):
        """Key map of equivalent beam pairs + inclusion mask (subclass hook)."""
        bc = self.beamclass
        beam_map = _label_classes(
            np.ones((self.nfeed, self.nfeed), dtype=bool),
            np.broadcast_to(bc[:, np.newaxis], (self.nfeed, self.nfeed)),
            np.broadcast_to(bc[np.newaxis, :], (self.nfeed, self.nfeed)),
        )

        if self.auto_correlations:
            beam_mask = np.ones((self.nfeed, self.nfeed), dtype=bool)
        else:
            beam_mask = ~np.identity(self.nfeed, dtype=bool)

        return beam_map, beam_mask

    def _get_unique(self):
        """Label ordered feed pairs by joint (baseline, beam) equivalence
        and join every class with its reversed-pair (conjugate) class.

        Returns (labels, mask, conj) where ``conj`` marks the orientation
        whose ordered-pair class had the larger label (the lexicographic
        key order makes this deterministic; for zero separations it
        resolves to ascending beamclass).
        """
        base_map, base_mask = self._unique_baselines()
        beam_map, beam_mask = self._unique_beams()

        mask = base_mask & beam_mask
        pair_lab = _label_classes(mask, base_map, beam_map)

        conj = pair_lab > pair_lab.T
        joined = np.minimum(pair_lab, pair_lab.T)
        return _label_classes(mask, joined), mask, conj

    # ======================= frequencies ======================

    _frequencies = None

    @property
    def frequencies(self):
        """Band-centre frequencies in MHz."""
        if self._frequencies is None:
            self.calculate_frequencies()
        return self._frequencies

    def calculate_frequencies(self):
        if self.freq_lower or self.freq_upper:
            import warnings

            warnings.warn(
                "`freq_lower` and `freq_upper` parameters are deprecated",
                DeprecationWarning,
            )
            self.freq_start = self.freq_lower
            self.freq_end = self.freq_upper

        if self.freq_mode == "centre":
            frequencies = np.linspace(
                self.freq_start, self.freq_end, self.num_freq, endpoint=False
            )
            df = abs(self.freq_end - self.freq_start) / self.num_freq
        elif self.freq_mode == "centre_nyquist":
            frequencies = np.linspace(
                self.freq_start, self.freq_end, self.num_freq, endpoint=True
            )
            df = abs(self.freq_end - self.freq_start) / (self.num_freq - 1)
        else:  # edge
            df = abs(self.freq_end - self.freq_start) / self.num_freq
            frequencies = self.freq_start + df * (np.arange(self.num_freq) + 0.5)

        if self.channel_bin > 1:
            if self.num_freq % self.channel_bin != 0:
                raise ValueError(
                    "Channel binning must exactly divide the total number of channels"
                )
            frequencies = frequencies.reshape(-1, self.channel_bin).mean(axis=1)
            df = df * self.channel_bin

        # Channel selection (after binning).  ``channel_list`` takes
        # priority over ``channel_range`` (ref drift/core/telescope.py:158-168
        # documents both; the reference raises NotImplementedError for
        # channel_list — here sparse selections are supported, since no
        # downstream stage assumes uniform channel spacing).
        if self.channel_list is not None and len(self.channel_list):
            chans = np.asarray(self.channel_list, dtype=int)
            if chans.min() < 0 or chans.max() >= len(frequencies):
                raise ValueError(
                    f"channel_list entries must be in [0, {len(frequencies)}); "
                    f"got {self.channel_list}"
                )
            frequencies = frequencies[chans]
        elif self.channel_range is not None and len(self.channel_range):
            # [stop], [start, stop] or [start, stop, step]
            frequencies = frequencies[slice(*self.channel_range)]

        self._frequencies = frequencies

    @property
    def wavelengths(self):
        """Band-centre wavelengths in metres."""
        return C_LIGHT / (1e6 * self.frequencies)

    @property
    def nfreq(self):
        return self.frequencies.shape[0]

    # ========================== feeds =========================

    @property
    def input_index(self):
        """Correlator-input labels (draco compatible)."""
        return np.array(np.arange(self.nfeed), dtype=[("chan_id", "u2")])

    @property
    def nfeed(self):
        return self.feedpositions.shape[0]

    # ====================== polarisation ======================

    @property
    def num_pol_sky(self):
        """Sky polarisation components handled (1 = T, 3 = TQU, 4 = TQUV)."""
        return self._npol_sky_

    # ==================== harmonic spread =====================

    @property
    def lmax(self):
        """Maximum l the telescope is sensitive to."""
        if self.force_lmax is not None:
            return self.force_lmax
        lmax, mmax = max_lm(
            self.baselines, self.wavelengths.min(), self.u_width, self.v_width
        )
        return int(np.ceil(lmax.max() * self.l_boost))

    @property
    def mmax(self):
        """Maximum m the telescope is sensitive to."""
        if self.force_mmax is not None:
            return self.force_mmax
        lmax, mmax = max_lm(
            self.baselines, self.wavelengths.min(), self.u_width, self.v_width
        )
        return int(np.ceil(mmax.max() * self.l_boost))

    # ==================== skipped entries =====================

    def _skip_freq(self, freq_ind) -> bool:
        return freq_ind in self.skip_freq

    def _skip_baseline(self, bl_ind) -> bool:
        return bl_ind in self.skip_baselines

    @cached_property
    def included_freq(self) -> np.ndarray:
        return np.array(
            [ind for ind in range(self.nfreq) if not self._skip_freq(ind)], dtype=int
        )

    @cached_property
    def included_baseline(self) -> np.ndarray:
        return np.array(
            [ind for ind in range(self.nbase) if not self._skip_baseline(ind)],
            dtype=int,
        )

    @cached_property
    def included_pol(self) -> np.ndarray:
        return np.arange(self.num_pol_sky)

    # ================== transfer matrices =====================

    def transfer_matrices(self, bl_indices, f_indices, global_lmax=True):
        """Batched transfer matrices for (baseline, frequency) pairs.

        Same contract as the reference
        (/root/reference/drift/core/telescope.py:755-830): returns a
        complex array of shape ``bl.shape + (npol, lside+1, 2*lside+1)``
        in the FFT-like m packing.  Internally the units are evaluated as
        one batched beam-map + SHT program instead of a per-unit loop.
        """
        bl_indices, f_indices = np.broadcast_arrays(bl_indices, f_indices)

        if out_of_range(bl_indices, 0, self.npairs):
            raise ValueError("Baseline indices aren't valid")
        if out_of_range(f_indices, 0, self.nfreq):
            raise ValueError("Frequency indices aren't valid")

        lmax, mmax = np.ceil(
            self.l_boost
            * np.array(
                max_lm(
                    self.baselines[bl_indices],
                    self.wavelengths[f_indices],
                    self.u_width,
                    self.v_width,
                )
            )
        ).astype(np.int64)
        lside = self.lmax if global_lmax else int(lmax.max())

        tshape = bl_indices.shape + (self.num_pol_sky, lside + 1, 2 * lside + 1)
        logger.info(
            "Size: %i elements. Memory %f GB.",
            np.prod(tshape),
            2 * np.prod(tshape) * 8.0 / 2**30,
        )

        flat_bl = bl_indices.ravel()
        flat_f = f_indices.ravel()

        # Bucket the units by the nside their own lmax requires, so short
        # baselines use smaller maps (the reference instead sorts by lmax
        # and regenerates healpix geometry, telescope.py:818).
        nsides = np.array(
            [self._nside_for(lm) for lm in np.ravel(lmax)], dtype=np.int64
        )
        tarray = np.zeros((flat_bl.size,) + tshape[len(bl_indices.shape) :], np.complex128)

        for ns in np.unique(nsides):
            bucket = np.nonzero(nsides == ns)[0]
            sub_lmax = int(np.ravel(lmax)[bucket].max())
            # memory ceiling: chunk the bucket so one SHT call's pixel
            # temporaries stay within budget (large nside x many units)
            off = 0
            for take in sht_unit_chunks(
                len(bucket), 12 * int(ns) ** 2, self.num_pol_sky
            ):
                sel = bucket[off : off + take]
                off += take
                block = self._transfer_batch(
                    flat_bl[sel], flat_f[sel], int(ns), sub_lmax, lside
                )
                # Zero each unit above its own lmax — the reference
                # computes each unit only to its own band limit
                # (telescope.py:821), and the m-mode packing relies on
                # those entries being exactly 0.
                ls = np.arange(lside + 1)
                unit_lmax = np.ravel(lmax)[sel]
                lmask = ls[np.newaxis, :] <= unit_lmax[:, np.newaxis]
                block *= lmask[:, np.newaxis, :, np.newaxis]
                tarray[sel] = block

        return tarray.reshape(tshape)

    def _nside_for(self, lmax: int) -> int:
        """Pixelisation for a unit's band limit (reference
        drift/core/telescope.py:227 ``accuracy_boost`` semantics).

        ``DRIFTSCAN_TPU_NSIDE_CAP`` (power of two, 0/unset = off) clamps
        the boosted nside from above, but never below the un-boosted
        adequacy criterion ``2*nside >= lmax``: the boost doubling is a
        margin knob, and at band limits just past a power-of-two
        boundary (e.g. lmax 1035) it quadruples the pixel grid for the
        few longest-baseline units, whose ring-padded geometry program
        alone takes ~17 GB at nside 2048.  The cap trades that margin
        back for those units only; everything at or below the cap is
        untouched.
        """
        ns = healpix.nside_for_lmax(int(lmax), accuracy_boost=self.accuracy_boost)
        cap = int(os.environ.get("DRIFTSCAN_TPU_NSIDE_CAP", "0") or 0)
        if cap:
            floor = healpix.nside_for_lmax(int(lmax), accuracy_boost=0.0)
            ns = max(min(ns, cap), floor)
        return ns

    def _transfer_batch(self, bl_ind, f_ind, nside, lmax, lside):
        """Compute transfer matrices for a batch of units at one nside.

        Returns (nunit, npol, lside+1, 2*lside+1) complex128 numpy.
        """
        self._init_trans(nside)

        from .. import backend
        from ..ops import zarray as za

        # Pad the unit batch up to a power of two so jitted kernels and the
        # SHT compile for a bounded set of shapes across chunks.
        nu = len(bl_ind)
        nu_pad = 1 << max(nu - 1, 0).bit_length()
        if nu_pad != nu:
            bl_ind = np.concatenate([bl_ind, np.repeat(bl_ind[-1], nu_pad - nu)])
            f_ind = np.concatenate([f_ind, np.repeat(f_ind[-1], nu_pad - nu)])

        if backend.split_complex():
            # Split-complex path: conj(cvis) -> SHT -> conj, on (re, im)
            # planes (complex dtypes unsupported on this accelerator).
            cvis = self._beam_map_batch_split(bl_ind, f_ind)
            if self.single_precision:
                cvis = cvis.astype(jnp.float32)
            pos_z, neg_z = sht.analysis_split(
                cvis.conj(), lmax=lmax, neg_m=True,
                nside=self._nside, ring_padded=True,
            )
            pos = np.conj(za.to_numpy(pos_z))
            neg = np.conj(za.to_numpy(neg_z))
        else:
            cvis = self._beam_map_batch(bl_ind, f_ind)  # (nu, [npol,] npix)
            if self.single_precision:
                cvis = cvis.astype(jnp.complex64)

            # SHT with the reference's conjugation convention:
            # btrans = SHT(conj(cvis)).conj()  (telescope.py:1188-1191)
            pos, neg = sht.analysis(
                jnp.conj(cvis), lmax=lmax, neg_m=True,
                nside=self._nside, ring_padded=True,
            )
            pos = np.conj(np.asarray(pos))
            neg = np.conj(np.asarray(neg))

        packed = sht.pack_fftlike(pos, neg, lside)
        packed = packed[:nu]

        if packed.ndim == 3:  # unpolarised: add the pol axis
            packed = packed.reshape(nu, 1, lside + 1, 2 * lside + 1)

        if packed.shape[1] < self.num_pol_sky:
            pad = np.zeros(
                (nu, self.num_pol_sky - packed.shape[1], lside + 1, 2 * lside + 1),
                dtype=np.complex128,
            )
            packed = np.concatenate([packed, pad], axis=1)

        return packed

    @abc.abstractmethod
    def _beam_map_batch(self, bl_ind, f_ind):
        """Visibility beam maps for a batch of units at the current nside.

        Returns (nunit, npix) complex for unpolarised telescopes or
        (nunit, npol_transform, npix) for polarised ones.
        """

    def transfer_for_frequency(self, freq):
        """All transfer matrices at one frequency."""
        bi = np.arange(self.npairs)
        fi = freq * np.ones_like(bi)
        return self.transfer_matrices(bi, fi)

    def transfer_for_baseline(self, baseline):
        """All transfer matrices for one baseline."""
        fi = np.arange(self.nfreq)
        bi = baseline * np.ones_like(fi)
        return self.transfer_matrices(bi, fi)

    # ========================= noise ==========================

    def tsys(self, f_indices=None):
        """System temperature (K) at the given frequency indices."""
        freq = (
            self.frequencies if f_indices is None else self.frequencies[f_indices]
        )
        return np.ones_like(freq) * self.tsys_flat

    def noisepower(self, bl_indices, f_indices, ndays=None):
        """Radiometer noise power spectrum, white in m.

        Matches /root/reference/drift/core/telescope.py:894-926.
        """
        ndays = self.ndays if not ndays else ndays

        bl_indices, f_indices = np.broadcast_arrays(bl_indices, f_indices)

        bw = np.abs(self.frequencies[1] - self.frequencies[0]) * 1e6
        delnu = T_SIDEREAL * bw / (2 * np.pi)
        noisepower = self.tsys(f_indices) ** 2 / (2 * np.pi * delnu * ndays)
        noisebase = noisepower / self.redundancy[bl_indices]
        return noisebase

    def noisepower_feedpairs(self, fi, fj, f_indices, m, ndays=None):
        ndays = self.ndays if not ndays else ndays
        bw = np.abs(self.frequencies[1] - self.frequencies[0]) * 1e6
        delnu = T_SIDEREAL * bw / (2 * np.pi)
        noisepower = self.tsys(f_indices) ** 2 / (2 * np.pi * delnu * ndays)
        return (
            np.ones_like(fi) * np.ones_like(fj) * np.ones_like(m) * noisepower / 2.0
        )

    # ================== healpix working state =================

    _nside = None

    def _init_trans(self, nside):
        """(Re)generate per-nside sky geometry: positions and horizon.

        The *device* pixel grid lives in the padded (ring, slot) layout
        (flat (nring*maxlen,); padding slots have horizon 0): every
        pixel-space op is elementwise, and the SHT then consumes the
        maps directly (``ring_padded=True``) instead of paying a
        ~200M-element entry gather per call at nside 1024.  Host beam
        evaluation still uses
        the compact ``self._angpos``; its maps are padded on upload.
        """
        if self._nside == nside:
            return
        self._nside = nside
        self._angpos = healpix.ang_positions(nside)
        geom = healpix.ring_geometry(nside)
        pix = np.asarray(geom.pix_index).ravel()
        padmask = np.asarray(geom.mask).ravel()
        self._ring_pad_index = pix
        self._ring_pad_mask = padmask
        angpos_pad = self._angpos[pix]
        cart = kernels.sph_to_cart(jnp.asarray(angpos_pad))
        horizon = kernels.horizon_mask(cart, jnp.asarray(self.zenith))
        horizon = horizon * jnp.asarray(padmask, dtype=horizon.dtype)
        if self.single_precision:
            cart = cart.astype(jnp.float32)
            horizon = horizon.astype(jnp.float32)
        self._angpos_cart = jnp.asarray(cart)
        self._horizon = jnp.asarray(horizon)

    _beam_cache = None
    _beam_cache_bytes = 0

    def _beam(self, feed_ind, freq_ind):
        """Beam map for a feed, cached by (nside, freq, beamclass).

        Beams are evaluated on the *host* CPU backend: they are small
        one-off per-(freq, beamclass) computations built from arbitrary
        subclass Python (possibly scipy), and eager dispatch of their op
        chains to the accelerator costs more than computing them locally.
        The batched hot path ships the cached maps to the accelerator in
        one transfer.
        """
        import jax

        if self._beam_cache is None:
            self._beam_cache = {}
            self._beam_cache_bytes = 0

        beamclass = self.beamclass[feed_ind]
        key = (self._nside, freq_ind, beamclass)

        if key not in self._beam_cache:
            # local_devices, not devices: in a multi-process jax.distributed
            # cluster jax.devices("cpu")[0] is process 0's device, which is
            # non-addressable from other ranks (their beam outputs would be
            # unfetchable global arrays).
            cpu = jax.local_devices(backend="cpu")[0]
            with jax.default_device(cpu):
                beam = np.asarray(self.beam(feed_ind, freq_ind))
            if self.single_precision:
                beam = beam.astype(
                    np.complex64 if np.iscomplexobj(beam) else np.float32
                )
            limit = self.beam_cache_size << 20
            while (
                self._beam_cache_bytes + beam.nbytes > limit and self._beam_cache
            ):
                old = self._beam_cache.pop(next(iter(self._beam_cache)))
                self._beam_cache_bytes -= old.nbytes
            self._beam_cache[key] = beam
            self._beam_cache_bytes += beam.nbytes
        return self._beam_cache[key]

    # Device-resident unique-beam cache: (nside, freq, beamclass) ->
    # jnp array, so the unique beams cross the host link once per
    # window instead of once per unit chunk.  The budget is a fixed
    # sizing constant, not derived from the device's memory.
    _beam_dev_cache = None
    _beam_dev_bytes = 0
    _beam_dev_budget = 1 << 30  # ~1 GB of cached device beams

    def _beam_device(self, feed, fi):
        """The (host-cached) beam of ``feed`` at ``fi``, on device."""
        if self._beam_dev_cache is None:
            self._beam_dev_cache = {}
        key = (self._nside, int(fi), int(self.beamclass[feed]))
        beam = self._beam_dev_cache.get(key)
        if beam is not None:
            # LRU: refresh position on hit so the most-reused beams are
            # evicted last, not first.
            self._beam_dev_cache.pop(key)
            self._beam_dev_cache[key] = beam
        if beam is None:
            # Telescopes whose beam math is jax-traceable evaluate it
            # directly on the accelerator (only interpolation tables
            # cross the link); arbitrary subclass Python falls back to
            # host evaluation plus a map-sized transfer.  The _all hook
            # evaluates every beamclass of the frequency in ONE dispatch
            # and warms the cache for the sibling classes.
            dev_eval_all = getattr(self, "_beam_device_eval_all", None)
            got = dev_eval_all(feed, fi) if dev_eval_all is not None else None
            if got:
                for cls_id, bm in got.items():
                    self._beam_dev_insert(
                        (self._nside, int(fi), int(cls_id)), bm
                    )
                beam = self._beam_dev_cache.get(key)
            if beam is None:
                dev_eval = getattr(self, "_beam_device_eval", None)
                beam = dev_eval(feed, fi) if dev_eval is not None else None
                if beam is None:
                    # host fallback: pad the compact map into the device
                    # grid's (ring, slot) layout before upload
                    bh = np.asarray(self._beam(feed, fi))
                    bh = bh[self._ring_pad_index] * self._ring_pad_mask.reshape(
                        (-1,) + (1,) * (bh.ndim - 1)
                    ).astype(bh.real.dtype)
                    beam = jnp.asarray(bh)
                self._beam_dev_insert(key, beam)
        return beam

    def _beam_dev_insert(self, key, beam):
        if key in self._beam_dev_cache:
            return
        nbytes = int(beam.nbytes)
        while (
            self._beam_dev_bytes + nbytes > self._beam_dev_budget
            and self._beam_dev_cache
        ):
            oldest = next(iter(self._beam_dev_cache))
            self._beam_dev_bytes -= self._beam_dev_cache.pop(oldest).nbytes
        self._beam_dev_cache[key] = beam
        self._beam_dev_bytes += nbytes

    def _gather_beams(self, bl_ind, f_ind):
        """Per-unit beam maps and uv coordinates for a unit batch.

        Only the *unique* (freq, beamclass) maps are evaluated, and each
        crosses the host->device link once per (nside, freq, beamclass)
        (``_beam_device``); the per-unit stacking is a device-side
        gather, so repeat unit chunks cost no host transfers at all.
        """
        slot = {}
        unique = []
        idx_i, idx_j, uvs = [], [], []
        for bi, fi in zip(bl_ind, f_ind):
            feedi, feedj = self.uniquepairs[bi]
            for feed, idx in ((feedi, idx_i), (feedj, idx_j)):
                key = (int(fi), int(self.beamclass[feed]))
                if key not in slot:
                    slot[key] = len(unique)
                    unique.append(self._beam_device(feed, fi))
                idx.append(slot[key])
            uvs.append(self.baselines[bi] / self.wavelengths[fi])

        uv = np.array(uvs)
        if self.single_precision:
            uv = uv.astype(np.float32)

        stack = jnp.stack(unique)
        beam_i = jnp.take(stack, jnp.asarray(np.array(idx_i)), axis=0)
        beam_j = jnp.take(stack, jnp.asarray(np.array(idx_j)), axis=0)
        return beam_i, beam_j, uv

    # ================= draco-compatible maps ==================

    @cached_property
    def prodstack(self):
        """(input_a, input_b) structured array over unique pairs."""
        upairs = self.uniquepairs
        dtype = [("input_a", upairs.dtype), ("input_b", upairs.dtype)]
        return upairs.ravel().view(dtype)

    @cached_property
    def index_map_prod(self):
        """Full upper-triangle `index_map/prod` structured array."""
        tpairs = np.array(np.triu_indices(self.nfeed))
        dtype = [("input_a", tpairs.dtype), ("input_b", tpairs.dtype)]
        return tpairs.T.flatten().view(dtype)

    @cached_property
    def index_map_stack(self):
        """`index_map/stack` (prod index, conjugate) per unique pair."""

        def ind2tri(i, j, n):
            return (n * (n + 1) // 2) - ((n - i) * (n - i + 1) // 2) + (j - i)

        upairs = self.uniquepairs
        stack_map = np.empty(len(upairs), dtype=[("prod", "<u4"), ("conjugate", "u1")])
        stack_map["conjugate"] = upairs[:, 0] > upairs[:, 1]
        input_a, input_b = np.where(
            stack_map["conjugate"], upairs[:, ::-1].T, upairs.T
        )
        stack_map["prod"] = ind2tri(input_a, input_b, self.nfeed)
        return stack_map

    @cached_property
    def reverse_map_stack(self):
        """`reverse_map/stack` (stack index, conjugate) per product."""
        stack_revmap = np.empty(
            self.nfeed * (self.nfeed + 1) // 2,
            dtype=[("stack", "<i4"), ("conjugate", "u1")],
        )
        stack_revmap["stack"] = self.feedmap[np.triu_indices(self.nfeed)]
        stack_revmap["conjugate"] = self.feedconj[np.triu_indices(self.nfeed)]
        return stack_revmap

    # ===================== abstract layer =====================

    @property
    @abc.abstractmethod
    def feedpositions(self):
        """(nfeed, 2) feed positions in metres."""

    @property
    @abc.abstractmethod
    def beamclass(self):
        """(nfeed,) integer label; equal labels mean identical beams."""

    @property
    @abc.abstractmethod
    def u_width(self):
        """Physical width (u direction) for angular-scale determination."""

    @property
    @abc.abstractmethod
    def v_width(self):
        """Physical width (v direction) for angular-scale determination."""


class UnpolarisedTelescope(TransitTelescope, metaclass=abc.ABCMeta):
    """Telescope with a scalar (total-intensity) beam."""

    _npol_sky_ = 1

    @abc.abstractmethod
    def beam(self, feed, freq):
        """Scalar healpix beam map (npix,) at the current nside."""

    def _beam_map_batch(self, bl_ind, f_ind):
        """Stacked normalised visibility maps for a batch of units."""
        beam_i, beam_j, uv = self._gather_beams(bl_ind, f_ind)
        return kernels.unpol_visibility_map(
            beam_i,
            beam_j,
            uv,
            jnp.asarray(self.zenith),
            self._angpos_cart,
            self._horizon,
            pxarea=4.0 * np.pi / (12 * self._nside**2),
        )

    def _beam_map_batch_split(self, bl_ind, f_ind):
        """Split-complex variant of the batched visibility maps."""
        beam_i, beam_j, uv = self._gather_beams(bl_ind, f_ind)
        return kernels.unpol_visibility_map_split(
            beam_i,
            beam_j,
            uv,
            jnp.asarray(self.zenith),
            self._angpos_cart,
            self._horizon,
            pxarea=4.0 * np.pi / (12 * self._nside**2),
        )

    def noisepower(self, bl_indices, f_indices, ndays=None):
        """Noise power with the factor-1/2 unpolarised correction."""
        bnoise = TransitTelescope.noisepower(self, bl_indices, f_indices, ndays)
        return bnoise[..., np.newaxis] * 0.5


class PolarisedTelescope(TransitTelescope, metaclass=abc.ABCMeta):
    """Telescope with vector (theta_hat, phi_hat) feed beams -> full Stokes.

    Attributes ``skip_V`` / ``skip_pol`` mirror the reference
    (/root/reference/drift/core/telescope.py:1251-1252): the omitted
    transfer entries remain in the outputs but are zero.
    """

    skip_V = config.Property(proptype=bool, default=False)
    skip_pol = config.Property(proptype=bool, default=False)

    _npol_sky_ = 4

    @property
    def polarisation(self):
        raise NotImplementedError("`polarisation` must be implemented.")

    @abc.abstractmethod
    def beam(self, feed, freq):
        """(npix, 2) field pattern in (theta_hat, phi_hat) at current nside."""

    def _beam_map_batch(self, bl_ind, f_ind):
        beam_i, beam_j, uv = self._gather_beams(bl_ind, f_ind)
        stokes = kernels.stokes_visibility_map(
            beam_i,
            beam_j,
            uv,
            jnp.asarray(self.zenith),
            self._angpos_cart,
            self._horizon,
            pxarea=4.0 * np.pi / (12 * self._nside**2),
        )
        # Transform only the Stokes components we need; zero the rest.
        return stokes[:, : self._npol_transform]

    @property
    def _npol_transform(self):
        if self.skip_pol:
            return 1
        if self.skip_V:
            return 3
        return 4

    def _beam_map_batch_split(self, bl_ind, f_ind):
        """Split-complex variant of the batched Stokes visibility maps."""
        from ..ops import zarray as za

        beam_i, beam_j, uv = self._gather_beams(bl_ind, f_ind)
        stokes = kernels.stokes_visibility_map_split(
            beam_i,
            beam_j,
            uv,
            jnp.asarray(self.zenith),
            self._angpos_cart,
            self._horizon,
            pxarea=4.0 * np.pi / (12 * self._nside**2),
        )
        np_t = self._npol_transform
        return za.Z(stokes.re[:, :np_t], stokes.im[:, :np_t])

    @cached_property
    def included_pol(self) -> np.ndarray:
        if self.skip_pol:
            npol = 1
        elif self.skip_V:
            npol = 3
        else:
            npol = 4
        return np.arange(npol)


class SimpleUnpolarisedTelescope(UnpolarisedTelescope, metaclass=abc.ABCMeta):
    """Single-beamclass unpolarised telescope (implement `_single_feedpositions`)."""

    @property
    def beamclass(self):
        return np.zeros(self._single_feedpositions.shape[0], dtype=np.int64)

    @property
    @abc.abstractmethod
    def _single_feedpositions(self):
        """(nfeed, 2) positions of the (single polarisation) feeds."""

    @property
    def feedpositions(self):
        return self._single_feedpositions


class SimplePolarisedTelescope(PolarisedTelescope, metaclass=abc.ABCMeta):
    """Dual-polarisation telescope: X and Y feeds at the same positions."""

    @property
    def polarisation(self):
        return np.asarray(
            ["X" if feed % 2 == 0 else "Y" for feed in self.beamclass], dtype=str
        )

    @property
    def beamclass(self):
        nsfeed = self._single_feedpositions.shape[0]
        return np.concatenate((np.zeros(nsfeed), np.ones(nsfeed))).astype(np.int64)

    def beam(self, feed, freq):
        if self.beamclass[feed] % 2 == 0:
            return self.beamx(feed, freq)
        return self.beamy(feed, freq)

    @property
    @abc.abstractmethod
    def _single_feedpositions(self):
        """(nfeed, 2) positions of the single-polarisation feeds."""

    @property
    def feedpositions(self):
        return np.concatenate((self._single_feedpositions, self._single_feedpositions))

    @abc.abstractmethod
    def beamx(self, feed, freq):
        """(npix, 2) field pattern of the X feed."""

    @abc.abstractmethod
    def beamy(self, feed, freq):
        """(npix, 2) field pattern of the Y feed."""
