"""Karhunen-Loeve signal/foreground filtering.

Functional parity with /root/reference/drift/core/kltransform.py: build
signal and noise covariances in the SVD basis, solve the generalised
eigenproblem per m, threshold-subset the modes, cache per-m HDF5
eigenfiles and collect the spectra.  The covariance projections and the
whitened eigensolve run on device (ops.linalg); the per-m orchestration,
files and thresholds stay host-side.
"""

from __future__ import annotations

import logging
import os
import time

import h5py
import numpy as np

from .. import config
from ..ops import linalg, projections
from ..parallel import comm
from ..util import util
from . import skymodel

logger = logging.getLogger(__name__)


def collect_m_arrays(mlist, func, shapes, dtype):
    """Evaluate func(mi) (a list of arrays) for each m and collect them.

    Returns the stacked arrays on every process (rank0-only in the
    reference; returning everywhere is strictly more useful).  Each
    process fills its own m-slices of zero arrays; a single allreduce
    assembles the totals — uniform-shaped collectives on every process.
    """
    marrays = [np.zeros((len(mlist),) + shape, dtype=dtype) for shape in shapes]

    for mi in comm.partition_list_mpi(mlist):
        result = func(mi)
        for si in range(len(shapes)):
            if result[si] is not None:
                marrays[si][mi] = result[si]

    comm.barrier()
    if comm.size() > 1:  # pragma: no cover - requires multi-host run
        marrays = [comm.allreduce(m) for m in marrays]
    comm.barrier()
    return marrays


def collect_m_array(mlist, func, shape, dtype):
    res = collect_m_arrays(mlist, lambda mi: [func(mi)], [shape], dtype)
    return res[0]


# Re-exported for parity with the reference module layout (dispatching).
eigh_gen = projections.generalised_eigh
inv_gen = linalg.inv_gen


class KLTransform(config.Reader):
    """Perform the KL transform.

    Attributes mirror /root/reference/drift/core/kltransform.py:146-177:
    `subset`/`threshold` control S/N mode cuts, `inverse` caches the
    inverse transform, `use_thermal`/`use_foregrounds` select the noise
    content, and `_foreground_regulariser` sets the diagonal regulariser.
    """

    subset = config.Property(proptype=bool, default=True, key="subset")
    inverse = config.Property(proptype=bool, default=False, key="inverse")

    threshold = config.Property(proptype=float, default=0.1, key="threshold")

    # Eigensolver for the batched path: "exact" (full whitened-Gram
    # eigendecomposition) or "topband" (fpencil.gram_topband — matmuls
    # only, computes exactly the retained band).  With "topband" the
    # sub-threshold tail of the diagnostic `evals_full` dataset is
    # written as exact zeros (the retained `evals`/`evecs` datasets are
    # unchanged); it requires ``subset`` and falls back to "exact"
    # whenever a chunk's completeness certificate fails.
    engine = config.Property(proptype=str, default="exact", key="engine")

    _foreground_regulariser = config.Property(
        proptype=float, default=1e-14, key="regulariser"
    )

    use_thermal = config.Property(proptype=bool, default=True)
    use_foregrounds = config.Property(proptype=bool, default=True)
    use_polarised = config.Property(proptype=bool, default=True)

    pol_length = config.Property(proptype=config.float_or_none, default=None)

    evdir = ""

    _cvfg = None
    _cvsg = None

    @property
    def _evfile(self):
        return self.evdir + "/ev_m_" + util.natpattern(self.telescope.mmax) + ".hdf5"

    def __init__(self, bt, subdir=None):
        self.beamtransfer = bt
        self.telescope = self.beamtransfer.telescope

        subdir = "ev" if subdir is None else subdir
        self.evdir = self.beamtransfer.directory + "/" + subdir
        if comm.rank0() and not os.path.exists(self.evdir):
            os.makedirs(self.evdir)
        comm.barrier()

    # ================= covariances =================

    def foreground(self):
        """Foreground sky covariance [pol, pol, l, freq, freq]."""
        if self._cvfg is None:
            npol = self.telescope.num_pol_sky
            if npol not in (1, 3, 4):
                raise Exception(
                    "Can only handle unpolarised (num_pol_sky = 1) or "
                    "polarised (num_pol_sky = 3 or 4) cases."
                )
            if self.use_polarised:
                self._cvfg = skymodel.foreground_model(
                    self.telescope.lmax,
                    self.telescope.frequencies,
                    npol,
                    pol_length=self.pol_length,
                )
            else:
                self._cvfg = skymodel.foreground_model(
                    self.telescope.lmax, self.telescope.frequencies, npol, pol_frac=0.0
                )
        return self._cvfg

    def signal(self):
        """21 cm signal sky covariance [pol, pol, l, freq, freq]."""
        if self._cvsg is None:
            npol = self.telescope.num_pol_sky
            if npol not in (1, 3, 4):
                raise Exception(
                    "Can only handle unpolarised (num_pol_sky = 1) or "
                    "polarised (num_pol_sky = 3 or 4) cases."
                )
            self._cvsg = skymodel.im21cm_model(
                self.telescope.lmax, self.telescope.frequencies, npol
            )
        return self._cvsg

    def sn_covariance(self, mi, thermal=None):
        """Signal and noise covariances in the SVD basis at m.

        Noise = foregrounds + regulariser + (possibly suppressed) thermal.
        Parity with /root/reference/drift/core/kltransform.py:258-308.
        ``thermal`` overrides ``self.use_thermal`` for this call (used by
        the two-stage DoubleKL without mutating state).
        """
        use_thermal = self.use_thermal if thermal is None else thermal
        if not (self.use_foregrounds or use_thermal):
            raise Exception(
                "Either `use_thermal` or `use_foregrounds`, or both must be True."
            )

        bt = self.beamtransfer

        cvb_s = np.array(bt.project_matrix_sky_to_svd(mi, self.signal()))
        if self.use_foregrounds:
            cvb_n = np.array(bt.project_matrix_sky_to_svd(mi, self.foreground()))
        else:
            cvb_n = np.zeros_like(cvb_s)

        # Regularise the noise matrix.
        if cvb_n.size:
            cnr = cvb_n.reshape((bt.ndof(mi), -1))
            cnr[np.diag_indices_from(cnr)] += (
                self._foreground_regulariser * cnr.max()
            )

        cvb_n = cvb_n + bt.project_matrix_diagonal_telescope_to_svd(
            mi, self._noise_power(thermal=use_thermal)
        )

        return cvb_s, cvb_n

    # ================= the transform =================

    def _transform_m(self, mi):
        """KL transform for one m: returns (evals, evecs rows, inv, extra)."""
        logger.info("Solving for Eigenvalues....")

        st = time.time()
        nside = self.beamtransfer.ndof(mi)
        if nside == 0:
            return np.array([]), np.array([[]]), np.array([[]]), {"ac": 0.0}

        cvb_sr, cvb_nr = [cv.reshape(nside, nside) for cv in self.sn_covariance(mi)]
        logger.info("Covariance build time = %f", time.time() - st)

        st = time.time()
        evals, evecs, ac = projections.generalised_eigh(cvb_sr, cvb_nr, message=f"m = {mi}")
        logger.info("Eigensolve time = %f", time.time() - st)

        evecs = evecs.T.conj()

        inv = None
        if self.inverse:
            inv = linalg.inv_gen(evecs).T

        return evals, evecs, inv, {"ac": ac}

    def transform_save(self, mi):
        """Perform the transform for m and save the eigenfile."""
        logger.info("Constructing signal and noise covariances for m = %i ...", mi)
        evals, evecs, inv, evextra = self._transform_m(mi)

        logger.info("Creating file %s ....", self._evfile % mi)
        with h5py.File(self._evfile % mi, "w") as f:
            f.attrs["m"] = mi
            f.attrs["SUBSET"] = self.subset

            # Zero-padded full spectrum (DoubleKL may have truncated).
            nside = self.beamtransfer.ndof(mi)
            evalsf = np.zeros(nside, dtype=np.float64)
            if evals.size != 0:
                evalsf[-evals.size :] = evals
            f.create_dataset("evals_full", data=evalsf)

            if self.subset:
                i_ev = np.searchsorted(evals, self.threshold)
                evals = evals[i_ev:]
                evecs = evecs[i_ev:]
                logger.info(
                    "Modes with S/N > %f: %i of %i",
                    self.threshold,
                    evals.size,
                    evalsf.size,
                )

            f.create_dataset("evals", data=evals)
            f.create_dataset("evecs", data=evecs)
            f.attrs["num_modes"] = evals.size

            if self.inverse:
                if self.subset:
                    inv = inv[i_ev:]
                f.create_dataset("evinv", data=inv)

            self._ev_save_hook(f, evextra)

        return evals, evecs

    def _ev_save_hook(self, f, evextra):
        ac = evextra["ac"]
        if ac != 0.0:
            f.attrs["add_const"] = ac
            f.attrs["FLAGS"] = "NotPositiveDefinite"
        else:
            f.attrs["FLAGS"] = "Normal"

    # ================= collection =================

    def evals_all(self):
        """Full eigenvalue spectrum for all m from disk."""
        with h5py.File(self.evdir + "/evals.hdf5", "r") as f:
            return f["evals"][:]

    def _collect(self):
        def evfunc(mi):
            evf = np.zeros(self.beamtransfer.ndofmax)
            with h5py.File(self._evfile % mi, "r") as f:
                if f["evals_full"].shape[0] > 0:
                    ev = f["evals_full"][:]
                    evf[-ev.size :] = ev
            return evf

        if comm.rank0():
            logger.info("Creating eigenvalues file (process 0 only).")

        mlist = list(range(self.telescope.mmax + 1))
        evarray = collect_m_array(mlist, evfunc, (self.beamtransfer.ndofmax,), np.float64)

        if comm.rank0():
            if os.path.exists(self.evdir + "/evals.hdf5"):
                logger.info("File %s exists. Skipping...", self.evdir + "/evals.hdf5")
                return
            with h5py.File(self.evdir + "/evals.hdf5", "w") as f:
                f.create_dataset("evals", data=evarray)

    # m-modes KL-transformed per compiled batch (1 disables batching).
    mbatch = config.Property(proptype=int, default=8)

    def generate(self, regen=False):
        """KL transform every m and save the results."""
        st = time.time()
        if comm.rank0():
            logger.info("======== Starting KL calculation ========")

        mlist = [
            mi
            for mi in comm.mpirange(self.telescope.mmax + 1)
            if regen or not os.path.exists(self._evfile % mi)
        ]

        # Batched path: one compiled covariance-projection + whitened-eigh
        # program serves every m-chunk.  It is only taken when the
        # effective ``_transform_m`` is defined at or above (in MRO) the
        # class supplying the batched writer — a subclass that overrides
        # only ``_transform_m`` (even below DoubleKL, which ships its own
        # writer) falls back to the per-m path so its customisation is
        # never silently ignored.
        mro = type(self).__mro__
        writer_cls = next(c for c in mro if "_transform_save_mbatch" in c.__dict__)
        tm_cls = next(c for c in mro if "_transform_m" in c.__dict__)
        batched_honours_tm = mro.index(tm_cls) >= mro.index(writer_cls)
        use_batched = (
            self.mbatch > 1
            and not self.inverse
            and getattr(self.beamtransfer, "kl_mbatch_ok", True)
            and batched_honours_tm
        )

        if use_batched and mlist:
            # Double-buffered (base writer only — subclasses with their
            # own batched writer keep the chunk-at-a-time call): chunk
            # i+1's solve is dispatched before chunk i's results are
            # fetched, so the eigenvector fetch overlaps the next solve.
            pipelined = (
                writer_cls._transform_save_mbatch
                is KLTransform._transform_save_mbatch
            )
            pending = None
            for s in range(0, len(mlist), self.mbatch):
                chunk = mlist[s : s + self.mbatch]
                if not pipelined:
                    self._transform_save_mbatch(chunk)
                    continue
                dispatched = self._kl_dispatch_mbatch(chunk)
                if pending is not None:
                    self._kl_finish_mbatch(pending)
                pending = dispatched
            if pending is not None:
                self._kl_finish_mbatch(pending)
        else:
            for mi in mlist:
                self.transform_save(mi)

        comm.barrier()
        if comm.rank0():
            logger.info(
                "======== Ending KL calculation (time=%f) ========", time.time() - st
            )

        self._collect()

    def _noise_power(self, thermal=None):
        """Diagonal instrumental noise power [nfreq, ntel].

        With thermal noise disabled a tiny floor remains (Tsys -> 1 mK),
        matching the reference's convention.
        """
        use_thermal = self.use_thermal if thermal is None else thermal
        bt = self.beamtransfer
        nc = 1.0 if use_thermal else (1e-3 / self.telescope.tsys_flat) ** 2
        bl = np.arange(self.telescope.npairs)
        bl = np.concatenate((bl, bl))
        return nc * self.telescope.noisepower(
            bl[np.newaxis, :], np.arange(self.telescope.nfreq)[:, np.newaxis]
        ).reshape(self.telescope.nfreq, bt.ntel)

    _cl_factor_cache = None

    def _cl_factors(self):
        """Per-l Cholesky factor tables of the sky covariances (cached).

        With foregrounds disabled the foreground factor is identically
        zero — the pencil then reduces to S v = w nc I v.
        """
        if self._cl_factor_cache is None:
            from ..ops import fpencil

            ls = fpencil.factor_cl(self.signal(), out_dtype=np.float64)
            if self.use_foregrounds:
                lf = fpencil.factor_cl(self.foreground(), out_dtype=np.float64)
            else:
                lf = np.zeros_like(ls)
            self._cl_factor_cache = (ls, lf)
        return self._cl_factor_cache

    def _load_bsvd_batch(self, m_chunk, mbatch):
        """Padded, svcut-masked SVD-beam batch for a chunk of m-modes.

        Returns (bsvd (mbatch, F, S, npol, nl) complex, per-m compact
        index lists); the chunk is right-padded by repeating its last m.
        """
        bt = self.beamtransfer
        tel = self.telescope
        nfreq, npol, nl = tel.nfreq, tel.num_pol_sky, tel.lmax + 1
        S = bt.svd_len

        ms = list(m_chunk) + [m_chunk[-1]] * (mbatch - len(m_chunk))
        bsvd = np.zeros((mbatch, nfreq, S, npol, nl), dtype=np.complex128)
        idx_list = []
        for i, mi in enumerate(ms):
            svnum, _ = bt._svd_num(mi)
            mask = np.zeros((nfreq, S))
            for fi in range(nfreq):
                mask[fi, : svnum[fi]] = 1.0
            bsvd[i] = bt.beam_svd(mi) * mask[:, :, None, None]
            idx_list.append(bt._compact_indices(mi)[0])
        return bsvd, idx_list

    def _transform_save_mbatch(self, m_chunk):
        """KL-transform a chunk of m-modes in one device batch.

        Dispatch + finish in one step; :meth:`generate` calls the halves
        separately to double-buffer chunks (the eigenvector fetch of
        chunk i then overlaps chunk i+1's device solve).
        """
        self._kl_finish_mbatch(self._kl_dispatch_mbatch(m_chunk))

    def _kl_dispatch_mbatch(self, m_chunk):
        """Dispatch one m-chunk's KL pencil solve to the device.

        Builds padded (svcut-masked) beam batches — from the SVD stage's
        device-resident handoff when available (no upload), else from
        the SVD files — and dispatches the *factored* KL pencil solve
        for the whole chunk (ops.projections.kl_factored_batched),
        sharded over the device mesh along m when more than one device
        is available.  Returns the state for :meth:`_kl_finish_mbatch`.

        The stored beams are noise-prewhitened, so the projected
        instrumental noise is exactly ``nc I`` on the retained modes (nc
        the thermal scaling of :meth:`_noise_power`); the identity also
        regularises the svcut-padded directions, whose signal rows are
        zero and therefore emerge with eval == 0 and unit padded support.
        """
        from ..parallel import mesh as meshmod

        bt = self.beamtransfer
        tel = self.telescope
        nfreq = tel.nfreq
        S = bt.svd_len

        mbatch = self.mbatch
        ms = list(m_chunk) + [m_chunk[-1]] * (mbatch - len(m_chunk))

        # Device-resident input: when the SVD stage ran in this process
        # (resident generate), the sky->SVD beams are still on device —
        # assemble the pencil input there and apply the svcut mask on
        # device, skipping the host->device upload of the whole batch.
        # Values are identical to the host path (same arrays the files
        # were written from).
        dev = None
        if getattr(bt, "device_beam_svd", None) is not None:
            dev = bt.device_beam_svd(ms)
        if dev is not None:
            dev_mask = np.zeros((mbatch, nfreq, S))
            idx_list = []
            for i, mi in enumerate(ms):
                svnum, _ = bt._svd_num(mi)
                for fi in range(nfreq):
                    dev_mask[i, fi, : svnum[fi]] = 1.0
                idx_list.append(bt._compact_indices(mi)[0])
            bsvd = None
        else:
            dev_mask = None
            bsvd, idx_list = self._load_bsvd_batch(m_chunk, mbatch)
        ls, lf = self._cl_factors()
        nc = 1.0 if self.use_thermal else (1e-3 / tel.tsys_flat) ** 2

        solve_kw = dict(
            nc=nc,
            fg_reg_rel=self._foreground_regulariser,
            mesh=meshmod.get_mesh(),
            bsvd_dev=dev,
            dev_mask=dev_mask,
            lazy=True,
        )

        # Retained-band engine: compute only the eigenpairs the subset
        # cut keeps (fpencil.gram_topband — matmuls instead of the QDWH
        # eigh).  Any m whose completeness certificate fails drops the
        # whole chunk back to the exact engine.  The sub-threshold tail
        # of `evals_full` is then exact zeros (see the `engine` config
        # property).
        use_topband = self.engine == "topband" and self.subset
        if use_topband:
            solve = projections.kl_factored_batched_topband(
                bsvd, ls, lf, cut=self.threshold, **solve_kw
            )
        else:
            solve = projections.kl_factored_batched(
                bsvd, ls, lf, with_thermal=True, **solve_kw
            )
        return m_chunk, idx_list, solve, (bsvd, ls, lf, solve_kw)

    def _kl_finish_mbatch(self, state):
        """Fetch a dispatched chunk's results and write its eigenfiles.

        With threshold subsetting only the retained tail columns of the
        eigenbasis ever reach the files, so this fetches the spectrum,
        the device-reduced support statistics and just those columns —
        the (M, n, n) eigenvector block stays on device.  Without
        subsetting (or if the retained set is not the ascending tail)
        it falls back to the full fetch.
        """
        m_chunk, idx_list, solve, (bsvd, ls, lf, solve_kw) = state

        topband_ok = False
        ok_b = solve.ok()
        if ok_b is not None:
            topband_ok = bool(ok_b.all())
            if not topband_ok:
                logger.info(
                    "m chunk %s: top-band certificate failed; re-solving "
                    "with the exact engine.", list(m_chunk),
                )
                solve = projections.kl_factored_batched(
                    bsvd, ls, lf, with_thermal=True, **solve_kw
                )

        evals_b = solve.evals()
        n = evals_b.shape[1]

        # Genuine modes are supported on the compact directions; padding
        # modes are unit vectors on padded axes.  Compare each column's
        # compact support to its *total* norm (both reduced on device):
        # the columns are N-orthonormal, so absolute support scales as
        # 1/lambda_N and an absolute test misclassifies every genuine
        # mode once foregrounds lift the noise floor — the support
        # *fraction* is normalisation-free.
        row_mask = np.zeros((len(idx_list), n))
        for i, idx in enumerate(idx_list):
            row_mask[i, idx] = 1.0
        support_b, total_b = solve.support_stats(row_mask)
        total_b = total_b + 1e-300

        M = len(m_chunk)
        # Retained columns are the ascending tail: with a positive
        # subset threshold, every written column has eval >= threshold
        # and eigensolvers return ascending spectra.  Fetch only that
        # tail (padded to a multiple of 8 columns to bound the number
        # of slice shapes); anything violating the tail assumption
        # falls back to the full fetch.
        tail = None
        v_full = None
        if self.subset and self.threshold > 0:
            counts = (evals_b[:M] >= self.threshold).sum(axis=1)
            kmax = min(n, int(-(-max(int(counts.max()), 1) // 8) * 8))
            ascending = bool(
                (np.diff(evals_b[:M], axis=1) >= 0).all()
            )
            if ascending:
                tail = solve.evecs_tail(kmax)
            else:  # pragma: no cover - defensive
                v_full = solve.evecs_full()
        else:
            v_full = solve.evecs_full()

        offset = n - (tail.shape[2] if tail is not None else n)

        def cols(i, sel):
            """Columns ``sel`` of m-slot i, (nrows, len(sel))."""
            if v_full is not None:
                return v_full[i][:, sel]
            return tail[i][:, np.asarray(sel) - offset]

        for i, mi in enumerate(m_chunk):
            idx = idx_list[i]
            ndof = len(idx)
            w = evals_b[i]

            if topband_ok:
                # above-threshold columns are genuine by construction
                # (padded/svcut directions emerge at exactly 0); no
                # support test needed, and the sub-threshold spectrum is
                # reported as zeros in evals_full.
                sel = np.nonzero(w > self.threshold)[0]
                self._write_ev_file(
                    mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj()
                )
                continue

            keep = support_b[i] > 0.5 * total_b[i]
            if keep.sum() != ndof:
                # The pencil's zero eigenvalue is degenerate between the
                # svcut-padded unit directions and any genuine
                # zero-signal modes, so eigh may return an arbitrary
                # mixed basis for that cluster and the global support
                # count miscounts (observed at mid scale, where
                # split-complex f32 widens the cluster).  With a
                # positive subset cut only above-threshold modes are
                # ever written: classify those alone, and report the
                # full spectrum from the top-ndof eigenvalues (the
                # dropped n-ndof values are the ~0 duplicates of the
                # padding directions).
                strict = w > self.threshold
                if (
                    self.subset
                    and self.threshold > 0
                    and int(strict.sum()) <= ndof
                    and bool(keep[strict].all())
                ):
                    evals_full = np.sort(np.asarray(w))[-ndof:]
                    sel = np.nonzero(strict)[0]
                    self._write_ev_file(
                        mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj(),
                        evals_full=evals_full,
                    )
                    continue
                # A genuinely mixed above-threshold column (or a full
                # eigenbasis request): fall back to the per-m path.
                logger.warning(
                    "m index %i: padded-mode separation ambiguous "
                    "(%i of %i); falling back to per-m transform.",
                    mi,
                    int(keep.sum()),
                    ndof,
                )
                self.transform_save(mi)
                continue

            if tail is not None:
                # Only the >= threshold part of the genuine set reaches
                # the file (the sub-threshold genuine evals enter just
                # the evals_full diagnostic, passed separately); all
                # such columns live in the fetched tail.
                sel = np.nonzero(keep & (w >= self.threshold))[0]
                self._write_ev_file(
                    mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj(),
                    evals_full=w[keep],
                )
            else:
                sel = np.nonzero(keep)[0]
                self._write_ev_file(
                    mi, ndof, w[sel], cols(i, sel)[idx, :].T.conj()
                )

    def _write_ev_file(self, mi, ndof, evals, evecs, evals_full=None):
        """Write one m's eigenfile (evals ascending-sorted here).

        `evals_full`, if given, supplies the full-spectrum diagnostic
        dataset separately from the (possibly already subset) evals —
        used by the batched path when only above-threshold columns are
        unambiguously classified.
        """
        order = np.argsort(evals)
        evals = evals[order]
        evecs = evecs[order]

        logger.info("Writing KL file for m = %i: %s", mi, self._evfile % mi)
        with h5py.File(self._evfile % mi, "w") as f:
            f.attrs["m"] = mi
            f.attrs["SUBSET"] = self.subset

            evalsf = np.zeros(ndof, dtype=np.float64)
            if evals_full is not None:
                src = np.sort(np.asarray(evals_full, dtype=np.float64))
                evalsf[-src.size :] = src
            elif evals.size != 0:
                evalsf[-evals.size :] = evals
            f.create_dataset("evals_full", data=evalsf)

            if self.subset:
                i_ev = np.searchsorted(evals, self.threshold)
                evals = evals[i_ev:]
                evecs = evecs[i_ev:]

            f.create_dataset("evals", data=evals)
            f.create_dataset("evecs", data=np.ascontiguousarray(evecs))
            f.attrs["num_modes"] = evals.size
            self._ev_save_hook(f, {"ac": 0.0})

    olddatafile = False

    # ================= mode access =================

    @util.cache_last
    def modes_m(self, mi, threshold=None):
        """(evals, evecs) for m with S/N above `threshold` (None, None if empty)."""
        if not os.path.exists(self._evfile % mi):
            modes = self.transform_save(mi)
        else:
            with h5py.File(self._evfile % mi, "r") as f:
                if f["evals"].shape[0] == 0:
                    modes = None, None
                else:
                    evals = f["evals"][:]
                    startind = (
                        np.searchsorted(evals, threshold)
                        if threshold is not None
                        else 0
                    )
                    if startind == evals.size:
                        modes = None, None
                    else:
                        modes = (evals[startind:], f["evecs"][startind:])
                        if self.olddatafile:
                            modes = (modes[0], modes[1].conj())
        return modes

    @util.cache_last
    def evals_m(self, mi, threshold=None):
        """Eigenvalues for m above `threshold` (None if empty)."""
        if not os.path.exists(self._evfile % mi):
            modes = self.transform_save(mi)
            return modes[0] if modes[0] is not None and modes[0].size else None

        with h5py.File(self._evfile % mi, "r") as f:
            if f["evals"].shape[0] == 0:
                return None
            evals = f["evals"][:]
            startind = (
                np.searchsorted(evals, threshold) if threshold is not None else 0
            )
            if startind == evals.size:
                return None
            return evals[startind:]

    @util.cache_last
    def invmodes_m(self, mi, threshold=None):
        """Inverse modes (cached inverse or pseudo-inverse of evecs)."""
        evals = self.evals_m(mi, threshold)

        with h5py.File(self._evfile % mi, "r") as f:
            if "evinv" in f:
                inv = f["evinv"][:]
                if threshold is not None:
                    nevals = evals.size
                    inv = inv[(-nevals):]
                return inv.T
            logger.info("Inverse not cached, generating pseudo-inverse.")
            return np.linalg.pinv(self.modes_m(mi, threshold)[1])

    @util.cache_last
    def skymodes_m(self, mi, threshold=None):
        """KL modes rotated into the sky (alm) basis."""
        evals, evecs = self.modes_m(mi, threshold=threshold)
        if evals is None:
            raise Exception("Don't seem to be any evals to use.")

        bt = self.beamtransfer
        beam = bt.beam_m(mi).reshape((bt.nfreq, bt.ntel, bt.nsky))
        evecs = evecs.reshape((-1, bt.nfreq, bt.ntel))

        evsky = np.zeros((evecs.shape[0], bt.nfreq, bt.nsky), dtype=np.complex128)
        for fi in range(bt.nfreq):
            evsky[:, fi, :] = np.dot(evecs[:, fi, :], beam[fi])
        return evsky

    # ================= projections =================

    def project_vector_svd_to_kl(self, mi, vec, threshold=None):
        """SVD vector -> KL basis."""
        evals, evecs = self.modes_m(mi, threshold)
        if evals is None:
            return np.zeros((0,), dtype=np.complex128)
        if vec.shape[0] != evecs.shape[1]:
            raise Exception("Vectors are incompatible.")
        return np.dot(evecs, vec)

    def project_vector_kl_to_svd(self, mi, vec, threshold=None):
        """KL vector -> SVD basis (via the cached/pseudo- inverse)."""
        evals, evecs = self.modes_m(mi, threshold)
        if evals is None:
            return np.zeros(self.beamtransfer.ndofmax, dtype=np.complex128)
        if vec.shape[0] != evecs.shape[0]:
            raise Exception("Vectors are incompatible.")
        invmodes = self.invmodes_m(mi, threshold)
        return np.dot(invmodes, vec)

    def project_vector_sky_to_kl(self, mi, vec, threshold=None):
        """Sky alm -> KL basis."""
        tvec = self.beamtransfer.project_vector_sky_to_svd(mi, vec)
        return self.project_vector_svd_to_kl(mi, tvec, threshold)

    def project_matrix_svd_to_kl(self, mi, mat, threshold=None):
        """SVD covariance -> KL basis."""
        evals, evecs = self.modes_m(mi, threshold)
        if (mat.shape[0] != evecs.shape[1]) or (mat.shape[0] != mat.shape[1]):
            raise Exception("Matrix size incompatible.")
        return np.dot(np.dot(evecs, mat), evecs.T.conj())

    def project_matrix_sky_to_kl(self, mi, mat, threshold=None):
        """Sky covariance -> KL basis."""
        mproj = self.beamtransfer.project_matrix_sky_to_svd(mi, mat)
        return self.project_matrix_svd_to_kl(mi, mproj, threshold)

    def project_sky(self, sky, mlist=None, threshold=None, harmonic=False):
        """Project a sky map (or alm) through the KL filter for a set of m."""
        from ..ops import sht

        if mlist is None:
            mlist = list(range(self.telescope.mmax + 1))
        mpart = comm.partition_list_mpi(mlist)

        nmodes = self.beamtransfer.nfreq * self.beamtransfer.ntel

        alm = (
            sky
            if harmonic
            else sht.sphtrans_sky(sky, lmax=self.telescope.lmax)
        )

        def _proj(mi):
            p1 = self.project_vector_sky_to_kl(mi, alm[..., mi], threshold)
            p2 = np.zeros(nmodes, dtype=np.complex128)
            p2[-p1.size :] = p1
            return p2

        proj_sec = [(mi, _proj(mi)) for mi in mpart]

        proj_arr = np.zeros(
            (2 * self.telescope.mmax + 1, nmodes), dtype=np.complex128
        )
        for mi, p in proj_sec:
            proj_arr[mi] = p
        return proj_arr
