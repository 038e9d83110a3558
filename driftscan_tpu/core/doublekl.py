"""Two-stage KL: foreground rejection, then signal/noise diagonalisation.

Behavioural parity with the reference DoubleKL
(/root/reference/drift/core/doublekl.py): stage 1 solves the
signal/foreground pencil with thermal noise suppressed and keeps modes
whose S/F exceeds ``foreground_threshold``; stage 2 re-solves the full
signal/noise pencil restricted to that cleaned subspace.  The eigenfiles
additionally record the stage-1 spectrum (``f_evals``).
"""

from __future__ import annotations

import logging
import os

import h5py
import numpy as np

from .. import config
from ..ops import linalg
from ..parallel import comm
from . import kltransform

logger = logging.getLogger(__name__)


class DoubleKL(kltransform.KLTransform):
    """KL with an initial S/F (foreground) filtering step.

    Attributes
    ----------
    foreground_threshold : scalar
        S/F power ratio below which modes are discarded as
        foreground-contaminated (stage 1 cut).
    """

    foreground_threshold = config.Property(proptype=float, default=100.0)

    def _pencil(self, mi, thermal):
        """Solve the (signal, noise) pencil at m; returns evals ascending,
        mode rows, and the regularisation constant."""
        n = self.beamtransfer.ndof(mi)
        cs, cn = (c.reshape(n, n) for c in self.sn_covariance(mi, thermal=thermal))
        stage = "step 2" if thermal else "step 1"
        evals, evecs, ac = kltransform.eigh_gen(
            cs, cn, message=f"m = {mi}; KL {stage}"
        )
        return evals, evecs.T.conj(), ac

    def _transform_m(self, mi):
        if self.beamtransfer.ndof(mi) == 0:
            return (
                np.array([]),
                np.array([[]]),
                np.array([[]]),
                {"ac": 0.0, "f_evals": np.array([])},
            )

        # Stage 1: S/F pencil, thermal off; cut at the foreground threshold.
        f_evals, modes, ac = self._pencil(mi, thermal=False)
        keep = f_evals > self.foreground_threshold

        inv = linalg.inv_gen(modes).T if self.inverse else None

        evals = f_evals[keep]
        modes = modes[keep]
        if self.inverse:
            inv = inv[keep]

        extra = {"ac": ac, "f_evals": f_evals.copy()}
        if evals.size == 0:
            return evals, modes, inv, extra

        # Stage 2: full S/N pencil restricted to the cleaned subspace.
        n = self.beamtransfer.ndof(mi)
        cs, cn = (
            c.reshape(n, n) for c in self.sn_covariance(mi, thermal=True)
        )
        cs_r = modes @ cs @ modes.T.conj()
        cn_r = modes @ cn @ modes.T.conj()
        evals, evecs2, _ = kltransform.eigh_gen(
            cs_r, cn_r, message=f"m = {mi}; KL step 2"
        )

        modes = evecs2.T.conj() @ modes
        if self.inverse:
            inv = linalg.inv_gen(evecs2) @ inv

        return evals, modes, inv, extra

    def _ev_save_hook(self, f, evextra):
        super()._ev_save_hook(f, evextra)
        f.create_dataset("f_evals", data=evextra["f_evals"])

    def _transform_save_mbatch(self, m_chunk):
        """Two-stage KL for a chunk of m-modes in one device batch.

        Uses the fully-factored two-stage pencil
        (ops.projections.doublekl_factored_batched) — both stages run
        from covariance *factors* by QR whitening, so the device path keeps
        the same accuracy story as the single-stage transform.  svcut
        padding never survives stage 1 (zero signal and foreground rows
        give S/F = 0 against the suppressed-thermal floor), so the
        stage-1 spectrum compacts by simply taking the top ndof values.
        """
        from ..ops import projections
        from ..parallel import mesh as meshmod

        tel = self.telescope
        bsvd, idx_list = self._load_bsvd_batch(m_chunk, self.mbatch)
        ls, lf = self._cl_factors()

        nc1 = (1e-3 / tel.tsys_flat) ** 2  # suppressed-thermal floor

        # Retained-band engine (see KLTransform.engine): both stages
        # compute only the modes they keep; certificate failures drop
        # the chunk to the exact two-stage engine.  The sub-threshold
        # tails of `evals_full`/`f_evals` are then exact zeros.
        use_topband = self.engine == "topband" and self.subset
        topband_ok = False
        if use_topband:
            f_ev_b, ev_b, evecs_b, nkept_b, ok_b = (
                projections.doublekl_factored_batched_topband(
                    bsvd,
                    ls,
                    lf,
                    cut=self.threshold,
                    nc=1.0,
                    nc1=nc1,
                    fg_threshold=self.foreground_threshold,
                    fg_reg_rel=self._foreground_regulariser,
                    mesh=meshmod.get_mesh(),
                )
            )
            topband_ok = bool(np.asarray(ok_b).all())
            if not topband_ok:
                logger.info(
                    "m chunk %s: top-band certificate failed; re-solving "
                    "with the exact engine.", list(m_chunk),
                )
        if not topband_ok:
            f_ev_b, ev_b, evecs_b, nkept_b = projections.doublekl_factored_batched(
                bsvd,
                ls,
                lf,
                nc=1.0,
                nc1=nc1,
                fg_threshold=self.foreground_threshold,
                fg_reg_rel=self._foreground_regulariser,
                mesh=meshmod.get_mesh(),
            )

        for i, mi in enumerate(m_chunk):
            idx = idx_list[i]
            ndof = len(idx)
            nkept = int(nkept_b[i])

            f_evals = f_ev_b[i][-ndof:]  # ascending, padding zeros shed
            if nkept:
                evals = ev_b[i][-nkept:]
                # rows = modes, compact coordinates
                evecs = evecs_b[i][idx, -nkept:].T.conj()
            else:
                evals = np.array([])
                evecs = np.array([[]])

            logger.info(
                "Writing DoubleKL file for m = %i (%i kept): %s",
                mi,
                nkept,
                self._evfile % mi,
            )
            with h5py.File(self._evfile % mi, "w") as f:
                f.attrs["m"] = mi
                f.attrs["SUBSET"] = self.subset

                evalsf = np.zeros(ndof, dtype=np.float64)
                if evals.size:
                    evalsf[-evals.size :] = evals
                f.create_dataset("evals_full", data=evalsf)

                if self.subset and evals.size:
                    i_ev = np.searchsorted(evals, self.threshold)
                    evals = evals[i_ev:]
                    evecs = evecs[i_ev:]

                f.create_dataset("evals", data=evals)
                f.create_dataset("evecs", data=np.ascontiguousarray(evecs))
                f.attrs["num_modes"] = evals.size
                self._ev_save_hook(f, {"ac": 0.0, "f_evals": f_evals})

    def _collect(self):
        """Collect both spectra (S/N and stage-1 S/F) into evals.hdf5."""
        ndofmax = self.beamtransfer.ndofmax

        def spectra(mi):
            out = np.zeros((2, ndofmax), dtype=np.float64)
            with h5py.File(self._evfile % mi, "r") as f:
                for row, name in enumerate(("evals_full", "f_evals")):
                    v = f[name][:]
                    if v.size:
                        out[row, -v.size :] = v
            return out

        if comm.rank0():
            logger.info("Creating eigenvalues file (process 0 only).")

        mlist = list(range(self.telescope.mmax + 1))
        evarray = kltransform.collect_m_array(
            mlist, spectra, (2, ndofmax), np.float64
        )

        if comm.rank0():
            fname = os.path.join(self.evdir, "evals.hdf5")
            if os.path.exists(fname):
                logger.info("File %s exists. Skipping...", fname)
                return
            with h5py.File(fname, "w") as f:
                f.create_dataset("evals", data=evarray[:, 0])
                f.create_dataset("f_evals", data=evarray[:, 1])
