"""Dense complex128 referees for the KL spectrum and the Fisher matrix.

The product step's engine works in f32 on factored covariances and never
forms the KL pencil.  These referees do, on the host:

* :func:`dense_spectrum` builds the signal and noise matrices of one m
  from the step's own SVD-basis beams, S = sum_pq B_p C^s_pq B_q^H and
  N = sum_pq B_p C^n_pq B_q^H + I (the beams are noise-prewhitened), in
  complex128, and solves S x = lambda N x with scipy -- the reference
  algorithm (drift/core/kltransform.py:258-341);
* :func:`dense_fisher` computes the quadratic-estimator Fisher matrix of
  each m from the step's KL modes (drift/core/psestimation.py:775-815).

Shared by the tests and ``chip_smoke.py``.
"""

import numpy as np
import scipy.linalg as sla


def beams_of(res, mi, npol, nl):
    """(F, S, npol, nl) complex128 SVD-basis beam of batch slot ``mi``."""
    b = np.asarray(res.beam_re[mi], np.float64) + 1j * np.asarray(
        res.beam_im[mi], np.float64
    )
    return b.reshape(b.shape[0], -1, npol, nl)


def dense_pencil(bsvd, cl_s, cl_n):
    """Dense (S, N) of one m; ``cl_*`` are (npol, npol, nl, F, F) tables."""
    F, S_, npol, nl = bsvd.shape
    n = F * S_
    cls = np.asarray(cl_s, np.float64)
    cln = np.asarray(cl_n, np.float64)
    S_d = np.zeros((F, S_, F, S_), np.complex128)
    N_d = np.zeros((F, S_, F, S_), np.complex128)
    for p in range(npol):
        for q in range(npol):
            for out, cl in ((S_d, cls[p, q]), (N_d, cln[p, q])):
                if not cl.any():
                    continue
                # out[f, a, g, b] = sum_l B[f, a, p, l] C[l, f, g] conj(B[g, b, q, l]),
                # one matrix product per g
                for g in range(F):
                    lhs = bsvd[:, :, p, :] * cl[:, :, g].T[:, None, :]
                    rhs = bsvd[g, :, q, :].conj().T
                    out[:, :, g, :] += (lhs.reshape(n, nl) @ rhs).reshape(F, S_, S_)
    S_d = S_d.reshape(n, n)
    N_d = N_d.reshape(n, n) + np.eye(n)
    return 0.5 * (S_d + S_d.conj().T), 0.5 * (N_d + N_d.conj().T)


def dense_spectrum(bsvd, cl_s, cl_n):
    """Ascending generalised eigenvalues of the dense pencil of one m."""
    S_d, N_d = dense_pencil(bsvd, cl_s, cl_n)
    return np.sort(sla.eigh(S_d, N_d, eigvals_only=True))


def top_spectrum_error(ev_engine, w_dense, cut):
    """(k, max relative error) of the engine's eigenvalues against the
    dense ones, over the k dense eigenvalues above ``cut``."""
    e = np.sort(np.asarray(ev_engine, np.float64))
    w = np.sort(np.asarray(w_dense, np.float64))
    k = int((w > cut).sum())
    if k == 0:
        return 0, 0.0
    return k, float(np.max(np.abs(e[-k:] - w[-k:]) / np.abs(w[-k:])))


def dense_fisher(res, clbands, threshold, npol, nl):
    """(M, nbands, nbands) Fisher of each m from the step's KL modes."""
    m_count = res.evals.shape[0]
    nbands = len(clbands)
    out = np.zeros((m_count, nbands, nbands), dtype=np.complex128)
    for mi in range(m_count):
        ev = np.asarray(res.evals[mi], np.float64)
        keep = ev > threshold
        if not keep.any():
            continue
        evecs = np.asarray(res.evecs_re[mi], np.float64) + 1j * np.asarray(
            res.evecs_im[mi], np.float64
        )
        rows = evecs[keep]  # (k, n) modes as rows (file layout)
        b = beams_of(res, mi, npol, nl)
        F, S = b.shape[0], b.shape[1]
        g = np.einsum("kfs,fsl->kfl", rows.reshape(-1, F, S), b[:, :, 0, :])
        w = 1.0 / (1.0 + ev[keep])
        projs = [
            np.einsum("kfl,lfg,qgl->kq", g, np.asarray(cl, np.float64), g.conj())
            for cl in clbands
        ]
        for a in range(nbands):
            da = projs[a] * w[:, None] * w[None, :]
            for b_ in range(nbands):
                out[mi, a, b_] = np.sum(da * projs[b_].T)
    return out
