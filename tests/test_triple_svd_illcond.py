"""Ill-conditioned polarised triple-SVD: split (Gram) vs native path.

The Gram-eigendecomposition SVD floors singular
values at ~1e-5 relative; probe polarised beams whose pol-response
spectrum straddles the polsvcut and confirm the retained subspaces match
the native (LAPACK-backed) path.  The engineered spectra avoid values
inside the Gram noise band of the cut (half-decade offsets), since a
singular value *at* the cut legitimately resolves either way.
"""

import numpy as np
import pytest

from driftscan_tpu.ops import linalg


def _beam_with_pol_spectrum(rng, ntel, nl, pol_spectrum, i_spectrum):
    """(ntel, 4*nl) beam: Stokes-I block with ``i_spectrum``; the three
    polarised blocks share row space with log-spaced ``pol_spectrum``
    (relative to the I amplitude)."""
    k = min(ntel, nl)

    def rot(n, m, s):
        u, _ = np.linalg.qr(
            rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
        )
        v, _ = np.linalg.qr(
            rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))
        )
        return (u * s) @ v.conj().T

    bi = rot(ntel, nl, i_spectrum)
    # one shared left basis for the pol blocks so the nullspace is defined
    u, _ = np.linalg.qr(
        rng.standard_normal((ntel, k)) + 1j * rng.standard_normal((ntel, k))
    )
    pol = []
    for _ in range(3):
        v, _ = np.linalg.qr(
            rng.standard_normal((nl, k)) + 1j * rng.standard_normal((nl, k))
        )
        pol.append((u * pol_spectrum) @ v.conj().T / np.sqrt(3.0))
    return np.concatenate([bi] + pol, axis=1)


def test_pol_null_cut_matches_native():
    """Pol spectrum spans 5.5 decades with no value within half a decade
    of the polsvcut: the kept mode counts and spectra must agree."""
    rng = np.random.default_rng(3)
    ntel, nl = 12, 8
    k = min(ntel, nl)

    pol_spec = np.logspace(-0.25, -5.75, k)  # nearest to 1e-4: 10^-3.75/-4.25
    i_spec = np.logspace(0, -1, k)
    beams = np.stack(
        [_beam_with_pol_spectrum(rng, ntel, nl, pol_spec, i_spec) for _ in range(3)]
    )

    ut_n, b_n, sig_n, nm_n = linalg.triple_svd_batched(
        beams, npol=4, nl=nl, polsvcut=1e-4
    )
    ur, ui, br, bi_, sig_s, nm_s = linalg.triple_svd_split_batched(
        np.ascontiguousarray(beams.real),
        np.ascontiguousarray(beams.imag),
        npol=4,
        nl=nl,
        polsvcut=1e-4,
    )
    sig_n, sig_s = np.asarray(sig_n), np.asarray(sig_s)
    nm_n, nm_s = np.asarray(nm_n), np.asarray(nm_s)

    assert (nm_n > 0).all(), "test construction should leave pol-null modes"
    np.testing.assert_array_equal(nm_s, nm_n)

    # significant singular values agree to the Gram floor accuracy
    sel = sig_n > 1e-4 * sig_n.max()
    np.testing.assert_allclose(sig_s[sel], sig_n[sel], rtol=1e-3)

    # the retained sky-projection row spaces coincide
    b_s = np.asarray(br) + 1j * np.asarray(bi_)
    b_nn = np.asarray(b_n)
    for i in range(3):
        kk = nm_n[i]
        q, _ = np.linalg.qr(b_nn[i, :kk].conj().T)
        resid = b_s[i, :kk].conj().T - q @ (q.conj().T @ b_s[i, :kk].conj().T)
        rel = np.linalg.norm(resid) / np.linalg.norm(b_s[i, :kk])
        assert rel < 1e-2, (i, rel)


def test_boundary_pol_values_differ_gracefully():
    """A pol singular value *inside* the Gram noise band of the cut may
    resolve either way; the disagreement must be confined to that mode
    (counts differ by at most the number of boundary values)."""
    rng = np.random.default_rng(11)
    ntel, nl = 12, 8
    k = min(ntel, nl)

    pol_spec = np.logspace(-0.25, -5.75, k)
    pol_spec[k // 2] = 1.0005e-4  # right at the cut
    i_spec = np.logspace(0, -1, k)
    beams = np.stack(
        [_beam_with_pol_spectrum(rng, ntel, nl, pol_spec, i_spec) for _ in range(2)]
    )

    *_, nm_n = linalg.triple_svd_batched(beams, npol=4, nl=nl, polsvcut=1e-4)
    *_, nm_s = linalg.triple_svd_split_batched(
        np.ascontiguousarray(beams.real),
        np.ascontiguousarray(beams.imag),
        npol=4,
        nl=nl,
        polsvcut=1e-4,
    )
    assert np.abs(np.asarray(nm_s) - np.asarray(nm_n)).max() <= 1
