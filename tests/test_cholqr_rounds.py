"""CholQR round-count override: accuracy at bench-class conditioning.

The f32 default (8 rounds) covers cond(N) ~ 1e18 pencils
(fpencil._cholqr_rounds); the override is a measured-run lever.  This
pins the CPU referee result that justified offering the lever at all:
at cond(N) ~ 3e11 (the bench pencil's class), rounds=4 sits on the same
f32 Gram noise floor as rounds=8 against the dense f64 pencil.

Reference anchor: the reference solves the same pencil densely per m
(/root/reference/drift/core/kltransform.py:275-343 eigh_gen); the
round-count question only exists for the factored f32 path.
"""

import numpy as np
import pytest
import scipy.linalg as sla

import jax.numpy as jnp

from driftscan_tpu.ops import fpencil
from driftscan_tpu.ops import zarray as za


@pytest.fixture
def hard_pencil():
    rng = np.random.default_rng(7)
    n, kf, ks = 64, 160, 320
    u = np.linalg.qr(rng.standard_normal((n, n)))[0]
    spread = np.logspace(5.75, -2.0, n)  # cond(N) ~ 3e11
    q1 = np.linalg.qr(rng.standard_normal((kf, n)))[0].T[:n]
    q2 = np.linalg.qr(rng.standard_normal((kf, n)))[0].T[:n]
    a_f = (u * spread) @ q1 + 1j * 0.3 * (u * spread) @ q2
    a_s = (
        rng.standard_normal((n, ks)) + 1j * rng.standard_normal((n, ks))
    ) * 0.05
    a_s = a_s + (u * spread)[:, :6] @ (
        0.02
        * (rng.standard_normal((6, ks)) + 1j * rng.standard_normal((6, ks)))
    )
    return a_s, a_f


def _top_rel(a_s, a_f, rounds):
    n_mat = np.eye(a_s.shape[0]) + a_f @ a_f.conj().T
    s_mat = a_s @ a_s.conj().T
    w_ref = np.sort(
        sla.eigh(
            s_mat.astype(np.complex128),
            n_mat.astype(np.complex128),
            eigvals_only=True,
        )
    )[::-1]
    k = max(int((w_ref > 0.1 * w_ref[0]).sum()), 8)

    old = fpencil._CHOLQR_ROUNDS
    fpencil._CHOLQR_ROUNDS = rounds
    try:
        res = fpencil.kl_solve_qr(
            za.Z(
                jnp.asarray(a_s.real, jnp.float32),
                jnp.asarray(a_s.imag, jnp.float32),
            ),
            za.Z(
                jnp.asarray(a_f.real, jnp.float32),
                jnp.asarray(a_f.imag, jnp.float32),
            ),
        )
    finally:
        fpencil._CHOLQR_ROUNDS = old
    w = np.sort(np.asarray(res.evals))[::-1]
    return float(np.abs(w[:k] - w_ref[:k]).max() / w_ref[0])


def test_rounds4_matches_default_floor(hard_pencil):
    a_s, a_f = hard_pencil
    rel8 = _top_rel(a_s, a_f, None)  # library default (8 at f32)
    rel4 = _top_rel(a_s, a_f, 4)
    # both sit on the f32 Gram formation floor; 4 rounds must not be
    # meaningfully worse than the worst-case-coverage default
    assert rel8 < 5e-3
    assert rel4 < max(3.0 * rel8, 2e-3)


def test_env_override_shape(monkeypatch):
    # the override is honoured by _cholqr_rounds for both dtypes
    monkeypatch.setattr(fpencil, "_CHOLQR_ROUNDS", 5)
    assert fpencil._cholqr_rounds(jnp.float32) == 5
    assert fpencil._cholqr_rounds(jnp.float64) == 5
    monkeypatch.setattr(fpencil, "_CHOLQR_ROUNDS", None)
    assert fpencil._cholqr_rounds(jnp.float32) == 8
    assert fpencil._cholqr_rounds(jnp.float64) == 4
