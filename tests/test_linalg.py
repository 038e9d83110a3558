import numpy as np
import scipy.linalg as la

from driftscan_tpu.ops import linalg


def _rand_herm(n, rng, pd=False):
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = a + a.conj().T
    if pd:
        h = a @ a.conj().T + n * np.eye(n)
    return h


def test_eigh_gen_matches_scipy():
    rng = np.random.default_rng(0)
    n = 12
    A = _rand_herm(n, rng)
    B = _rand_herm(n, rng, pd=True)

    w, v, ac = linalg.eigh_gen(A.copy(), B.copy())
    ws, vs = la.eigh(A, B)

    assert ac == 0.0
    np.testing.assert_allclose(w, ws, rtol=1e-9, atol=1e-9)
    # Verify the generalised eigen-relation and B-orthonormality
    np.testing.assert_allclose(A @ v, B @ v @ np.diag(w), atol=1e-8)
    np.testing.assert_allclose(v.conj().T @ B @ v, np.eye(n), atol=1e-8)


def test_eigh_gen_regularises_nonpd():
    rng = np.random.default_rng(1)
    n = 8
    A = _rand_herm(n, rng)
    # Make B indefinite so Cholesky fails
    B = _rand_herm(n, rng, pd=True)
    B[0, 0] = -1.0

    w, v, ac = linalg.eigh_gen(A, B)
    assert ac > 0.0
    assert np.isfinite(w).all()


def test_eigh_gen_zero_A():
    B = np.eye(4, dtype=complex)
    w, v, ac = linalg.eigh_gen(np.zeros((4, 4), dtype=complex), B)
    np.testing.assert_array_equal(w, 0)
    np.testing.assert_array_equal(v, np.eye(4))


def test_eigh_gen_batched():
    rng = np.random.default_rng(2)
    n, nb = 10, 5
    As = np.stack([_rand_herm(n, rng) for _ in range(nb)])
    Bs = np.stack([_rand_herm(n, rng, pd=True) for _ in range(nb)])
    As[3] = 0.0  # all-zero A convention

    w, v, ac = linalg.eigh_gen_batched(As, Bs)
    w, v, ac = np.asarray(w), np.asarray(v), np.asarray(ac)

    for i in range(nb):
        if i == 3:
            np.testing.assert_array_equal(w[i], 0)
            continue
        ws = la.eigh(As[i], Bs[i], eigvals_only=True)
        np.testing.assert_allclose(w[i], ws, rtol=1e-8, atol=1e-8)


def test_matrix_image_nullspace():
    rng = np.random.default_rng(3)
    # Rank-3 matrix embedded in 8x6
    u = la.qr(rng.standard_normal((8, 3)), mode="economic")[0]
    v = la.qr(rng.standard_normal((6, 3)), mode="economic")[0]
    A = u @ np.diag([5.0, 2.0, 1.0]) @ v.T

    img, spec = linalg.matrix_image(A, rtol=1e-6)
    assert img.shape == (8, 3)
    # Image spans the same subspace as u
    proj = img @ img.conj().T
    np.testing.assert_allclose(proj @ u, u, atol=1e-10)

    nullsp, spec = linalg.matrix_nullspace(A, rtol=1e-6)
    assert nullsp.shape == (8, 5)
    np.testing.assert_allclose(nullsp.conj().T @ A, 0.0, atol=1e-10)


def test_triple_svd_unpolarised():
    rng = np.random.default_rng(4)
    ntel, nl = 10, 7
    bf = rng.standard_normal((3, ntel, nl)) + 1j * rng.standard_normal((3, ntel, nl))

    ut, beam, sig, nmodes = (
        np.asarray(x) for x in linalg.triple_svd_batched(bf, npol=1, nl=nl)
    )
    svd_len = min(ntel, nl)
    assert ut.shape == (3, svd_len, ntel)
    assert beam.shape == (3, svd_len, nl)
    assert (nmodes == svd_len).all()

    for i in range(3):
        # Singular values match scipy
        s = la.svd(bf[i], compute_uv=False)
        np.testing.assert_allclose(sig[i], s[:svd_len], rtol=1e-9)
        # beam = ut @ bf
        np.testing.assert_allclose(beam[i], ut[i] @ bf[i], atol=1e-9)
        # ut rows orthonormal
        np.testing.assert_allclose(
            ut[i] @ ut[i].conj().T, np.eye(svd_len), atol=1e-9
        )


def test_triple_svd_polarised_filters_polarisation():
    """Construct a beam whose polarised response occupies a known telescope
    subspace and check the SVD basis is orthogonal to it."""
    rng = np.random.default_rng(5)
    ntel, nl, npol = 12, 5, 4

    # Unpolarised part: random, full rank. Polarised part: lives only in the
    # span of two fixed telescope vectors.
    bf = np.zeros((1, ntel, npol * nl), dtype=complex)
    bf[0, :, :nl] = rng.standard_normal((ntel, nl)) + 1j * rng.standard_normal(
        (ntel, nl)
    )
    polspace = la.qr(rng.standard_normal((ntel, 2)), mode="economic")[0]
    bf[0, :, nl : 3 * nl] = polspace @ (
        rng.standard_normal((2, 2 * nl)) * 10.0
    )  # strong polarised response

    ut, beam, sig, nmodes = (
        np.asarray(x)
        for x in linalg.triple_svd_batched(bf, npol=npol, nl=nl, polsvcut=1e-4)
    )
    nm = int(nmodes[0])
    assert nm > 0
    # The retained modes must be (nearly) orthogonal to the polarised space
    overlap = np.abs(ut[0, :nm] @ polspace)
    assert overlap.max() < 1e-6
    # And beam rows beyond nmodes are zero padding
    if nm < beam.shape[1]:
        assert np.abs(beam[0, nm:]).max() == 0.0


def test_blockla_parity():
    rng = np.random.default_rng(6)
    blocks = rng.standard_normal((4, 5, 3))
    u, s, v = linalg.svd_dm(blocks, full_matrices=False)
    for i in range(4):
        us, ss, vs = la.svd(blocks[i], full_matrices=False)
        np.testing.assert_allclose(s[i], ss, rtol=1e-10)

    vec = rng.standard_normal((4, 3))
    out = linalg.multiply_dm_v(blocks, vec)
    for i in range(4):
        np.testing.assert_allclose(out[i], blocks[i] @ vec[i], rtol=1e-10)

    m2 = rng.standard_normal((4, 3, 6))
    out2 = linalg.multiply_dm_dm(blocks, m2)
    for i in range(4):
        np.testing.assert_allclose(out2[i], blocks[i] @ m2[i], rtol=1e-10)

    pinv = linalg.pinv_dm(blocks, rcond=1e-8)
    for i in range(4):
        np.testing.assert_allclose(pinv[i], la.pinv(blocks[i]), atol=1e-8)


def test_generalised_eigh_bucket_padding(monkeypatch):
    """The split dispatch pads to power-of-two buckets; results must match
    the native solve at assorted odd sizes."""
    import driftscan_tpu.backend as backend
    from driftscan_tpu.ops import projections

    rng = np.random.default_rng(5)
    for n in (9, 17, 33, 48):
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        A = (a @ a.conj().T).astype(np.complex128)
        b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        B = (b @ b.conj().T + 10 * np.eye(n)).astype(np.complex128)

        w_ref, v_ref, _ = projections.generalised_eigh(A, B)

        monkeypatch.setattr(backend, "split_complex", lambda: True)
        w, v, ac = projections.generalised_eigh(A, B)
        monkeypatch.undo()

        assert w.shape == (n,)
        assert v.shape == (n, n)
        # split mode computes at f32 device precision
        np.testing.assert_allclose(w, w_ref, rtol=1e-3, atol=1e-5)
        # N-orthonormality of the padded-solve vectors
        g = v.conj().T @ B @ v
        np.testing.assert_allclose(g, np.eye(n), atol=1e-3)
