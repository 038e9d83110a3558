"""The split-complex hot paths must reproduce the native-complex
results exactly (same math, different layout)."""

import numpy as np
import pytest

import driftscan_tpu.backend as backend
from driftscan_tpu.ops import healpix, kernels, sht, zarray as za
from driftscan_tpu.telescope import cylinder

import jax.numpy as jnp


def test_analysis_split_matches_native():
    rng = np.random.default_rng(0)
    nside, lmax = 16, 12
    npix = 12 * nside**2
    f = rng.standard_normal((3, npix)) + 1j * rng.standard_normal((3, npix))

    pos, neg = sht.analysis(f, lmax, neg_m=True)
    pos_z, neg_z = sht.analysis_split(za.of(jnp.asarray(f)), lmax, neg_m=True)

    np.testing.assert_allclose(za.to_numpy(pos_z), np.asarray(pos), atol=1e-12)
    np.testing.assert_allclose(za.to_numpy(neg_z), np.asarray(neg), atol=1e-12)


def test_fringe_split_matches():
    ang = healpix.ang_positions(8)
    cart = jnp.asarray(kernels.sph_to_cart(jnp.asarray(ang)))
    zenith = jnp.asarray(np.array([0.6, 0.0]))
    uv = np.array([[2.0, -1.0], [0.5, 3.0]])

    native = np.asarray(kernels.fringe(cart, zenith, jnp.asarray(uv)))
    split = za.to_numpy(kernels.fringe_split(cart, zenith, jnp.asarray(uv)))
    np.testing.assert_allclose(split, native, atol=1e-12)


def test_stokes_split_matches():
    rng = np.random.default_rng(1)
    n = 768
    bi = rng.standard_normal((2, n, 2))
    bj = rng.standard_normal((2, n, 2))
    fr = np.exp(2j * np.pi * rng.random((2, n)))
    hz = (rng.random(n) > 0.2).astype(float)

    native = np.asarray(
        kernels.stokes_visibility(
            jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(fr), jnp.asarray(hz)
        )
    )
    split = za.to_numpy(
        kernels.stokes_visibility_split(
            za.of(jnp.asarray(bi)),
            za.of(jnp.asarray(bj)),
            za.of(jnp.asarray(fr)),
            jnp.asarray(hz),
        )
    )
    np.testing.assert_allclose(split, native, atol=1e-12)


@pytest.mark.parametrize("telcls,params", [
    (
        cylinder.UnpolarisedCylinderTelescope,
        dict(num_freq=1, freq_start=100.0, freq_end=110.0, freq_mode="edge",
             num_cylinders=2, cylinder_width=2.0, num_feeds=2, feed_spacing=1.5),
    ),
    (
        cylinder.PolarisedCylinderTelescope,
        dict(num_freq=1, freq_start=100.0, freq_end=110.0, freq_mode="edge",
             num_cylinders=1, cylinder_width=2.0, num_feeds=2, feed_spacing=1.5),
    ),
])
def test_transfer_matrices_split_matches(monkeypatch, telcls, params):
    tel_native = telcls.from_config(params)
    bl = np.arange(tel_native.npairs)
    fi = np.zeros_like(bl)
    native = tel_native.transfer_matrices(bl, fi)

    monkeypatch.setattr(backend, "split_complex", lambda: True)
    tel_split = telcls.from_config(params)
    split = tel_split.transfer_matrices(bl, fi)

    np.testing.assert_allclose(split, native, atol=1e-10)


def test_product_step_vs_dense_pencil():
    """The product step's KL evals must match a dense f64 solve of the
    same pencil built from its own SVD outputs."""
    import __graft_entry__ as g
    from driftscan_tpu.ops import fpencil
    from driftscan_tpu.parallel import mstep

    npol, nl = 1, 8
    beam, noisew, ls, lf, m_values = g._example_args(
        nm=4, nfreq=2, ntel=8, npol=npol, nl=nl, dtype=np.complex128
    )
    noisew = noisew.astype(np.float64)

    res = mstep.kl_product_step(
        beam, noisew, ls, lf, m_values, npol=npol, nl=nl
    )

    # Rebuild the factored pencil from the (complex) SVD outputs and solve
    # densely in f64.
    for i, mi in enumerate(m_values):
        bsvd = np.asarray(res.beam_svd[i])  # (F, S, npol*nl)
        F, S = bsvd.shape[0], bsvd.shape[1]
        b4 = bsvd.reshape(F, S, npol, nl)
        a_s = np.einsum("fapl,lpfk->falk", b4, ls).reshape(F * S, -1)
        a_f = np.einsum("fapl,lpfk->falk", b4, lf).reshape(F * S, -1)
        ev_ref, _ = fpencil.kl_solve_dense_ref(a_s, a_f, with_thermal=True)
        ev = np.asarray(res.evals[i])
        sel = ev_ref > 1e-2 * max(ev_ref.max(), 1.0)
        np.testing.assert_allclose(ev[sel], ev_ref[sel], rtol=1e-3)


@pytest.mark.slow
def test_product_step_split_matches_native():
    """Split planes and the native-complex wrapper agree exactly (the
    wrapper routes through the same split implementation)."""
    import __graft_entry__ as g
    from driftscan_tpu.parallel import mstep

    npol, nl = 1, 8
    beam, noisew, ls, lf, m_values = g._example_args(
        nm=4, nfreq=2, ntel=8, npol=npol, nl=nl
    )

    native = mstep.kl_product_step(
        beam, noisew, ls, lf, m_values, npol=npol, nl=nl
    )
    split = mstep.kl_product_step_split(
        beam.real.copy(), beam.imag.copy(), noisew, ls, lf, m_values,
        npol=npol, nl=nl,
    )

    np.testing.assert_allclose(
        np.asarray(split.sig), np.asarray(native.sig), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(np.asarray(split.nmodes), np.asarray(native.nmodes))
    np.testing.assert_allclose(
        np.asarray(split.evals), np.asarray(native.evals), rtol=1e-5, atol=1e-7
    )


def test_product_step_split_sharded():
    """The split step must compile and run sharded over an 8-device mesh."""
    import __graft_entry__ as g
    import jax
    from driftscan_tpu.parallel import mesh as meshmod, mstep

    npol, nl = 1, 8
    nm = 8
    beam, noisew, ls, lf, m_values = g._example_args(nm=nm, npol=npol, nl=nl)
    mesh = meshmod.make_mesh(jax.devices()[:8])
    step = mstep.jit_product_step_split(npol=npol, nl=nl, mesh=mesh)
    res = step(
        beam.real.copy(), beam.imag.copy(), noisew, ls, lf,
        m_values.astype(np.int32),
    )
    assert np.isfinite(np.asarray(res.evals)).all()
