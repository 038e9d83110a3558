"""The production SVD/KL batched paths must execute sharded over the
full virtual device mesh (mesh-sharding wired into the real pipeline,
replacing the reference's rank-partitioned per-m loops
at /root/reference/drift/core/beamtransfer.py:716-722 and
kltransform.py:480-513)."""

import numpy as np
import pytest

import jax

from driftscan_tpu.ops import fpencil, projections
from driftscan_tpu.parallel import mesh as meshmod


@pytest.fixture
def mesh8():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return meshmod.make_mesh(devices[:8])


def _random_bsvd(rng, M, F, S, npol, nl):
    b = rng.standard_normal((M, F, S, npol, nl)) + 1j * rng.standard_normal(
        (M, F, S, npol, nl)
    )
    return b * 0.1


def _psd_cl(rng, npol, nl, F, scale):
    a = rng.standard_normal((nl, npol * F, npol * F))
    m = np.einsum("lij,lkj->lik", a, a) * scale
    return (
        m.reshape(nl, npol, F, npol, F).transpose(1, 3, 0, 2, 4)
    )


def test_kl_factored_batched_sharded_over_mesh(mesh8):
    rng = np.random.default_rng(0)
    M, F, S, npol, nl = 8, 2, 3, 1, 6
    bsvd = _random_bsvd(rng, M, F, S, npol, nl)
    ls = fpencil.factor_cl(_psd_cl(rng, npol, nl, F, 1.0))
    lf = fpencil.factor_cl(_psd_cl(rng, npol, nl, F, 1e6))

    # trace through with explicit sharding and check device placement
    import jax.sharding as jsh

    shard = jsh.NamedSharding(mesh8, jsh.PartitionSpec("m"))
    b_re = jax.device_put(np.ascontiguousarray(bsvd.real), shard)
    assert len(b_re.sharding.device_set) == 8

    w, v = projections.kl_factored_batched(bsvd, ls, lf, mesh=mesh8)
    assert w.shape == (M, F * S)
    assert np.isfinite(w).all()
    assert np.isfinite(v).all()

    # same numbers as the unsharded solve
    w1, v1 = projections.kl_factored_batched(bsvd, ls, lf, mesh=None)
    np.testing.assert_allclose(w, w1, rtol=1e-10, atol=1e-12)


def test_kl_factored_batched_pads_ragged_batch(mesh8):
    rng = np.random.default_rng(1)
    M, F, S, npol, nl = 5, 2, 3, 1, 6  # 5 does not divide 8
    bsvd = _random_bsvd(rng, M, F, S, npol, nl)
    ls = fpencil.factor_cl(_psd_cl(rng, npol, nl, F, 1.0))
    lf = fpencil.factor_cl(_psd_cl(rng, npol, nl, F, 1e4))

    w, v = projections.kl_factored_batched(bsvd, ls, lf, mesh=mesh8)
    assert w.shape == (M, F * S)
    assert v.shape == (M, F * S, F * S)


def test_triple_svd_sharded_matches_unsharded(mesh8):
    rng = np.random.default_rng(2)
    n, ntel, npol, nl = 11, 8, 1, 6
    bfm = rng.standard_normal((n, ntel, npol * nl)) + 1j * rng.standard_normal(
        (n, ntel, npol * nl)
    )

    ut0, beam0, sig0, nm0 = projections.triple_svd(
        bfm, npol=npol, nl=nl, polsvcut=1e-4, mesh=None
    )
    ut1, beam1, sig1, nm1 = projections.triple_svd(
        bfm, npol=npol, nl=nl, polsvcut=1e-4, mesh=mesh8
    )
    np.testing.assert_allclose(sig1, sig0, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(nm1, nm0)
    np.testing.assert_allclose(np.abs(ut1), np.abs(ut0), rtol=1e-8, atol=1e-10)


def test_kltransform_generate_uses_mesh(tmp_path, monkeypatch):
    """End-to-end: KLTransform.generate drives kl_factored_batched with
    the active mesh."""
    import yaml

    from driftscan_tpu.core import manager

    conf = yaml.safe_load(
        f"""
config:
    beamtransfers:      Yes
    kltransform:        Yes
    psfisher:           No
    output_directory:   "{tmp_path}/prod"

telescope:
    type:               UnpolarisedCylinder
    num_freq:           2
    freq_start:         100.0
    freq_end:           110.0
    freq_mode:          edge
    num_cylinders:      2
    cylinder_width:     2.0
    num_feeds:          2
    feed_spacing:       1.5

kltransform:
    -   type:           KLTransform
        name:           kl
"""
    )

    seen = {}
    orig = projections.kl_factored_batched

    def spy(*args, **kwargs):
        seen["mesh"] = kwargs.get("mesh")
        return orig(*args, **kwargs)

    monkeypatch.setattr(projections, "kl_factored_batched", spy)

    m = manager.ProductManager()
    m.apply_config(conf)
    m.generate()

    assert seen, "batched KL path was not taken"
    assert seen["mesh"] is not None
    assert seen["mesh"].devices.size == len(jax.devices())


@pytest.mark.slow
def test_kl_factored_topband_sharded_over_mesh(mesh8):
    """The retained-band batched solve shards over the mesh and agrees
    with its own unsharded run and with the exact engine's retained
    eigenvalues; certificates gather correctly across shards."""
    rng = np.random.default_rng(3)
    M, F, S, npol, nl = 8, 2, 3, 1, 6
    bsvd = _random_bsvd(rng, M, F, S, npol, nl) * 10.0
    ls = fpencil.factor_cl(_psd_cl(rng, npol, nl, F, 1.0))
    lf = fpencil.factor_cl(_psd_cl(rng, npol, nl, F, 1e6))
    # the strong foreground pushes every S/N eigenvalue far below 0.1
    # on this synthetic case; an absolute cut inside the true spectrum
    # exercises the engine just the same
    cut = 1e-9

    w, v, ok = projections.kl_factored_batched_topband(
        bsvd, ls, lf, cut=cut, mesh=mesh8
    )
    assert w.shape == (M, F * S) and ok.shape == (M,)
    w1, v1, ok1 = projections.kl_factored_batched_topband(
        bsvd, ls, lf, cut=cut, mesh=None
    )
    np.testing.assert_array_equal(ok, ok1)
    np.testing.assert_allclose(w, w1, rtol=1e-10, atol=1e-12)

    we, _ = projections.kl_factored_batched(bsvd, ls, lf, mesh=None)
    keep = we > cut
    assert keep.any()
    if ok.all():
        np.testing.assert_array_equal(w > cut, keep)
        np.testing.assert_allclose(w[keep], we[keep], rtol=1e-4)
