"""The fb<->m reshard: a real all-to-all, not an allgather.

Each participant must exchange only
~1/P of the array per peer (reference:
caput.mpiutil.transpose_blocks used at
/root/reference/drift/core/beamtransfer.py:628-638).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from driftscan_tpu.parallel import comm, mesh as meshmod


@pytest.fixture
def mesh8():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return meshmod.make_mesh(devices[:8])


class TestTransposeSharded:
    def test_matches_plain_transpose(self, mesh8):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((16, 3, 24)).astype(np.float32)

        out = meshmod.transpose_sharded(jnp.asarray(x), mesh8)
        np.testing.assert_allclose(np.asarray(out), x, rtol=0, atol=0)

        # the result really is column-sharded over the mesh
        spec = out.sharding.spec
        assert spec[-1] == "m"
        assert len(out.sharding.device_set) == 8

    def test_compiles_to_all_to_all(self, mesh8):
        """The exchange must be a true all-to-all collective — each device
        sends only a 1/P tile to each peer — not an all-gather."""
        from functools import partial

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        ax = mesh8.axis_names[0]

        @partial(
            shard_map,
            mesh=mesh8,
            in_specs=(P(ax, None, None),),
            out_specs=P(None, None, ax),
        )
        def exchange(xl):
            return jax.lax.all_to_all(xl, ax, split_axis=2, concat_axis=0, tiled=True)

        x = jnp.zeros((16, 3, 24), dtype=jnp.float32)
        txt = jax.jit(exchange).lower(x).compile().as_text()
        assert "all-to-all" in txt
        assert "all-gather" not in txt

    def test_rejects_indivisible(self, mesh8):
        x = jnp.zeros((10, 24))  # 10 does not divide 8
        with pytest.raises(ValueError):
            meshmod.transpose_sharded(x, mesh8)


class TestPackedExchangeLogic:
    """Host-side simulation of the multi-process branch: pack per-process
    blocks, emulate the even all-to-all with numpy, unpack — must equal the
    direct global transpose slicing for ragged sizes."""

    @pytest.mark.parametrize("nproc,rows,cols", [(2, 7, 9), (3, 8, 10), (4, 16, 6)])
    def test_roundtrip(self, nproc, rows, cols):
        rng = np.random.default_rng(rows * cols)
        full = rng.standard_normal((rows, 5, cols))

        row_blocks = comm.split_m(rows, nproc)
        col_blocks = comm.split_m(cols, nproc)
        lr = int(row_blocks[0].max())
        lc = int(col_blocks[0].max())

        # every process packs its row block
        packed = [
            comm._pack_blocks(
                full[int(row_blocks[1][r]) : int(row_blocks[2][r])],
                col_blocks,
                lc,
                lr,
            )
            for r in range(nproc)
        ]

        # emulate the even all-to-all reshard: global (nproc*lr, 5, nproc*lc)
        # row-stacked, then each process takes its even column shard
        gbl = np.concatenate(packed, axis=0)
        for r in range(nproc):
            shard = gbl[..., r * lc : (r + 1) * lc]
            got = comm._unpack_blocks(shard, row_blocks, lr)
            ncols = int(col_blocks[0][r])
            got = got[..., :ncols]

            s, e = int(col_blocks[1][r]), int(col_blocks[2][r])
            np.testing.assert_array_equal(got, full[..., s:e])
