"""Worker: full product generation under an N-process jax.distributed cluster.

The end-to-end analogue of the reference's ``mpirun -np 2
drift-makeproducts`` CI run (/root/reference/tests/test_functional.py:70-76):
every process joins the cluster and runs ProductManager.generate() — the
file-based chunking/transpose/barrier choreography in beamtransfer and the
round-robin m partitioning in kltransform/psestimation are all live.

Run: python mp_product_worker.py <process_id> <num_processes> <port> <config>
"""

import sys


def main():
    pid, nproc, port, cfile = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )

    # Pin the CPU backend through jax.config: two workers opening the
    # same accelerator would collide.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nproc, process_id=pid
    )

    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from driftscan_tpu.core import manager

    m = manager.ProductManager.from_config(cfile)
    m.generate()

    # --- timestream leg: simulate -> m-modes -> SVD modes -> maps ---
    # Covers the parallel_map/mpirange callers in pipeline/timestream.py
    # under a real multi-process cluster (the reference exercises these
    # through caput.parallel_map under mpirun).
    import os

    import h5py
    import numpy as np

    from driftscan_tpu.ops import sht
    from driftscan_tpu.parallel import comm
    from driftscan_tpu.pipeline import timestream

    tel = m.telescope
    outdir = os.path.dirname(os.path.abspath(cfile))
    tag = os.path.splitext(os.path.basename(cfile))[0]
    mapfile = os.path.join(outdir, f"{tag}_skymap.hdf5")
    nside = 16

    if comm.rank0():
        rng = np.random.default_rng(99)
        nl = tel.lmax + 1
        npol = tel.num_pol_sky
        ls = np.arange(nl)[:, None]
        ms = np.arange(nl)[None, :]
        nfp = tel.nfreq * npol
        alm = rng.standard_normal((nfp, nl, nl)) + 1j * rng.standard_normal(
            (nfp, nl, nl)
        )
        alm = np.where(ms <= ls, alm, 0)
        alm[:, :, 0] = alm[:, :, 0].real
        skymap = np.asarray(sht.synthesis_real(alm, nside))
        with h5py.File(mapfile, "w") as f:
            f.create_dataset(
                "map", data=skymap.reshape(tel.nfreq, npol, -1)
            )
    comm.barrier()

    tsdir = os.path.join(outdir, f"{tag}_ts")
    ts = timestream.simulate(m, tsdir, maps=[mapfile], ndays=0)
    ts.generate_mmodes()
    ts.generate_mmodes_svd()
    ts.mapmake_full(nside, "map_full.hdf5")
    ts.mapmake_svd(nside, "map_svd.hdf5")
    comm.barrier()


if __name__ == "__main__":
    main()
