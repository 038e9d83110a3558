"""Child-process worker for the multi-process comm tests.

Mirrors how the reference exercises its MPI layer with
``mpirun -np 2 --oversubscribe`` (/root/reference/tests/test_functional.py:70-76):
each worker joins a 2-process jax.distributed cluster over localhost,
runs every comm verb, and dumps its results for the parent to assert on.

Run: python mp_worker.py <process_id> <num_processes> <port> <outdir>
"""

import sys


def main():
    pid, nproc, port, outdir = (
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

    import numpy as np

    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from driftscan_tpu.parallel import comm

    out = {}
    out["rank"] = comm.rank()
    out["size"] = comm.size()

    comm.barrier()

    out["bcast"] = np.asarray(comm.bcast([3, 1, 4, comm.rank()]))
    out["allreduce"] = comm.allreduce(
        np.arange(6, dtype=np.float64).reshape(2, 3) * (comm.rank() + 1)
    )

    # parallel_map: every process must see the full ordered result list
    out["pmap"] = np.asarray(
        comm.parallel_map(lambda x: np.array([x * 2.0, x + 0.5]), list(range(5)))
    )

    # over-partition: more processes than items must idle the spares, not
    # abort (caput semantics; reference drift/pipeline/timestream.py:246
    # calls this with m-lists that can be shorter than the comm size)
    out["pmap_short"] = np.asarray(
        comm.parallel_map(lambda x: np.array([x + 1.0]), [41.0])
    )

    # collect_m_arrays through the kltransform wrapper
    from driftscan_tpu.core import kltransform

    ev = kltransform.collect_m_array(
        list(range(6)), lambda mi: np.full(3, float(mi)), (3,), np.float64
    )
    out["collect"] = ev

    # transpose_blocks: rows split over processes -> columns split
    gshape = (5, 3, 7)
    full = np.arange(np.prod(gshape), dtype=np.float64).reshape(gshape)
    rn, rs, re_ = comm.split_local(gshape[0])
    local = full[rs:re_]
    col = comm.transpose_blocks(local, gshape)
    cn, cs, ce = comm.split_local(gshape[-1])
    out["transpose"] = col
    out["transpose_expected"] = full[..., cs:ce]

    # mpirange / partition / splits are pure functions; record for parity
    out["mpirange"] = np.asarray(list(comm.mpirange(7)))
    out["split_local"] = np.asarray(comm.split_local(10))

    np.savez(f"{outdir}/worker_{pid}.npz", **out)
    comm.barrier()


if __name__ == "__main__":
    main()
