"""Process-level coordination verbs (equivalent of ``caput.mpiutil``).

The reference drives a cluster of MPI ranks; driftscan_tpu drives one
Python process per host, each controlling its local GPUs, following
the single-controller JAX model.  These verbs give the pipeline code the
same nine primitives the reference uses (SURVEY.md section 2.4) with the
same semantics:

==================  =========================================================
reference verb       driftscan_tpu implementation
==================  =========================================================
rank / size          jax.process_index() / jax.process_count()
rank0                process_index() == 0
barrier()            multihost_utils.sync_global_devices
bcast(obj)           multihost broadcast (trivial single-host)
allreduce(x)         psum across processes (numpy add single-host)
split_local/all/m    pure-python block partitions (identical arithmetic)
mpirange             round-robin iterator over range(n)
partition_list       round-robin sublist for this process
parallel_map         map over list + gather to all processes
transpose_blocks     resharding helper (no-op single-process)
==================  =========================================================

Single-process behaviour is exact and dependency-free, which is what the
tests exercise; multi-host behaviour routes through
``jax.experimental.multihost_utils`` over DCN.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_rank = None
_size = None


def _init():
    global _rank, _size
    if _rank is None:
        import jax

        _rank = jax.process_index()
        _size = jax.process_count()
    return _rank, _size


def rank() -> int:
    return _init()[0]


def size() -> int:
    return _init()[1]


def rank0() -> bool:
    return rank() == 0


def barrier():
    """Synchronise all processes (no-op for a single process)."""
    if size() > 1:  # pragma: no cover - runs in subprocess clusters (test_multiprocess*.py)
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("driftscan_tpu.comm.barrier")


def bcast(obj, root: int = 0):
    """Broadcast a picklable object from `root` to all processes."""
    if size() == 1:
        return obj
    from jax.experimental import multihost_utils  # pragma: no cover

    return multihost_utils.broadcast_one_to_all(obj)  # pragma: no cover


def allreduce(x, op="sum"):
    """Sum (by default) an array contribution across all processes."""
    if op not in ("sum", "SUM"):
        raise ValueError(f"Unsupported allreduce op: {op}")
    if size() == 1:
        return x
    from jax.experimental import multihost_utils  # pragma: no cover

    return multihost_utils.process_allgather(np.asarray(x)).sum(
        axis=0
    )  # pragma: no cover


def split_m(n: int, m: int) -> np.ndarray:
    """Split ``range(n)`` into ``m`` near-equal consecutive blocks.

    Returns an array of shape (3, m): rows are (num, start, end) — the same
    packing the reference exposes so chunking code carries over.
    """
    base = n // m
    rem = n % m
    num = base * np.ones(m, dtype=int)
    num[:rem] += 1
    end = np.cumsum(num)
    start = end - num
    return np.array([num, start, end])


def split_all(n: int) -> np.ndarray:
    """Block partition of ``range(n)`` over all processes -> (3, size)."""
    return split_m(n, size())


def split_local(n: int) -> Tuple[int, int, int]:
    """This process's block of ``range(n)`` as (num, start, end)."""
    pieces = split_all(n)
    return tuple(int(v) for v in pieces[:, rank()])


def mpirange(n, *args) -> Sequence[int]:
    """Round-robin subset of ``range(n)`` (or range(start, stop)) for us."""
    r = range(n, *args) if args else range(n)
    return list(r)[rank() :: size()]


def partition_list(full_list: Sequence, i: int, n: int) -> List:
    """Round-robin sublist ``i`` of ``n`` partitions."""
    return list(full_list)[i::n]


def partition_list_mpi(full_list: Sequence) -> List:
    """The sublist of items this process should handle."""
    return partition_list(full_list, rank(), size())


def parallel_map(func: Callable, lst: Sequence) -> List:
    """Map ``func`` over ``lst`` splitting work across processes.

    Returns the full, ordered result list on every process (the reference
    gathers to rank 0 only; returning everywhere is strictly more useful
    and callers gate on rank0 anyway).

    Multi-process exchange requires array results of one common shape and
    dtype (every pipeline caller returns per-m arrays): each process
    fills its round-robin slices of a zero array and a single allreduce
    assembles the total — uniform-shaped collectives, unlike gathering
    ragged Python lists.
    """
    local = [(i, func(x)) for i, x in enumerate(lst) if i % size() == rank()]

    if size() == 1:
        return [v for _, v in local]

    # pragma: no cover - runs in subprocess clusters (test_multiprocess*.py)
    if not lst:
        return []
    # Spare processes (size > len(lst)) idle instead of aborting, matching
    # caput's parallel_map semantics: round-robin puts item 0 on process 0,
    # which shares the result shape/dtype through a fixed-size metadata
    # allreduce (structure-uniform, so idle processes can participate
    # without holding any item).
    _MAXD = 5
    meta = np.zeros(3 + _MAXD, dtype=np.int64)
    if rank() == 0:
        p0 = np.asarray(local[0][1])
        if p0.ndim > _MAXD:
            raise ValueError(
                f"parallel_map results limited to {_MAXD} dims, got {p0.ndim}"
            )
        meta[0] = p0.ndim
        meta[1] = ord(p0.dtype.kind)
        meta[2] = p0.dtype.itemsize
        meta[3 : 3 + p0.ndim] = p0.shape
    meta = np.asarray(allreduce(meta))
    ndim = int(meta[0])
    proto_shape = tuple(int(x) for x in meta[3 : 3 + ndim])
    proto_dtype = np.dtype(f"{chr(int(meta[1]))}{int(meta[2])}")
    full = np.zeros((len(lst),) + proto_shape, dtype=proto_dtype)
    for i, v in local:
        full[i] = v
    full = allreduce(full)
    return list(full)


def _pack_blocks(row_array: np.ndarray, col_blocks, lc: int, lr: int) -> np.ndarray:
    """Pad this process's rows to ``lr`` and regroup the columns so that
    destination block ``r`` occupies the even slot ``[r*lc, r*lc + n_r)``.

    After an even all-to-all reshard, process r's shard then holds exactly
    its balanced split_local column block (plus padding).
    """
    nproc = col_blocks.shape[1]
    out = np.zeros(
        (lr,) + row_array.shape[1:-1] + (nproc * lc,), dtype=row_array.dtype
    )
    nrow = row_array.shape[0]
    for r in range(nproc):
        n_r, s_r, e_r = (int(v) for v in col_blocks[:, r])
        out[:nrow, ..., r * lc : r * lc + n_r] = row_array[..., s_r:e_r]
    return out


def _unpack_blocks(col_array: np.ndarray, row_blocks, lr: int) -> np.ndarray:
    """Invert the row padding of :func:`_pack_blocks` after the exchange:
    concatenate each source process's true rows back together."""
    nproc = row_blocks.shape[1]
    parts = [
        col_array[r * lr : r * lr + int(row_blocks[0][r])] for r in range(nproc)
    ]
    return np.concatenate(parts, axis=0)


def transpose_blocks(row_array: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """Redistribute an axis-0-split array to be split along the last axis.

    The reference implements this as a cluster-wide MPI all-to-all
    (caput.mpiutil.transpose_blocks, used at
    /root/reference/drift/core/beamtransfer.py:632).  Single-process it is
    a pure reshape/slice; multi-process it is a per-peer tile exchange
    through one XLA resharding over a cross-process mesh — each process
    ships ~1/P of its block to each peer and never materialises the global
    array (exercised by tests/test_multiprocess.py).

    Parameters
    ----------
    row_array
        Local block of the global array split along axis 0.  Global shape
        is ``shape`` except the final axis may be longer than ``shape[-1]``
        (extra entries are trimmed, matching the reference behaviour used
        to trim m-modes).
    shape
        The global target shape.

    Returns
    -------
    col_array
        Local block of the global array split along the *last* axis.
    """
    if size() == 1:
        if row_array.shape[0] != shape[0]:
            raise ValueError(
                f"Local rows {row_array.shape[0]} != global rows {shape[0]} "
                "in single-process transpose_blocks"
            )
        return row_array[..., : shape[-1]]

    # Multi-process: per-peer tile exchange — each process ships only
    # ~1/P of its block to each peer and never materialises the global
    # array (the reference's MPI all-to-all,
    # caput.mpiutil.transpose_blocks).  The balanced split_local blocks
    # are packed into an even padded layout first so a plain sharded
    # reshard (one XLA all-to-all over DCN) lands every process exactly
    # its own block.
    # pragma: no cover - runs in subprocess clusters (test_multiprocess*.py)
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    nproc = size()
    ndim = len(shape)

    col_blocks = split_all(shape[-1])
    row_blocks = split_all(shape[0])
    lr = int(row_blocks[0].max())
    lc = int(col_blocks[0].max())

    local = _pack_blocks(
        np.ascontiguousarray(row_array[..., : shape[-1]]), col_blocks, lc, lr
    )

    devs = np.array(jax.devices()).reshape(nproc, -1)[:, 0]
    mesh = Mesh(devs, ("p",))
    row_sharding = NamedSharding(mesh, PartitionSpec("p", *([None] * (ndim - 1))))
    col_sharding = NamedSharding(mesh, PartitionSpec(*([None] * (ndim - 1)), "p"))

    gshape = (nproc * lr,) + local.shape[1:-1] + (nproc * lc,)
    garr = jax.make_array_from_single_device_arrays(
        gshape, row_sharding, [jax.device_put(local, devs[rank()])]
    )
    out = jax.jit(lambda a: a, out_shardings=col_sharding)(garr)

    local_out = np.asarray(list(out.addressable_shards)[0].data)
    ncols = int(col_blocks[0][rank()])
    return _unpack_blocks(local_out, row_blocks, lr)[..., :ncols]


class MPILogFilter(logging.Filter):
    """Add process rank/size fields to log records and gate by level.

    Mirrors the interface of ``caput.mpiutil.MPILogFilter`` used by the CLI
    (/root/reference/drift/scripts/makeproducts.py:63).
    """

    def __init__(
        self,
        add_mpi_info: bool = True,
        level_rank0: int = logging.INFO,
        level_all: int = logging.WARNING,
    ):
        super().__init__()
        self.add_mpi_info = add_mpi_info
        self.level_rank0 = level_rank0
        self.level_all = level_all

    def filter(self, record):
        if self.add_mpi_info:
            record.mpi_rank = rank()
            record.mpi_size = size()
        level = self.level_rank0 if rank() == 0 else self.level_all
        return record.levelno >= level
