"""Device mesh management and sharding helpers.

The primary scaling axis of the m-mode pipeline is the m-mode (and the
freq x baseline) axis — embarrassingly parallel per unit (SURVEY.md
section 2.3).  We therefore use a 1-D device mesh with axis name ``"m"``
and shard batched arrays along their leading (batch) axis.  XLA inserts
the collectives for any resharding (the reference's MPI transpose,
/root/reference/drift/core/beamtransfer.py:632, becomes an output-sharding
change under pjit).
"""

from __future__ import annotations

import functools
import math
from contextlib import contextmanager
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_active_mesh: Optional[Mesh] = None

M_AXIS = "m"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = M_AXIS) -> Mesh:
    """Create a 1-D mesh over the given (default: process-local) devices.

    The default is *local* devices deliberately: the file-based pipeline
    follows the reference's MPI model — each process owns a subset of
    m/fb units and batches them over its own accelerators — so sharding
    a process-local batch over a global mesh would be wrong (and
    ``jax.device_put`` asserts the data is identical on every process).
    Cross-process SPMD paths construct their global mesh explicitly.
    """
    if devices is None:
        devices = jax.local_devices()
    return Mesh(np.array(devices), (axis_name,))


def get_mesh() -> Mesh:
    """The active mesh, creating a default local-device mesh if needed."""
    global _active_mesh
    if _active_mesh is None:
        _active_mesh = make_mesh()
    return _active_mesh


def set_mesh(mesh: Optional[Mesh]):
    global _active_mesh
    _active_mesh = mesh


@contextmanager
def use_mesh(mesh: Mesh):
    global _active_mesh
    prev = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = prev


def n_devices() -> int:
    return math.prod(get_mesh().devices.shape)


def batch_sharding(mesh: Optional[Mesh] = None, ndim: int = 1) -> NamedSharding:
    """Sharding that splits the leading axis over the mesh 'm' axis."""
    mesh = mesh or get_mesh()
    spec = P(mesh.axis_names[0], *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh or get_mesh()
    return NamedSharding(mesh, P())


def pad_batch(n: int, mesh: Optional[Mesh] = None) -> int:
    """Smallest multiple of the device count that is >= n."""
    d = math.prod((mesh or get_mesh()).devices.shape)
    return ((n + d - 1) // d) * d


def transpose_sharded(x, mesh: Optional[Mesh] = None):
    """Reshard a row-sharded array to column sharding with an all-to-all.

    ``x`` is (R, ..., C) sharded along axis 0; the result is the same
    global array sharded along the last axis.  Each device exchanges only
    a (R/P, ..., C/P) tile with every peer — the bandwidth-optimal
    equivalent of the reference's MPI transpose
    (caput.mpiutil.transpose_blocks at
    /root/reference/drift/core/beamtransfer.py:628-638), as a single
    ``lax.all_to_all``.

    R and C must both divide the mesh size (pad + trim at the call site).
    """
    from jax import shard_map

    mesh = mesh or get_mesh()
    ax = mesh.axis_names[0]
    ndev = math.prod(mesh.devices.shape)
    if x.shape[0] % ndev or x.shape[-1] % ndev:
        raise ValueError(
            f"both ends of {x.shape} must divide the mesh size {ndev}"
        )

    ndim = np.ndim(x)
    in_spec = P(ax, *([None] * (ndim - 1)))
    out_spec = P(*([None] * (ndim - 1)), ax)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=(in_spec,), out_specs=out_spec
    )
    def _exchange(xl):
        return jax.lax.all_to_all(
            xl, ax, split_axis=ndim - 1, concat_axis=0, tiled=True
        )

    return _exchange(x)


def shard_batch(x, mesh: Optional[Mesh] = None):
    """Place a batched array with its leading axis sharded over the mesh.

    The leading axis must divide by the device count; use :func:`pad_batch`
    plus masking to arrange that (the reference already zero-pads ragged
    per-m arrays for collection, /root/reference/drift/core/
    kltransform.py:387-391, so the semantics carry over).
    """
    mesh = mesh or get_mesh()
    return jax.device_put(x, batch_sharding(mesh, np.ndim(x)))
