"""driftscan_tpu — an m-mode transit interferometry framework in JAX.

A from-scratch rebuild (in JAX/XLA) of the capabilities of
``radiocosmology/driftscan``: telescope modelling, beam-transfer-matrix
generation via on-device spherical harmonic transforms, per-m SVD
compression, Karhunen-Loeve foreground filtering, quadratic power spectrum
estimation and a timestream pipeline.

Design stance (see SURVEY.md section 7): single-controller JAX replaces the
reference's SPMD-MPI model.  Work that the reference distributes as
"per-m loops over MPI ranks" becomes batched, padded, mesh-sharded array
programs; the YAML config schema, CLI entry points and HDF5 product layout
of the reference are preserved for compatibility.

Precision: the reference computes everything in complex128
(drift/core/telescope.py:814 and throughout).  We enable x64 in JAX by
default; set DRIFTSCAN_TPU_X64=0 to run in single precision.
"""

import os

import jax

if os.environ.get("DRIFTSCAN_TPU_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

# Full-f32 matmuls everywhere: on a GPU with tensor cores XLA may run
# f32 contractions in TF32, which keeps ~10 mantissa bits (unit roundoff
# ~5e-4) and breaks the reference's beam_m rel-1e-4 and KL rel-1e-4
# accuracy tiers.  "highest" keeps full f32.  The accuracy tiers are
# contractual, so this is the library default (override with
# DRIFTSCAN_TPU_MATMUL_PRECISION).
jax.config.update(
    "jax_default_matmul_precision",
    os.environ.get("DRIFTSCAN_TPU_MATMUL_PRECISION", "highest"),
)

__version__ = "0.1.0"

# Register the native bitshuffle+LZ4 HDF5 filter plugin on import: any
# process that merely *reads* compressed products (downstream consumers,
# test parents) needs the filter on HDF5's plugin path, not only the
# writers (the reference has the same requirement through the bitshuffle
# package, drift/core/beamtransfer.py:26-32).  Best-effort: absence of
# the built plugin only disables the codec, never the import.
try:
    from .ops import bitshuffle as _bitshuffle

    _bitshuffle.register()
except Exception:  # pragma: no cover - never block package import
    pass
