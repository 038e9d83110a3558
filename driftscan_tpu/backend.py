"""Compute-path routing and the facts every device record carries.

The hot paths have two implementations:

* a native-complex path (the default);
* a split-complex path carrying (re, im) planes (ops.zarray), with
  SVDs via Gram eigendecompositions.

``DRIFTSCAN_TPU_SPLIT_COMPLEX=1`` forces the split path.  Nothing here
probes the device to choose a path, and nothing falls back to the host
when the device fails to start: the first JAX call raises instead.
"""

from __future__ import annotations

import os
import subprocess

import jax
import numpy as np

# Root of the repository checkout (the parent of this package).
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split_complex() -> bool:
    """True if the hot paths should use the split-complex implementation."""
    env = os.environ.get("DRIFTSCAN_TPU_SPLIT_COMPLEX")
    return env is not None and env not in ("", "0", "false", "False")


def fft(x, axis=-1):
    """FFT along ``axis`` on the default device; returns host numpy."""
    import jax.numpy as jnp

    return np.asarray(jnp.fft.fft(jnp.asarray(x), axis=axis))


def ifft(x, axis=-1):
    """Inverse FFT (numpy normalisation) on the default device."""
    import jax.numpy as jnp

    return np.asarray(jnp.fft.ifft(jnp.asarray(x), axis=axis))


def use_compile_cache() -> str:
    """Place JAX's persistent compilation cache; returns its directory.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set
    nothing is configured here.  Otherwise the cache lives at the fixed
    ``<repo>/.jax_cache``: the path is part of the cache key, so a
    directory that moves between runs never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def nvidia_smi() -> str:
    """``name, power.limit`` of the node's GPUs as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, device kind and device count of the default backend.

    On a GPU the record adds the nvidia-smi name and power limit, which
    bound what any timing taken on that card can mean.  Raises when the
    backend fails to start: a record never describes a fallback device.
    """
    devs = jax.devices()
    rec = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if rec["platform"] == "gpu":
        rec["nvidia_smi"] = nvidia_smi()
    return rec
