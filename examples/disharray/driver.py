"""Minimal end-to-end example: products -> simulation -> m-modes -> map.

Run from this directory:

    python driver.py

Mirrors the reference's examples/disharray/driver.py workflow: generate
beam transfers for a dish array, simulate a noiseless timestream from a
random band-limited sky, decompose it into m-modes and make a map.
"""

import os

import h5py
import numpy as np

from driftscan_tpu.core import manager
from driftscan_tpu.ops import sht
from driftscan_tpu.pipeline import timestream


def main():
    here = os.path.dirname(os.path.abspath(__file__))

    # 1. Generate the analysis products.
    m = manager.ProductManager.from_config(os.path.join(here, "prod_params.yaml"))
    m.generate()
    tel = m.telescope

    # 2. Make a random band-limited sky map.
    nside = 32
    rng = np.random.default_rng(42)
    lmax = tel.lmax
    ls = np.arange(lmax + 1)[:, None]
    ms = np.arange(lmax + 1)[None, :]
    alm = rng.standard_normal(
        (tel.nfreq, lmax + 1, lmax + 1)
    ) + 1j * rng.standard_normal((tel.nfreq, lmax + 1, lmax + 1))
    alm = np.where(ms <= ls, alm, 0)
    alm[..., 0] = alm[..., 0].real
    skymap = np.asarray(sht.synthesis_real(alm, nside))

    mapfile = os.path.join(here, "simulated_input_map.hdf5")
    with h5py.File(mapfile, "w") as f:
        f.create_dataset("map", data=skymap[:, np.newaxis, :])

    # 3. Simulate the observation (noiseless).
    ts = timestream.simulate(m, os.path.join(here, "timestream"), [mapfile], ndays=0)

    # 4. m-mode decomposition and map making.
    ts.generate_mmodes()
    ts.mapmake_full(nside, "map_full.hdf5")

    print("Wrote", os.path.join(ts.output_directory, "map_full.hdf5"))


if __name__ == "__main__":
    main()
