"""The resident product path imports without the file-pipeline packages.

``h5py``, ``yaml`` and ``click`` serve the HDF5 products, the YAML
configs and the CLI; the device-resident path (bench, the resident and
m-step modules, the cylinder telescopes, the Fisher band construction)
must not need them, so it runs where only the numerical stack exists."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKER = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("h5py", "yaml", "click"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import bench
from driftscan_tpu.core import psestimation
from driftscan_tpu.parallel import mstep, resident
from driftscan_tpu.telescope import cylinder
try:
    import h5py
except ImportError:
    print("BLOCKED-OK")
"""


def test_resident_path_imports_without_file_packages():
    res = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(repo=REPO)],
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BLOCKED-OK" in res.stdout
