"""CLI entry points, exercised as subprocesses (like the reference's
functional test, which launches the real drift-makeproducts binary)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIG = """
config:
    beamtransfers:      Yes
    kltransform:        No
    psfisher:           No
    output_directory:   "{out}"
    nosvd:              Yes

telescope:
    type:               UnpolarisedCylinder
    num_freq:           1
    freq_start:         100.0
    freq_end:           110.0
    freq_mode:          edge
    num_cylinders:      1
    cylinder_width:     2.0
    num_feeds:          2
    feed_spacing:       1.5
"""


def _env():
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # Force the CPU backend in the subprocess (set before jax imports).
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


def _run_cli(module, args):
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        f"import runpy, sys; sys.argv = ['x'] + {args!r};"
        f"runpy.run_module('{module}', run_name='__main__')"
    )
    return subprocess.run(
        [sys.executable, "-c", code],
        env=_env(),
        capture_output=True,
        text=True,
        timeout=500,
    )


def test_makeproducts_help():
    res = _run_cli("driftscan_tpu.scripts.makeproducts", ["--help"])
    assert res.returncode == 0
    assert "run" in res.stdout and "queue" in res.stdout


def test_runpipeline_help():
    res = _run_cli("driftscan_tpu.scripts.runpipeline", ["--help"])
    assert res.returncode == 0
    assert "run-config" in res.stdout


def test_makeproducts_run(tmp_path):
    cfile = tmp_path / "params.yaml"
    cfile.write_text(CONFIG.format(out=tmp_path / "testdir"))

    res = _run_cli("driftscan_tpu.scripts.makeproducts", ["run", str(cfile)])
    assert res.returncode == 0, res.stderr[-2000:]
    assert (tmp_path / "testdir" / "bt" / "beam_m" / "COMPLETED").exists()


def test_makeproducts_queue_script(tmp_path):
    conf = CONFIG.format(out=tmp_path / "testdir")
    # queue keys live in the config section
    conf = conf.replace(
        'output_directory:   "%s"' % (tmp_path / "testdir"),
        'output_directory:   "%s"\n    queue_sys: slurm\n    nodes: 2\n    time: "1:00:00"'
        % (tmp_path / "testdir"),
    )
    cfile = tmp_path / "params.yaml"
    cfile.write_text(conf)

    res = _run_cli(
        "driftscan_tpu.scripts.makeproducts",
        ["queue", str(cfile), "--nosubmit"],
    )
    assert res.returncode == 0, res.stderr[-2000:]
    script = tmp_path / "testdir" / "slurm" / "jobscript.sh"
    assert script.exists()
    assert "srun" in script.read_text()


@pytest.mark.parametrize(
    "queue_sys, marker", [("pbs", "#PBS"), ("slurm", "#SBATCH"), (None, "#SBATCH")]
)
def test_queue_templates_render(tmp_path, queue_sys, marker):
    """Each remaining scheduler template renders; Slurm is the default."""
    from click.testing import CliRunner

    from driftscan_tpu.scripts import makeproducts

    out = tmp_path / "out"
    extra = f"\n    queue_sys: {queue_sys}" if queue_sys else ""
    cfile = tmp_path / "params.yaml"
    cfile.write_text(f'config:\n    output_directory: "{out}"{extra}\n')
    res = CliRunner().invoke(makeproducts.cli, ["queue", str(cfile), "--nosubmit"])
    assert res.exit_code == 0, res.output
    text = (out / (queue_sys or "slurm") / "jobscript.sh").read_text()
    assert marker in text
    assert "driftscan_tpu.scripts.makeproducts run" in text
    assert "%(" not in text  # every template key filled


def test_queue_refuses_unknown_scheduler(tmp_path):
    from click.testing import CliRunner

    from driftscan_tpu.scripts import makeproducts

    assert set(makeproducts.script_templates) == {"pbs", "slurm"}
    cfile = tmp_path / "params.yaml"
    cfile.write_text(
        f'config:\n    output_directory: "{tmp_path / "out"}"\n    queue_sys: tpu\n'
    )
    res = CliRunner().invoke(makeproducts.cli, ["queue", str(cfile), "--nosubmit"])
    assert res.exit_code != 0
    assert "unknown scheduler" in str(res.exception)


PIPE_CONFIG = """
config:
    product_directory:  {prod}
    generate_modes:     Yes
    generate_klmodes:   No
    generate_powerspectra: No
    generate_maps:      Yes
    nside:              16

timestreams:
    -   name:       ts1
        directory:  {ts}
        simulate:
            product_directory:  {prod}
            maps:
                - {mapfile}
            ndays:  0
"""


def test_runpipeline_run_config(tmp_path):
    """Products -> simulated timestream -> m-modes -> maps, via the CLI."""
    import h5py
    import numpy as np

    prod = tmp_path / "testdir"
    cfile = tmp_path / "params.yaml"
    cfile.write_text(CONFIG.format(out=prod))
    res = _run_cli("driftscan_tpu.scripts.makeproducts", ["run", str(cfile)])
    assert res.returncode == 0, res.stderr[-2000:]

    # band-limited random input map at the pipeline nside
    mapfile = tmp_path / "inmap.hdf5"
    nside = 16
    with h5py.File(mapfile, "w") as f:
        rng = np.random.default_rng(0)
        f.create_dataset(
            "map", data=rng.standard_normal((1, 1, 12 * nside**2))
        )

    pfile = tmp_path / "pipe.yaml"
    pfile.write_text(
        PIPE_CONFIG.format(
            prod=prod, ts=tmp_path / "timestream", mapfile=mapfile
        )
    )
    res = _run_cli(
        "driftscan_tpu.scripts.runpipeline", ["run-config", str(pfile)]
    )
    assert res.returncode == 0, res.stderr[-2000:]

    tsdir = tmp_path / "timestream"
    assert (tsdir / "mmodes" / "COMPLETED_M").exists()
    with h5py.File(tsdir / "map_full.hdf5", "r") as f:
        m = f["map"][:]
    assert np.isfinite(m).all()
    assert np.abs(m).max() > 0
