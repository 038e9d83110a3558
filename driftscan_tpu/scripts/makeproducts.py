#!/usr/bin/env python
"""drift-makeproducts: generate analysis products from a YAML config.

Functional parity with the reference's drift/scripts/makeproducts.py
(`run`, `interactive`, `queue`); `queue` writes a PBS or Slurm job
script.  Each job runs one process per node holding all of that node's
GPUs (or binds one GPU per rank); a JAX process reserves most of a
card's memory, so two processes never share one card.
"""

import logging
import math
import os

import click

products = None

_QUEUE_SYSTEMS = ["pbs", "slurm"]


@click.group()
def cli():
    """Generate products for modelling and analysing driftscan telescopes."""


@cli.command()
@click.argument(
    "configfile",
    type=click.Path(exists=True, dir_okay=False, readable=True, resolve_path=True),
)
@click.option(
    "--profile",
    is_flag=True,
    default=False,
    help="Profile the run; writes a profile_<rank>.prof per process.",
)
@click.option(
    "--profiler",
    type=click.Choice(["cProfile", "pyinstrument", "jax"], case_sensitive=False),
    default="cProfile",
    help="Which profiler to use ('jax' writes an XLA device trace).",
)
def run(configfile, profile, profiler):
    """Immediately run the CONFIGFILE to generate products."""
    from ..core import manager
    from ..parallel import comm

    filt = comm.MPILogFilter(level_all=logging.INFO, level_rank0=logging.INFO)

    size = comm.size()
    rank_length = int(math.log10(size)) + 1 if size > 1 else 1
    mpi_fmt = f"[MPI %(mpi_rank){rank_length}d/%(mpi_size){rank_length}d]"
    formatter = logging.Formatter(
        "%(asctime)s " + mpi_fmt + " - %(levelname)-8s %(name)s: %(message)s"
    )

    root_logger = logging.getLogger()
    root_logger.setLevel(level=logging.DEBUG)
    ch = logging.StreamHandler()
    ch.addFilter(filt)
    ch.setFormatter(formatter)
    root_logger.addHandler(ch)

    prof = None
    jax_trace_dir = None
    if profile:
        if profiler.lower() == "jax":
            # XLA device trace, viewable in TensorBoard / Perfetto
            # (replaces the reference's host-only cProfile view of the
            # accelerator phases, drift/scripts/makeproducts.py:42-56).
            import jax as _jax

            jax_trace_dir = f"jax_trace_{comm.rank()}"
            _jax.profiler.start_trace(jax_trace_dir)
        elif profiler.lower() == "cprofile":
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        else:  # pragma: no cover - pyinstrument not a required dep
            try:
                from pyinstrument import Profiler as PyProfiler

                prof = PyProfiler()
                prof.start()
            except ImportError:
                logging.warning("pyinstrument not available; profiling disabled")
                prof = None

    m = manager.ProductManager.from_config(configfile)
    m.generate()

    if jax_trace_dir is not None:
        import jax as _jax

        _jax.profiler.stop_trace()
        logging.info("jax trace written to %s", jax_trace_dir)

    if prof is not None:
        if profiler.lower() == "cprofile":
            prof.disable()
            prof.dump_stats(f"profile_{comm.rank()}.prof")
        else:  # pragma: no cover
            prof.stop()
            with open(f"profile_{comm.rank()}.txt", "w") as fh:
                fh.write(prof.output_text())


@cli.command()
@click.argument(
    "configfile",
    type=click.Path(exists=True, dir_okay=False, readable=True, resolve_path=True),
)
def interactive(configfile):
    """Load the config but do not generate; exposes `products` globally.

    Use: ipython -i $(which drift-makeproducts) interactive config.yaml
    """
    from ..core import manager

    global products
    products = manager.ProductManager.from_config(configfile)
    print("*** Access analysis products through the global variable `products` ***")


# --- job script templates ---

pbs_script = """#!/bin/bash
#PBS -l nodes=%(nodes)i:ppn=%(ppn)i
#PBS -q %(queue)s
#PBS -r n
#PBS -m abe
#PBS -V
#PBS -l walltime=%(time)s
#PBS -N %(name)s
source %(venv)s
cd %(workdir)s
export OMP_NUM_THREADS=%(ompnum)i
python -m driftscan_tpu.scripts.makeproducts run %(configpath)s &> %(logpath)s
"""

slurm_script = """#!/bin/bash
#SBATCH --account=%(account)s
#SBATCH --nodes=%(nodes)i
#SBATCH --ntasks-per-node=%(pernode)i
#SBATCH --cpus-per-task=%(ompnum)i
#SBATCH --mem=%(mem)s
#SBATCH --time=%(time)s
#SBATCH --job-name=%(name)s

source %(venv)s
cd %(workdir)s

export OMP_NUM_THREADS=$SLURM_CPUS_PER_TASK

srun python -m driftscan_tpu.scripts.makeproducts run %(configpath)s &> %(logpath)s
"""

script_templates = {"pbs": pbs_script, "slurm": slurm_script}


@cli.command()
@click.argument(
    "configfile",
    type=click.Path(exists=True, dir_okay=False, readable=True, resolve_path=True),
)
@click.option(
    "--submit/--nosubmit", default=True, help="Submit the job to the queue (or not)"
)
def queue(configfile, submit):
    """Write (and optionally submit) a batch job running CONFIGFILE."""
    import shutil

    import yaml

    with open(configfile, "r") as f:
        yconf = yaml.safe_load(f)

    if "config" not in yconf:
        raise Exception("Configuration file must have an 'config' section.")
    conf = yconf["config"]

    outdir = (
        conf["output_directory"]
        if "output_directory" in conf
        else conf["timestream_directory"]
    )
    outdir = os.path.normpath(os.path.expandvars(os.path.expanduser(outdir)))
    if not os.path.isabs(outdir):
        raise Exception("Output directory path must be absolute.")

    queue_sys = conf.get("queue_sys", "slurm")
    if queue_sys not in script_templates and "script_template" not in conf:
        raise Exception("Need to specify submit script for unknown scheduler.")

    submitdir = os.path.normpath(outdir + "/" + queue_sys + "/")
    if not os.path.exists(submitdir):
        os.makedirs(submitdir)

    sfile = os.path.realpath(os.path.abspath(configfile))
    dfile = os.path.realpath(os.path.abspath(submitdir + "/config.yaml"))
    if sfile != dfile:
        shutil.copy(sfile, dfile)

    clusterconf = {
        "queue_sys": queue_sys,
        "nodes": conf.get("nodes", 1),
        "time": conf.get("time", "1:00:00"),
        "ppn": conf.get("ppn", 8),
        "mem": conf.get("mem", "0"),
        "account": conf.get("account", ""),
        "ompnum": conf.get("ompnum", 8),
        "queue": conf.get("queue", "batch"),
        "pernode": conf.get("pernode", 1),
        "name": conf.get("name", "job"),
        "workdir": outdir,
        "logpath": submitdir + "/jobout.log",
        "configpath": submitdir + "/config.yaml",
        "venv": conf.get("venv", "/dev/null"),
    }
    clusterconf["mpiproc"] = clusterconf["nodes"] * clusterconf["pernode"]

    template = conf.get("script_template", script_templates.get(queue_sys))
    script = template % clusterconf

    scriptname = submitdir + "/jobscript.sh"
    with open(scriptname, "w") as f:
        f.write(script)

    submit_commands = {"pbs": "qsub", "slurm": "sbatch"}
    submit_command = conf.get(
        "submit_command", submit_commands.get(queue_sys, "bash")
    )

    if submit:
        os.system("cd %s; %s jobscript.sh" % (submitdir, submit_command))


if __name__ == "__main__":
    cli()
