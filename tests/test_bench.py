"""bench.py must run end-to-end and print its one-line JSON contract.

This guards the harness itself (small scale, CPU backend, subprocess);
the numbers it prints here are CPU numbers and name the CPU as their
device."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_small_scale_json_contract(tmp_path):
    env = os.environ.copy()
    env["BENCH_SCALE"] = "small"
    env["BENCH_RECORD_PATH"] = str(tmp_path / "bench_record.json")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');"
        "import runpy, sys; sys.argv=['bench.py'];"
        f"runpy.run_path({os.path.join(REPO, 'bench.py')!r}, run_name='__main__')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=500,
    )
    assert res.returncode == 0, res.stderr[-2000:]

    line = res.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    assert set(out) >= {"metric", "value", "unit", "detail"}
    assert "vs_baseline" not in out
    assert out["value"] > 0
    assert out["unit"] == "m-modes/s"
    detail = out["detail"]
    assert "t_btm_s" in detail and "t_product_s" in detail
    # every record names the device it ran on
    assert detail["platform"] == "cpu"
    assert detail["kind"] and detail["count"] >= 1
    assert "product_mfu_pct" not in detail
    with open(tmp_path / "bench_record.json") as f:
        assert json.load(f) == out
