"""A run loads neither JAX nor the JAX package, and the command refuses to
run without a card or without the program (CPU only)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

B1, SERVE = "qwen2.5-7b.b1-ctx2048", "qwen2.5-7b.serve-16"


SUBPROCESS_RUN = """
import sys, json
sys.path[:0] = [{here!r}, {src!r}]
import run, pb_tiny
got = [pb_tiny.run(pb_tiny.cell(name))[0]["correct"] for name in {names!r}]
print(json.dumps({{"correct": got, "forbidden": run.forbidden_modules()}}))
"""
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def test_a_run_loads_no_jax():
    """A run of each cell (the port, the drivers, the reference) loads
    neither JAX nor the JAX package (top-level names compared whole:
    ``repro_torch`` starts with ``repro``)."""
    code = SUBPROCESS_RUN.format(here=str(HERE), src=str(ROOT / "src"),
                                 names=[B1, SERVE])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": [True, True], "forbidden": []}


def test_the_command_refuses_without_the_program_or_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal without a card is for machines without one")
    cmd = [sys.executable, "perfbench/run.py", "--workload", B1, "--seed",
           str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 3 and not res.stdout
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in ENV.items() if k != "PYTHONPATH"}
    res = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode != 0 and not res.stdout
    unknown = cmd[:3] + ["nope"] + cmd[4:]
    assert subprocess.run(unknown, cwd=ROOT, env=ENV, capture_output=True,
                          timeout=240).returncode == 2
