"""On the card (skipped elsewhere): a short run of a cell through the
command line is correct, and the control at the cell's own size is not."""

import json
import subprocess
import sys

import pytest

from perfbench import control
from perfbench.registry import ROOT, Benchmark


@pytest.mark.card
def test_short_run_is_correct(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "carflag_dtqn.s1",
         "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.card
def test_control_at_full_size_is_not_correct(card):
    cell = Benchmark().cell("carflag_dtqn.s1")
    out = control.readings(cell, 2147483677, ["tf32"], "cuda")
    assert out["correct"], out["checks"]
    assert not out["controls"]["tf32"]["correct"], out["controls"]
