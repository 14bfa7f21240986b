"""What a run loads: the harness never the JAX package nor JAX, the
reference nothing of the program either.  Top-level module names (before
the first dot) are compared whole: ``dtqn_tpu_torch`` begins with
``dtqn_tpu`` and is not it."""

import json
import subprocess
import sys

from perfbench import run
from perfbench.registry import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "dtqn_tpu"}

HARNESS_RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from perfbench import harness
from perfbench.registry import Benchmark
harness.run_cell(Benchmark(), tiny_cell("gv7x7_dtqn_bag25.s1"), 5, 0.0,
                 True, "cpu", 0.0)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE_RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from perfbench.harness import make_weights
from perfbench.reference.envs import make_env
from perfbench.reference.learner import ReferenceRun
from perfbench.reference.model import Precision
cell = tiny_cell("gv7x7_dtqn_bag25.s1")
w = make_weights(cell.config, make_env(cell.config["env"]), 1, 5, "cpu")
with Precision() as prec:
    r = ReferenceRun(cell.config, [5], w, "cpu", prec)
    r.prepopulate()
    r.iteration(4)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                          tests=str(ROOT / "perfbench" /
                                                    "tests"))],
        capture_output=True, text=True, timeout=600, check=True,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_side():
    tops = top_level_modules(HARNESS_RUN)
    assert "dtqn_tpu_torch" in tops and "perfbench" in tops
    assert not tops & JAX_SIDE


def test_reference_loads_nothing_of_the_program():
    tops = top_level_modules(REFERENCE_RUN)
    assert "perfbench" in tops
    assert not tops & (JAX_SIDE | {"dtqn_tpu_torch"})


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dtqn_tpu_torch.fake", object())
    assert "dtqn_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dtqn_tpu.fake", object())
    assert "dtqn_tpu" in run.loaded_forbidden()


def test_cli_refuses_without_a_card(tmp_path):
    """No CUDA: a non-zero exit and no result line (on a card this test has
    nothing to show)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "carflag_dtqn.s1", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
