"""What a run loads: the harness never the JAX package nor JAX, the
reference nothing of the program either.  Top-level module names (before
the first dot) are compared whole: ``dtqn_tpu_torch`` begins with
``dtqn_tpu`` and is not it."""

import json
import subprocess
import sys

import pytest

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

# One configuration's plain reference, at its first cell's tiny size: the
# network module its "reference" names with the shared learner, envs and
# replay, and the counts of the module its "work" names.
REFERENCE_RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from perfbench.harness import make_weights
from perfbench.reference.envs import make_env
from perfbench.reference.learner import ReferenceRun
from perfbench.reference.precision import Precision
cell = tiny_cell({cell!r})
cfg, env, fam = cell.config, make_env(cell.config["env"]), cell.family
w = make_weights(cfg, env, 1, 5, "cpu", fam.reference)
with Precision() as prec:
    r = ReferenceRun(cfg, fam.reference, [5], w, "cpu", prec)
    r.prepopulate()
    r.iteration(4)
fam.work.iteration_flops(cfg, env, 1, 4, 4, 4)
fam.work.attention_applications(cfg, env, 1, 4, 4, 4)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FIRST_CELLS = {c["name"]: next(w["name"] for w in SPEC["workloads"]
                               if w["config"] == c["name"])
               for c in SPEC["configs"]}


def top_level_modules(code: str, **names) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                          tests=str(ROOT / "perfbench" /
                                                    "tests"), **names)],
        capture_output=True, text=True, timeout=600, check=True,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_side():
    tops = top_level_modules(HARNESS_RUN)
    assert "dtqn_tpu_torch" in tops and "perfbench" in tops
    assert not tops & JAX_SIDE


@pytest.mark.parametrize("config", sorted(FIRST_CELLS))
def test_reference_loads_nothing_of_the_program(config):
    tops = top_level_modules(REFERENCE_RUN, cell=FIRST_CELLS[config])
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
