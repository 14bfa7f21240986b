"""The port's sweep-continuation tool (``dtqn_tpu_torch/sweep_checkpoint.py``,
the JAX package's ``tools/seed_sweep_checkpoint.py``) and the flagless
bench line's variants (``dtqn_tpu_torch/bench.py``'s ``"extra"``).

- the tool, as ``tests/test_sweep_continuation.py``: a 2-seed sweep run to
  completion, its stacked checkpoint removed, rebuilt from the per-seed
  policies, and resumed past the old budget;
- the bench's variants run as processes of their own (``subprocess.Popen``
  replaced here: no real bench process runs in the suite): their command
  lines carry ``--no-extras`` and the device, a failing or stalled child
  reports an error string, and ``--no-extras`` runs none;
- ``python -m dtqn_tpu_torch.compare_curves``: two results CSVs' means by
  window of env steps and over their last rows.
"""

import io
import os
import sys

import pytest
import torch

from dtqn_tpu_torch import bench, compare_curves, sweep_checkpoint
from dtqn_tpu_torch.config import get_args
from dtqn_tpu_torch.train.sweep import run_sweep, sweep_path
from dtqn_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BASE = ["--envs", "DiscreteCarFlag-v0", "--in-embed", "8", "--heads", "2",
        "--layers", "1", "--context", "8", "--history", "8", "--num-envs",
        "4", "--batch", "4", "--buf-size", "2000", "--prepop-steps", "200",
        "--eval-frequency", "16", "--eval-episodes", "1",
        "--max-episode-steps", "20", "--updates-per-iter", "1",
        "--save-policy", "--project-name", "cont", "--device", "cpu"]


def test_continuation_resumes_past_original_budget(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    seeds = [1, 2]
    cfg = get_args([*BASE, "--num-steps", "32"])
    run_sweep(cfg, seeds)
    # The stacked checkpoint missing (a stall, or code that saved only the
    # per-seed policies).
    ck = sweep_path(cfg, seeds)
    for suffix in ("_checkpoint.pt", "_mini_checkpoint.json"):
        os.remove(ck + suffix)
    assert not ckpt.has_checkpoint(ck)

    assert sweep_checkpoint.main([*BASE, "--seeds", "1", "2", "--at-step",
                                  "32", "--restart-epsilon", "0.1"]) == ck
    assert ckpt.load_mini_checkpoint(ck) == {"step": 32, "wandb_id": None}
    payload = torch.load(ck + "_checkpoint.pt", weights_only=True)
    assert payload["env_steps"].tolist() == [32, 32]
    assert payload["train_steps"].tolist() == [32, 32]
    assert payload["epsilon"].tolist() == pytest.approx([0.1, 0.1])
    # Each seed's saved policy in both its parameters and its target.
    for i, s in enumerate(seeds):
        weights = torch.load(get_args([*BASE, "--seed", str(s)]).policy_path()
                             + "_policy.pt", weights_only=True)
        flat = torch.cat([w.reshape(-1) for w in weights.values()])
        assert torch.equal(payload["params"][i], flat)
        assert torch.equal(payload["target_params"][i], flat)
    # Flushed episodes in every seed's ring: the resumed sweep can sample.
    assert min(payload["buffer.flushed_total"].tolist()) > 4

    out = run_sweep(get_args([*BASE, "--num-steps", "64"]), seeds)
    assert "Resumed sweep at 32 steps." in capsys.readouterr().out
    assert ckpt.load_mini_checkpoint(ck)["step"] >= 64
    assert set(out) == set(seeds)


def test_continuation_needs_several_seeds(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="more than one seed"):
        sweep_checkpoint.main([*BASE, "--seeds", "1", "--at-step", "8"])


# ------------------------------------------------------------ bench extras
class FakeChild:
    """A ``subprocess.Popen`` stand-in: prints ``out`` and exits with
    ``code``, or (``code`` None) runs until it is terminated."""

    def __init__(self, out, code):
        self.stdout = io.StringIO(out)
        self.returncode = code
        self.terminated = False

    def poll(self):
        return self.returncode

    def terminate(self):
        self.terminated = True
        self.returncode = -15


def fake_popen(monkeypatch, children):
    """Replaces ``Popen`` in the bench: each call takes the next of
    ``children`` (a FakeChild); returns the list of (argv, cwd) calls."""
    calls = []

    def popen(cmd, **kwargs):
        calls.append((cmd, kwargs.get("cwd")))
        return children.pop(0)

    monkeypatch.setattr(bench.subprocess, "Popen", popen)
    return calls


def fake_line(args):
    return {"metric": "m", "value": 1.0, "device": "cpu"}


def test_flagless_bench_runs_its_variants(monkeypatch, capsys):
    monkeypatch.setattr(bench, "measure", fake_line)
    calls = fake_popen(monkeypatch, [
        FakeChild("GPU line\n" + '{"metric": "x", "value": 250.5}\n', 0),
        FakeChild("", 1),
    ])
    line = bench.main(["--device", "cpu"])
    assert line["extra"] == {"aggregate_5seeds": 250.5,
                             "bf16": "error: exit code 1"}
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and bench.json.loads(printed[0]) == line
    module = [sys.executable, "-m", "dtqn_tpu_torch.bench"]
    tail = ["--no-extras", "--device", "cpu"]
    assert [cmd for cmd, _ in calls] == [
        module + ["--seeds", "5"] + tail, module + ["--bf16"] + tail]
    # The children import the package from the checkout's root.
    assert {cwd for _, cwd in calls} == {bench.REPO_ROOT}
    assert os.path.isdir(os.path.join(bench.REPO_ROOT, "dtqn_tpu_torch"))


@pytest.mark.parametrize("argv", [["--no-extras"], ["--iters", "1"],
                                  ["--bf16"]])
def test_bench_with_flags_runs_no_variant(argv, monkeypatch, capsys):
    monkeypatch.setattr(bench, "measure", fake_line)
    fake_popen(monkeypatch, [])  # a Popen call would pop from nothing
    line = bench.main(["--device", "cpu", *argv])
    assert "extra" not in line
    assert bench.json.loads(capsys.readouterr().out) == line


def test_stalled_variant_is_terminated_never_killed(monkeypatch):
    child = FakeChild("", None)
    fake_popen(monkeypatch, [child])
    out = bench._run_extra(["child"], soft_deadline_s=0.0)
    assert child.terminated
    assert out == "error: soft-timeout (child SIGTERMed after deadline)"


def results_csv(path, env, rows):
    """A results CSV as ``utils/logging.py`` writes it: (step, return,
    length, success) per evaluation."""
    lines = [f"Hours,Step,{env}/SuccessRate,{env}/EpisodeLength,"
             f"{env}/Return"]
    lines += [f"0.1,{step},{sr},{length},{ret}"
              for step, ret, length, sr in rows]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_compare_curves_means_by_window_and_last_rows(tmp_path, capsys):
    run = results_csv(tmp_path / "run.csv", "Memory-5-v0", [
        (100, -40.0, 50.0, 0.0), (200, -30.0, 40.0, 1.0),
        (300, -20.0, 30.0, 1.0)])
    ref = results_csv(tmp_path / "ref.csv", "Memory-5-v0", [
        (150, -44.0, 50.0, 0.0), (250, -26.0, 36.0, 1.0),
        (350, -10.0, 20.0, 1.0), (450, 0.0, 10.0, 1.0)])
    out = compare_curves.main([run, ref, "--window", "200", "--last", "2"])
    labels = [label for label, _, _ in out]
    assert labels == ["(0, 200]", "(200, 300]", "last 2 up to 300"]
    (_, run_a, ref_a), (_, run_b, ref_b), (_, run_last, ref_last) = out
    assert run_a == {"rows": 2, "Return": -35.0, "EpisodeLength": 45.0,
                     "SuccessRate": 0.5}
    assert ref_a == {"rows": 1, "Return": -44.0, "EpisodeLength": 50.0,
                     "SuccessRate": 0.0}
    assert run_b["rows"] == 1 and ref_b["Return"] == -26.0
    assert run_last["Return"] == -25.0 and ref_last["Return"] == -35.0
    assert len(capsys.readouterr().out.splitlines()) == 3


def test_compare_curves_refuses_an_empty_file(tmp_path):
    empty = results_csv(tmp_path / "empty.csv", "Memory-5-v0", [])
    with pytest.raises(ValueError, match="no evaluation"):
        compare_curves.load(empty)
