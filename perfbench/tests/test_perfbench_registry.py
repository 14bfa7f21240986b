"""Discovery by name, where adding a configuration, a network family, a
cell, a traffic mix, a per-layer metric or a kernel-name pattern is adding
a file; the benchmark file's shape; the result line's schema; the window
arithmetic on a fake clock."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.program import Program
from perfbench.reference.envs import make_env
from perfbench.registry import ROOT, Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def copy(tmp_path):
    """BENCHMARK.json and the benchmark's folder, copied."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    return tmp_path


def test_every_cell_loads():
    bench = Benchmark()
    for name in bench.cell_names():
        cell = bench.cell(name)
        assert cell.limits and cell.end_to_end and cell.per_layer
        for m in cell.per_layer:
            assert callable(bench.reader(m["name"]))


def test_new_files_are_found_by_name(copy):
    d = copy / "perfbench"
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = json.loads((d / "configs" / "carflag_dtqn.json").read_text())
    (d / "configs" / "carflag_small_batch.json").write_text(
        json.dumps(dict(cfg, batch_size=16)))
    (d / "traffic" / "s2.json").write_text(json.dumps(
        {"seeds": 2, "iters_per_chunk": 10, "updates_per_env_step": 1}))
    (d / "limits" / "carflag_small_batch.s2.json").write_text("{}")
    (d / "metrics" / "chunks_traced.py").write_text(
        "def read(ctx):\n    return ctx.iters_traced / 10\n")
    (d / "kernels" / "attention" / "fused.txt").write_text(
        "# a fused pair\nfused_dtqn_attention\n")
    spec["configs"].append({"name": "carflag_small_batch",
                            "source": "https://example.org/x",
                            "file": "perfbench/configs/"
                                    "carflag_small_batch.json",
                            "reduced": ["batch_size"], "why": "a test"})
    spec["workloads"].append({"name": "carflag_small_batch.s2",
                              "config": "carflag_small_batch",
                              "traffic": "s2", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "chunks_traced", "unit": "chunks",
                              "better": "higher", "source": "program_counter",
                              "layer": "train loop", "moves":
                                  "env_steps_per_s",
                              "workloads": ["carflag_small_batch.s2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(copy)
    cell = bench.cell("carflag_small_batch.s2")
    assert cell.config["batch_size"] == 16 and cell.traffic["seeds"] == 2
    assert "chunks_traced" in [m["name"] for m in cell.per_layer]
    assert "chunks_traced" not in [
        m["name"] for m in bench.cell("carflag_dtqn.s1").per_layer]
    assert bench.reader("chunks_traced")(
        type("Ctx", (), {"iters_traced": 20})()) == 2
    assert any(p.search("fused_dtqn_attention_fwd")
               for p in bench.patterns("attention"))
    assert any(p.search("void (anonymous namespace)::attention_fwd_kernel"
                        "<float, 8, 2>(float const*)")
               for p in bench.patterns("attention"))


# The harness's own modules: none may name a network family.
HARNESS = ["harness.py", "program.py", "compare.py", "control.py", "run.py",
           "trace.py", "registry.py", "flops.py", "reference/learner.py",
           "reference/envs.py", "reference/replay.py",
           "reference/precision.py"]


def family_names(spec: dict) -> set:
    """Each configuration's network and work modules, as a path and as an
    import would name them."""
    out = set()
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in ("reference", "work"):
            stem = cfg[key].removesuffix(".py")
            out |= {stem, stem.replace("/", "."),
                    "import " + stem.rsplit("/", 1)[-1]}
    return out


def test_harness_names_no_family():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = family_names(spec)
    sources = [ROOT / "perfbench" / m for m in HARNESS]
    sources += sorted((ROOT / "perfbench" / "metrics").glob("*.py"))
    for path in sources:
        text = path.read_text()
        assert not [n for n in names if n in text], path
        if path.parent.name != "reference":
            assert "DTQN" not in text, path


def test_a_second_network_family_is_files_alone(copy, tiny):
    """A configuration whose network and counts are copies of DTQN's under
    a new name, with a ``"network"`` field set to AgentConfig's own value:
    found, run and judged from its files alone, reading what
    ``carflag_dtqn.s1`` reads."""
    d = copy / "perfbench"
    (d / "reference" / "twin_net.py").write_text(
        (d / "reference" / "model.py").read_text())
    (d / "work" / "twin_net.py").write_text(
        (d / "work" / "dtqn.py").read_text())
    cfg = json.loads((d / "configs" / "carflag_dtqn.json").read_text())
    cfg.update(reference="perfbench/reference/twin_net.py",
               work="perfbench/work/twin_net.py", network={"gate": "res"})
    (d / "configs" / "carflag_twin_net.json").write_text(json.dumps(cfg))
    shutil.copy(d / "limits" / "carflag_dtqn.s1.json",
                d / "limits" / "carflag_twin_net.s1.json")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "carflag_twin_net",
                            "source": "https://example.org/x",
                            "file": "perfbench/configs/carflag_twin_net.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "carflag_twin_net.s1",
                              "config": "carflag_twin_net", "traffic": "s1",
                              "chips": 1, "why": "a test"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(copy)
    twin = tiny("carflag_twin_net.s1", bench=bench)
    assert Path(twin.family.reference.__file__) == \
        (d / "reference" / "twin_net.py").resolve()
    assert Path(twin.family.work.__file__) == \
        (d / "work" / "twin_net.py").resolve()
    assert twin.config["network"] == {"gate": "res"}
    seed = 2**31 + 29
    res = harness.run_cell(bench, twin, seed, 0.0, False, "cpu", 0.0)
    base = harness.run_cell(Benchmark(), tiny("carflag_dtqn.s1"), seed, 0.0,
                            False, "cpu", 0.0)
    assert res.correct, res.checks
    assert res.checks == base.checks
    assert (res.attempted, res.failed) == (base.attempted, base.failed)
    # The counts the per-layer readers take, at the cell's full size.
    full, dtqn = Benchmark(copy).cell("carflag_twin_net.s1"), \
        Benchmark().cell("carflag_dtqn.s1")
    env = make_env(cfg["env"])
    for count in ("iteration_flops", "attention_applications"):
        assert getattr(full.family.work, count)(
            full.config, env, 1, 64, 32, 64) == getattr(
            dtqn.family.work, count)(dtqn.config, env, 1, 64, 32, 64)
    for m in HARNESS:
        assert "twin_net" not in (ROOT / "perfbench" / m).read_text(), m


def test_unknown_network_field_raises_before_anything_is_built(tiny):
    cell = tiny("carflag_dtqn.s1")
    # An env no registry has: building anything before the check would
    # raise another error.
    cfg = dict(cell.config, env="no-such-env",
               network={"gate": "res", "flux_capacitor": 1})
    with pytest.raises(ValueError, match="flux_capacitor"):
        Program(cfg, cell.traffic, [1], "cpu")


def test_benchmark_file_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        layers.add(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    pairs = set()
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(json.dumps(spec)) < 64 * 1024


def test_result_line_schema(tiny):
    cell = tiny("carflag_dtqn.s1")
    for trace in (False, True):
        res = harness.run_cell(Benchmark(), cell, 99, 0.0, trace, "cpu", 0.0)
        line = json.loads(json.dumps(res.line()))
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "checks"
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        names = set(line["metrics"])
        if trace:
            assert names <= {m["name"] for m in cell.per_layer}
        else:
            assert names == {"env_steps_per_s", "setup_s"}


def test_window_on_a_fake_clock():
    now = [100.0]

    def clock():
        return now[0]

    def chunk():
        now[0] += 0.25  # launch

    def sync():
        now[0] += 0.05  # the rest of the chunk

    chunks, window, launches, chunk_s = harness.measure_window(
        chunk, sync, 1.0, clock)
    # 0.3 s a chunk: the fourth ends past one second, at 1.2 s.
    assert chunks == 4
    assert window == pytest.approx(1.2)
    assert launches == pytest.approx([0.25] * 4)
    assert chunk_s == pytest.approx([0.3] * 4)
