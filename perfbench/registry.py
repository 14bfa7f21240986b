"""Finds everything a cell is made of by the names in ``BENCHMARK.json``:
its configuration (the ``file`` its entry names), its network family (the
modules the configuration names as its ``"reference"`` and ``"work"``),
its traffic (``perfbench/traffic/<traffic>.json``), its limits
(``perfbench/limits/<cell>.json``), each per-layer metric's reader
(``perfbench/metrics/<metric>.py``) and each group of kernel-name patterns
(every ``.txt`` under ``perfbench/kernels/<group>/``).  A new cell,
configuration, network, traffic mix, metric or pattern is a new file;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Family:
    """A configuration's network, from the files its configuration names:
    ``reference``, the plain network (``param_spec(cfg, env)``, ``Net(cfg,
    env, prec)``, ``TINY``: a CPU test's size), and ``work``, its counts
    (``iteration_flops`` and ``attention_applications``, each of ``(cfg,
    env, seeds, envs, batch, updates)``)."""

    reference: ModuleType
    work: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    family: Family
    traffic: dict
    limits: Dict[str, Optional[float]]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path``, imported once a process under a name
    made from its whole path (two checkouts' files of one name stay
    apart)."""
    path = Path(path).resolve()
    name = "perfbench_file_{}_{}".format(
        re.sub(r"[^0-9A-Za-z_]", "_", path.stem),
        hashlib.sha1(str(path).encode()).hexdigest()[:12])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None:
            raise FileNotFoundError(f"no Python module at {path}")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def family(cfg: dict, root: Path = ROOT) -> Family:
    """The network family ``cfg`` names, its paths taken from ``root``."""
    return Family(reference=load_module(Path(root) / cfg["reference"]),
                  work=load_module(Path(root) / cfg["work"]))


class Benchmark:
    """``BENCHMARK.json`` and the files it leads to, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "perfbench"
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell_names(self) -> List[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> Cell:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json: "
                           f"{sorted(work)}")
        w = work[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = load_json(self.root / configs[w["config"]]["file"])

        def applies(metric):
            return name in metric.get("workloads", [name])

        return Cell(
            name=name,
            chips=int(w["chips"]),
            config=config,
            family=family(config, self.root),
            traffic=load_json(self.dir / "traffic" / f"{w['traffic']}.json"),
            limits=load_json(self.dir / "limits" / f"{name}.json"),
            end_to_end=[m for m in self.spec["end_to_end"] if applies(m)],
            per_layer=[m for m in self.spec["per_layer"] if applies(m)],
        )

    def reader(self, metric: str) -> Callable:
        """``read(ctx)`` of ``perfbench/metrics/<metric>.py``."""
        return load_module(self.dir / "metrics" / f"{metric}.py").read

    def patterns(self, group: str) -> List[re.Pattern]:
        """The kernel-name patterns of ``group``: one regular expression a
        line, from every ``.txt`` file of ``perfbench/kernels/<group>/``;
        ``#`` starts a comment."""
        out = []
        for path in sorted((self.dir / "kernels" / group).glob("*.txt")):
            for line in path.read_text().splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(re.compile(line))
        return out
