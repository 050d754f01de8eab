"""
Resolution of a cell by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix; each lives in a file of its own, found by
name, and so do the model adapter, the entry that drives the traffic, and
the reader of every metric.

    configs:  the file ``BENCHMARK.json`` gives   (JSON: model, parameters, chain, limits)
    traffic:  port_bench/traffic/<traffic>.json  (JSON: entry, sizes, noise, samples)
    entry:    port_bench/entries/<entry>.py      (drives requests of that kind)
    model:    port_bench/models/<model>.py       (the program's calls for the model)
    reference: port_bench/reference/<model>.py   (the plain reference)
    metric:   port_bench/metrics/<name>.py       (``read(ctx)``: a number or None)

Adding a cell, configuration, traffic mix or metric adds files and entries;
no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    """a module from its file (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    spec: Dict
    config: Dict
    traffic: Dict
    root: Path
    bench_dir: Path
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: Dict) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric['name']}.py",
                           f"port_bench_metric_{metric['name'].replace('.', '_')}")

    def entry(self) -> ModuleType:
        return load_module(self.bench_dir / "entries" / f"{self.traffic['entry']}.py",
                           f"port_bench_entry_{self.traffic['entry']}")

    def model(self) -> ModuleType:
        return load_module(self.bench_dir / "models" / f"{self.config['model']}.py",
                           f"port_bench_model_{self.config['model']}")

    def reference(self) -> ModuleType:
        """``reference/<model>.py`` of this cell's folder, a module of the
        ``reference`` package (whose shared parts it imports relatively)."""
        model = self.config["model"]
        return load_module(self.bench_dir / "reference" / f"{model}.py", f"reference.{model}")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, root: Optional[Path] = None) -> Cell:
    """the cell ``cell_name`` of ``<root>/BENCHMARK.json`` with its files
    (the benchmark's folder is ``<root>/port_bench``)."""
    root = Path(root) if root is not None else ROOT
    bench_dir = root / BENCH_DIR.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json (have {sorted(cells)})")
    spec = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[spec["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{spec['traffic']}.json").read_text())
    return Cell(name=cell_name, spec=spec, config=config, traffic=traffic, root=root,
                bench_dir=bench_dir,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell_name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, cell_name)])
