"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``portbench/configs/<config>.json`` (its ``file``);
- a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the general generator that reads it,
  ``portbench/traffic/<kind>.py``;
- a per-layer metric: ``portbench/metrics/<name>.py``, whose
  ``read(ctx)`` returns the number or None where it finds nothing to read;
  a name with a suffix (``glue_pct.train``) that has no file of its own is
  read by the file of its base name (``glue_pct.py``).

A later cell, configuration or metric is added as files and entries; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[Dict]:
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in moves)]

    def kind(self, kind: str) -> ModuleType:
        return load_module(self.bench_dir / "traffic" / f"{kind}.py", f"portbench_kind_{kind}")

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        metrics = self.bench_dir / "metrics"
        path = metrics / f"{metric}.py"
        if not path.is_file():
            path = metrics / f"{metric.split('.', 1)[0]}.py"
        return load_module(path, "portbench_metric_" + path.stem.replace(".", "_")).read


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
