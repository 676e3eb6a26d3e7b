"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics. A cell's configuration is the file its
``configs`` entry names; its traffic mix is ``traffic/<traffic>.json`` and
its correctness limits ``workloads/<cell>.json`` (with ``kept_tau``, the
relative gap to the one-ulp twin that ``grad_gap_kept``'s particles keep),
both beside this package. The traffic mix names the PILCO variant it drives
(``system``, no default): ``systems/<system>.py``, whose contract
``systems/__init__.py`` states. A per-layer metric is read by
``metrics/<metric>.py``'s ``read``. Adding a cell, a configuration, a mix,
a variant or a metric adds files and entries and edits nothing here.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    variant: ModuleType  # systems/<traffic's system>.py
    limits: Dict[str, float]
    kept_tau: Optional[float]  # where the limits name grad_gap_kept
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def _module(path: Path, name: str) -> ModuleType:
    """The Python file ``path``, loaded as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _variant_at(path: Path) -> ModuleType:
    return _module(path, f"_benchmark_system_{path.stem}")


def variant_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``systems/<name>.py``, loaded once per file, so that every cell of a
    variant (and a test that patches it) shares one module."""
    return _variant_at((bench_dir / "systems" / f"{name}.py").resolve())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; raises KeyError for an
    unknown name or a traffic mix that names no system."""
    bench = load_benchmark(root)
    bench_dir = root / "benchmark"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{work['traffic']}.json").read_text())
    checks = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(work["chips"]), config=config, traffic=traffic,
                variant=variant_module(traffic["system"], bench_dir),
                limits=checks["limits"], kept_tau=checks.get("kept_tau"),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    return _module(bench_dir / "metrics" / f"{name}.py", f"_benchmark_metric_{name}").read
