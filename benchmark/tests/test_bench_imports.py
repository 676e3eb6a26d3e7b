"""Nothing the benchmark runs imports JAX, Flax or the JAX package (whole
top-level names), the reference and the counts import nothing of the port,
and a run without the card or without the port prints no result."""
import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import run_cell
from benchmark.harness.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gpflowpilco_tpu"}


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path


@pytest.mark.parametrize("part", ["reference", "counts", "metrics"])
def test_yardstick_imports_nothing_of_the_port(part):
    for path in (BENCH_DIR / part).rglob("*.py"):
        assert "gpflowpilco_torch" not in _top_level_imports(path), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    monkeypatch.setitem(sys.modules, "gpflowpilco_tpu_extra", sys)
    assert run_cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run_cell.forbidden_modules() == ["jax"]


def _run(cwd):
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = _run(ROOT)
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA device(s); found 0" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """Without the port the run stops at the look for the card (here) or at
    the port's import (on a machine with a card)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert ("CUDA device(s); found 0" in proc.stderr
            or "No module named 'gpflowpilco_torch'" in proc.stderr), proc.stderr[-2000:]
