"""Loads the tasks' example modules under names of their own: every task has
an ``experiment.py`` (the JAX harness) and a ``run_torch.py`` (the port's),
so a bare import would return whichever module the process imported first."""
from __future__ import annotations

import importlib.util
import pathlib
import sys

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load_example(task: str, module: str = "run_torch"):
    """examples/<task>/<module>.py as the module ``<task>_<module>``."""
    name = f"{task}_{module}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, EXAMPLES / task / f"{module}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]
