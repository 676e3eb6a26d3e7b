"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``gpflowpilco_torch``).
The cell, its configuration, traffic mix, limits and metric readers are
found by name from ``BENCHMARK.json`` (``harness/spec.py``). The run needs
the cell's CUDA cards and exits non-zero, printing no result, without them,
when the window's steps did not run the kernels the cell's traffic names,
or when JAX, Flax or the JAX package is loaded once the window has closed.
The compared numbers and their limits end standard error and the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(obj):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    # every cache the run may fill lives at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(2)  # the host runs dispatch, not arithmetic: few threads, steadier runs
    from benchmark.harness.run_cell import NoChip, OffRoute, forbidden_modules, run_cell

    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    except NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except OffRoute as e:
        print(f"benchmark: off the cell's route: {e}; no result", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for line in checks:
        print(line, file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
