#!/usr/bin/env python3
"""What the span store (gpflowpilco_torch/utils/tracing.py) costs a policy
step on this host, with no profiler active and under torch.profiler.

    python scripts/tracing_cost.py [--workload cartpole-k6-f64] [--seed N] [--steps 20]
                                   [--replays 20000] [--device cuda:0]

Runs ``--steps`` Adam steps of the benchmark cell's update and takes the
last step record's span tree. That tree is replayed with no work inside, as
straight-line code through what the step itself uses: a ``tracing.step``,
``with tracing.span``, functions decorated with ``tracing.span`` where the
port decorates (``DECORATED``) and ``tracing.host_sync`` on a CPU flag for
each ``sync.*`` span, whose ``bool()`` is timed alone and taken off: the
parent pays the read too. Each figure is the median over five rounds of
``--replays`` replays (a tenth of them under the profiler, CPU and CUDA
activities), and the same replay through empty context managers, which
says how fast the host runs such code. Prints one JSON line: microseconds a
step for each, the spans, the host syncs and the card.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECORATED = ("paths.draw", "paths.condition", "kuu.factor", "rollout.operands")


def replay_source(record) -> str:
    """Python source of ``replay()``: the record's span tree, nothing inside."""
    kids = {i: [] for i in range(-1, len(record.spans))}
    for i, s in enumerate(record.spans):
        kids[s.parent].append(i)
    defs = []

    def body(i, depth):
        lines = [line for c in kids[i] for line in node(c, depth)]
        return lines or ["    " * depth + "pass"]

    def node(i, depth):
        name, pad = record.spans[i].name, "    " * depth
        if name.startswith("sync."):
            return [f"{pad}host_sync({name[len('sync.'):]!r}, flag)"]
        if name in DECORATED:
            defs.extend([f"@span({name!r})", f"def _f{i}():", *body(i, 1), ""])
            return [f"{pad}_f{i}()"]
        return [f"{pad}with span({name!r}):", *body(i, depth + 1)]

    main = [f"_iteration = step({record.spans[0].name!r})", "def replay():", "    with _iteration:",
            *body(0, 2)]
    return "\n".join(defs + main) + "\n"


def per_call_us(fn, calls: int, rounds: int = 5) -> float:
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        times.append(1e-3 * (time.perf_counter_ns() - t0) / calls)
    return statistics.median(times)


class _Empty:
    """A context manager and decorator that does nothing."""

    def __init__(self, *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return fn


def cost(record, replays: int) -> dict:
    """Microseconds a step of the record's spans: profiler off and on, and
    the same code through empty context managers (the host's speed)."""
    import torch

    from gpflowpilco_torch.utils import tracing

    flag = torch.tensor(True)
    source = replay_source(record)
    scope = dict(span=tracing.span, step=tracing.step, host_sync=tracing.host_sync, flag=flag)
    empty = dict(span=_Empty, step=_Empty, host_sync=lambda site, flag: bool(flag), flag=flag)
    exec(source, scope)
    exec(source, empty)
    replay = scope["replay"]
    syncs = sum(s.name.startswith("sync.") for s in record.spans)
    read_us = per_call_us(lambda: bool(flag), replays)
    replay()  # the names are interned
    off = per_call_us(replay, replays) - syncs * read_us
    floor = per_call_us(empty["replay"], replays) - syncs * read_us
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities):
        on = per_call_us(replay, max(replays // 10, 1)) - syncs * read_us
    return dict(spans=[s.name for s in record.spans], host_syncs=record.host_syncs, read_us=read_us,
                profiler_off_us=off, profiler_on_us=on, empty_us=floor)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="cartpole-k6-f64")
    p.add_argument("--seed", type=int, default=2**33 + 17)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--replays", type=int, default=20000)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.inputs import make_inputs
    from benchmark.harness.run_cell import DTYPES
    from benchmark.harness.spec import load_cell
    from benchmark.harness.system import build_system
    from gpflowpilco_torch.ops import _build
    from gpflowpilco_torch.utils import tracing
    from gpflowpilco_torch.utils.optimizers import adam_minimize

    cell, device = load_cell(args.workload), torch.device(args.device)
    if device.type == "cuda":
        _build.build_all(cell.traffic["sources"])
    inputs = make_inputs(cell.config, args.seed, DTYPES[cell.traffic["dtype"]], device)
    system = build_system(cell.config, cell.traffic, inputs, args.seed, device)
    adam_minimize(system.loss, system.params, num_steps=args.steps, schedule=system.schedule,
                  global_clipnorm=cell.config["global_clipnorm"])
    out = cost(tracing.steps()[-1], args.replays)
    if device.type == "cuda":
        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
