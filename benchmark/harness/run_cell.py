"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line."""
from __future__ import annotations

import gc
import importlib
import math
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import torch

from .check import checks, compare, lines, verdict
from .inputs import DTYPES, STEPS, derived_seed
from .spec import ROOT, load_cell, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "gpflowpilco_tpu")


class NoChip(RuntimeError):
    """The cell's cards are not there."""


class OffRoute(RuntimeError):
    """The window's steps did not run the kernels the cell's traffic names."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def merged(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def program_record(steps, names) -> dict:
    return dict(
        losses=[float(x) for x in steps.losses],
        costs=None if steps.first_costs is None else steps.first_costs.to(torch.float64),
        grad={k: g.to(torch.float64) for k, g in zip(names, steps.first_state)},
        change={k: (p - p0).to(torch.float64)
                for k, p, p0 in zip(names, steps.after_checked, steps.start)},
        change_first={k: (p - p0).to(torch.float64)
                      for k, p, p0 in zip(names, steps.after_first, steps.start)},
    )


def launch_counters(traffic: dict) -> List[dict]:
    """The program's launch-count dicts of the modules the traffic names."""
    return [importlib.import_module(m).launches for m in traffic["launches_per_step"]]


def check_route(traffic: dict, steps, summary: Optional[dict]) -> None:
    """Raise OffRoute unless every entry the traffic names ran once a window
    step, and, in a traced run, the trace holds each kernel it names."""
    want = [e for entries in traffic["launches_per_step"].values() for e in entries]
    got = {e: steps.launches_in_window.get(e, 0) for e in want}
    if any(n != steps.window_steps for n in got.values()):
        raise OffRoute(f"{steps.window_steps} window steps ran these entries {got} times")
    if summary is not None:
        missing = [k for k in traffic["traced_kernels"]
                   if k.split(".")[1] not in summary.get(k.split(".")[0], {})]
        if missing:
            raise OffRoute(f"the profiled slice holds no {', '.join(missing)} kernels")


def first_steps(variant, cfg: dict, traffic: dict, seed: int, device, seconds: float = 0.0,
                trace: bool = False, counters=()):
    """Set the cell up from ``seed`` and drive the update of ``variant``'s
    system through its warm-up steps and a window of ``seconds``: (inputs,
    step seed, the stepped window, record). With no window (``seconds`` 0),
    as for the readings of the limits, the warm-up is the checked steps
    alone."""
    from .window import StepWindow

    inputs = variant.make_inputs(cfg, seed, DTYPES[traffic["dtype"]], device)
    step_seed = derived_seed(seed, STEPS)
    system = variant.build_system(cfg, traffic, inputs, step_seed, device)
    steps = StepWindow(system, traffic["warmup_steps"], traffic["checked_steps"], seconds,
                       spans=variant.SPANS if trace else (), costs=variant.COSTS,
                       profile_steps=traffic["profiled_steps"] if trace else 0,
                       warmup_seconds=traffic["warmup_seconds"] if seconds else 0.0,
                       counters=counters)
    steps.run()
    return inputs, step_seed, steps, program_record(steps, system.names)


def kept_of(cell, cfg: dict, inputs: dict, step_seed: int, tau: Optional[float] = None):
    """The cell's kept particles (S,) from the reference and its twin alone
    (the variant's ``kept_particles``), or None where its limits do not name
    ``grad_gap_kept`` (and no ``tau`` is given)."""
    tau = cell.kept_tau if tau is None and "grad_gap_kept" in cell.limits else tau
    if tau is None:
        return None
    return cell.variant.kept_particles(cfg, cell.traffic, inputs, step_seed, tau)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device=None, require_cuda: bool = True, root=ROOT,
             overrides: Optional[dict] = None) -> Tuple[dict, List[str]]:
    """(result line, the compared numbers' lines)."""
    cell = load_cell(name, root)
    cfg = merged(cell.config, overrides)
    if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise NoChip(f"{name} needs {cell.chips} CUDA device(s); found "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device(device or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    counters = []
    if on_card:  # the CPU route runs no kernel and counts no launch
        from gpflowpilco_torch.ops import _build

        _build.build_all(cell.traffic["sources"])
        counters = launch_counters(cell.traffic)
    variant = cell.variant
    inputs, step_seed, steps, program = first_steps(variant, cfg, cell.traffic, seed, device, seconds,
                                                    trace, counters)
    setup_s = steps.window_open - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = {}
    if trace and steps.profiler is not None:
        from .trace import export_events, reduce
        from .window import UPDATE_SPAN

        summary = reduce(export_events(steps.profiler), cell.traffic["kernel_groups"],
                         (UPDATE_SPAN, *steps.spans))
    if on_card:
        check_route(cell.traffic, steps, summary if trace else None)
    kept = kept_of(cell, cfg, inputs, step_seed)
    if kept is not None:
        program["grad_kept"] = variant.kept_gradient(steps, step_seed, kept)
    window = dict(steps=steps.window_steps, seconds=steps.window_seconds,
                  intervals=steps.intervals(), after_return=steps.after_return())
    spans = steps.spans
    attempted = steps.window_steps
    failed = attempted - steps.applied_in_window
    del steps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    reference = variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept)
    numbers = compare(program, reference)
    correct = verdict(numbers, cell.limits)

    if trace:
        shapes = variant.dims(cfg)
        ctx = dict(dtype=cell.traffic["dtype"], dims=shapes, window=window, spans=spans,
                   trace=summary, step_ops=variant.step_ops(shapes))
        metrics: Dict[str, dict] = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"], root / "benchmark")(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        rate = window["steps"] / window["seconds"] if window["steps"] else 0.0
        values = dict(policy_steps_per_s=rate, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"]) for m in cell.end_to_end}
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(device) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    if trace and summary:
        dev.update(busy_s=summary["busy_s"], window_s=summary["slice_s"])
    result = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics,
                  device=dev)
    if trace and summary:
        result["breakdown"] = dict(device_ops=summary["device_ops"], idle_gaps=summary["idle_gaps"])
    result["card"] = card_line() if on_card else "cpu"
    result["checks"] = checks(numbers, cell.limits)
    return result, lines(numbers, cell.limits)
