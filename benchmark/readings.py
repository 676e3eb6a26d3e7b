"""The readings a cell's correctness limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--twin-seeds ...] \
        [--witness-seeds ...] [--taus ...] [--out FILE]

For each of ``--seeds`` the program runs the cell's set-up and checked
steps (no window) and is compared with the float64 reference: the lower
readings; a ``twin`` line beside it gives the share of particles each gap
from 1e-2 to 1e-15 would keep. For each of ``--control-seeds`` the
reference computed in the precision below the cell's takes the program's
place (the control), and for each of ``--fault-seeds`` three faults do: the
reference with half of the particles left out of the mean, the reference
with its last transition cut out of the backward (``detach_last``, the
forward unchanged), and the program with every Adam step returning its
state unchanged. Where the cell's limits name ``grad_gap_kept``, or at each
of ``--taus``, every reading also carries the kept particles' gradient (the
program's through ``run_cell.kept_gradient``). For each of ``--twin-seeds``
the reference with every step's initial states moved by one unit in the
last place takes the program's place (``ref_twin``): how far the reference
departs from itself under chaos. For each of ``--witness-seeds`` the first
step's rollout is read particle by particle at several horizons, on the
step's own paths and initial states: through K6, through the port's plain
PyTorch rollout, through the reference, and through the reference and K6
with the initial states moved by one unit in the last place (the rollout's
own sensitivity to rounding). Each reading is one JSON line (also written
to ``--out``). The benchmark's own runs never run this.

The faults of the reference, its twin, the kept particles and the witness
are the cell's variant's (``systems/<system>.py``: ``FAULTS``, ``TWIN``,
``twin_gaps``, ``kept_gradient``, ``witness``); the pathwise variant's are
the ones above. The unchanged step is the port's optimizer's, whatever the
variant.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--twin-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--taus", type=float, nargs="*", default=[],
                   help="kept particles' gaps to read grad_gap_kept at (default: the cell's kept_tau)")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.check import compare
    from benchmark.harness.inputs import DTYPES, STEPS, derived_seed
    from benchmark.harness.run_cell import first_steps, kept_of
    from benchmark.harness.spec import load_cell
    from gpflowpilco_torch.utils import optimizers, tracing

    cell = load_cell(args.workload)
    cfg, traffic, device = cell.config, cell.traffic, torch.device(args.device)
    variant = cell.variant
    taus = args.taus or [None]  # None: the cell's own (none where its limits do not name it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, t0, **extra):
        line = json.dumps(dict(workload=args.workload, kind=kind, seed=seed, numbers=numbers,
                               seconds=time.perf_counter() - t0, **extra))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(kind, seed):
        """The program's readings at each tau, against the float64 reference."""
        t0 = time.perf_counter()
        inputs, step_seed, steps, record = first_steps(variant, cfg, traffic, seed, device)
        for tau in taus:
            kept = kept_of(cell, cfg, inputs, step_seed, tau)
            replays = tracing.counters().get("graphs.replays", 0)
            if kept is not None:
                record["grad_kept"] = variant.kept_gradient(steps, step_seed, kept)
            replayed = tracing.counters().get("graphs.replays", 0) - replays
            reference = variant.reference_record(cfg, traffic, inputs, step_seed, kept=kept)
            emit(kind, seed, compare(record, reference, True), t0, tau=tau, kept_replayed=replayed)
            t0 = time.perf_counter()
        if kind == "program" and variant.twin_gaps is not None:  # the share each tau would keep
            gaps = variant.twin_gaps(cfg, traffic, inputs, step_seed)
            shares = {f"{10.0 ** -k:.0e}": float((gaps <= 10.0 ** -k).double().mean()) for k in range(2, 16)}
            emit("twin", seed, dict(shares=shares, median=float(gaps.median()), max=float(gaps.max())), t0)
        del steps

    def against_reference(kind, seed, **fault):
        """The reference, a precision lower or with a fault, in the
        program's place, at each tau."""
        inputs = variant.make_inputs(cfg, seed, DTYPES[traffic["dtype"]], device)
        step_seed = derived_seed(seed, STEPS)
        for tau in taus:
            t0 = time.perf_counter()
            kept = kept_of(cell, cfg, inputs, step_seed, tau)
            ref = variant.reference_record(cfg, traffic, inputs, step_seed, kept=kept)
            other = variant.reference_record(cfg, traffic, inputs, step_seed, kept=kept, **fault)
            emit(kind, seed, compare(other, ref, True), t0, tau=tau)

    for seed in args.seeds:
        program("program", seed)
    for seed in args.control_seeds:
        against_reference("control", seed, control=True)
    for seed in args.fault_seeds:
        for name, fault in variant.FAULTS.items():
            against_reference(name, seed, **fault)
    for seed in args.twin_seeds:
        against_reference("ref_twin", seed, **variant.TWIN)
    guarded = optimizers._guarded_step
    optimizers._guarded_step = lambda *a, **k: True  # the step returns its state unchanged
    try:
        for seed in args.fault_seeds:
            program("unchanged", seed)
    finally:
        optimizers._guarded_step = guarded
    for seed in args.witness_seeds:
        t0 = time.perf_counter()
        emit("witness", seed, variant.witness(cfg, traffic, seed, device), t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
