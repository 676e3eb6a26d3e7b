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
    from benchmark.harness.inputs import STEPS, derived_seed, make_inputs
    from benchmark.harness.run_cell import (DTYPES, first_steps, kept_gradient, kept_of,
                                            reference_record)
    from benchmark.harness.spec import load_cell
    from benchmark.reference.pathwise import twin_gaps
    from gpflowpilco_torch.utils import optimizers, tracing

    cell = load_cell(args.workload)
    cfg, traffic, device = cell.config, cell.traffic, torch.device(args.device)
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
        inputs, step_seed, steps, record = first_steps(cfg, traffic, seed, device)
        for tau in taus:
            kept = kept_of(cell, cfg, inputs, step_seed, tau)
            replays = tracing.counters().get("graphs.replays", 0)
            if kept is not None:
                record["grad_kept"] = kept_gradient(steps, step_seed, kept)
            replayed = tracing.counters().get("graphs.replays", 0) - replays
            emit(kind, seed, compare(record, reference_record(cfg, traffic, inputs, step_seed, kept=kept),
                                     True), t0, tau=tau, kept_replayed=replayed)
            t0 = time.perf_counter()
        if kind == "program":  # the twin's gaps: the share each tau would keep
            gaps = twin_gaps(cfg, inputs["drift"], inputs["policy"], step_seed, DTYPES[traffic["dtype"]],
                             cfg["jitter"][traffic["dtype"]])
            shares = {f"{10.0 ** -k:.0e}": float((gaps <= 10.0 ** -k).double().mean()) for k in range(2, 16)}
            emit("twin", seed, dict(shares=shares, median=float(gaps.median()), max=float(gaps.max())), t0)
        del steps

    def against_reference(kind, seed, **fault):
        """The reference, a precision lower or with a fault, in the
        program's place, at each tau."""
        inputs = make_inputs(cfg, seed, DTYPES[traffic["dtype"]], device)
        step_seed = derived_seed(seed, STEPS)
        for tau in taus:
            t0 = time.perf_counter()
            kept = kept_of(cell, cfg, inputs, step_seed, tau)
            ref = reference_record(cfg, traffic, inputs, step_seed, kept=kept)
            other = reference_record(cfg, traffic, inputs, step_seed, kept=kept, **fault)
            emit(kind, seed, compare(other, ref, True), t0, tau=tau)

    for seed in args.seeds:
        program("program", seed)
    for seed in args.control_seeds:
        against_reference("control", seed, control=True)
    for seed in args.fault_seeds:
        against_reference("half_batch", seed, half_batch=True)
        against_reference("detach_last", seed, detach_last=True)
    for seed in args.twin_seeds:
        against_reference("ref_twin", seed, nudge=True)
    guarded = optimizers._guarded_step
    optimizers._guarded_step = lambda *a, **k: True  # the step returns its state unchanged
    try:
        for seed in args.fault_seeds:
            program("unchanged", seed)
    finally:
        optimizers._guarded_step = guarded
    for seed in args.witness_seeds:
        t0 = time.perf_counter()
        emit("witness", seed, witness(cfg, traffic, seed, device), t0)
    if out:
        out.close()
    return 0


def witness(cfg, traffic, seed, device):
    """The first step's per-particle costs, each route against the reference."""
    import torch

    from benchmark.harness.inputs import STEPS, derived_seed, make_inputs
    from benchmark.harness.run_cell import DTYPES
    from benchmark.harness.system import build_system
    from benchmark.reference import pathwise as ref
    from gpflowpilco_torch.loops import pilco
    from gpflowpilco_torch.models.pathwise import PathwiseSVGPTransform

    dtype, f64 = DTYPES[traffic["dtype"]], torch.float64
    inputs = make_inputs(cfg, seed, dtype, device)
    step_seed = derived_seed(seed, STEPS)
    system = build_system(cfg, traffic, inputs, step_seed, device)
    loop, spec = system.loop, system.loop.policy_spec
    horizon = loop.episode_spec.num_steps
    marks = sorted({max(1, horizon * k // 5) for k in range(1, 6)})
    with torch.no_grad():
        paths = pilco.generate_paths_svgp(system.drift, system.generator, spec.batch_size, spec.num_bases)
        x0 = loop.episode_spec.sample(system.generator, (spec.batch_size,), dtype=dtype, device=device)
        drift_fn = PathwiseSVGPTransform(model=system.drift, paths=paths, fused=False)
        chain = loop.policy_chain(system.policy)
        gen = torch.Generator(device=device).manual_seed(step_seed)
        dr, po, jitter = ref.cast(inputs["drift"], f64), ref.cast(inputs["policy"], f64), cfg["jitter"][traffic["dtype"]]
        rpaths, x0r = ref.step_operands(gen, cfg, dr, dtype, f64, jitter, f64)
        routes = dict(
            k6=lambda t: pilco.fused_rollout_costs(system.policy, system.drift, paths, x0, loop.encoder,
                                                   loop.objective, spec.action_scale, t),
            k6_ulp=lambda t: pilco.fused_rollout_costs(system.policy, system.drift, paths, ref.twin(x0),
                                                       loop.encoder, loop.objective, spec.action_scale, t),
            plain=lambda t: pilco.particle_rollout_costs(chain, drift_fn, x0, loop.encoder, loop.objective, t),
            ref_ulp=lambda t: ref.rollout_costs(po, dr, rpaths, ref.twin(x0r), cfg, jitter, f64, t),
        )
        out = dict(x0_gap=float((x0.to(f64) - x0r).abs().max()), marks=marks)
        for t in marks:
            truth = ref.rollout_costs(po, dr, rpaths, x0r, cfg, jitter, f64, t)
            scale = float(truth.mean().abs())
            worst = int((routes["k6"](t).to(f64) - truth).abs().argmax())  # K6's worst particle
            row = dict(loss=-scale, worst=worst, worst_cost=float(truth[worst]),
                       median_cost=float(truth.median()))
            for name, route in routes.items():
                costs = route(t).to(f64)
                gap = (costs - truth).abs()
                row[name] = dict(loss_gap=float((costs.mean() - truth.mean()).abs()) / scale,
                                 worst=float(gap.max()), at_worst=float(gap[worst]),
                                 median=float(gap.median()), over_1e9=int((gap > 1e-9).sum()))
            out[f"T{t}"] = row
    return out


if __name__ == "__main__":
    sys.exit(main())
