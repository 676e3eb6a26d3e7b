"""The gradient check that holds under chaos (``grad_gap_kept``) on the
double pendulum's configuration at a tiny size: the port meets it, a fault
in the backward alone fails it while the forward's numbers pass, too few
kept particles read ``inf``, and the twin with no nudge keeps every
particle. Also K6's forward route at the configurations' widths and the
``operands_ms`` reader on a replayed step."""
import math

import pytest
import torch

from benchmark.harness.check import KEPT_FLOOR, compare, verdict
from benchmark.harness.inputs import STEPS, derived_seed, dims, make_inputs
from benchmark.harness.run_cell import first_steps, kept_of, merged, run_cell
from benchmark.harness.spec import load_cell, metric_reader
from benchmark.reference.pathwise import kept_particles, twin_gaps

CELL = "double-pendulum-k6-f64"
CPU = torch.device("cpu")


def _cell(tiny):
    cell = load_cell(CELL)
    return cell, merged(cell.config, tiny)


def _inputs(cfg, seed):
    return make_inputs(cfg, seed, torch.float64, CPU), derived_seed(seed, STEPS)


def test_port_meets_grad_gap_kept_in_a_whole_run(tiny):
    result, lines = run_cell(CELL, 2**33 + 1, 0.5, False, t_start=0.0, device="cpu", require_cuda=False,
                             overrides=tiny)
    checks = result["checks"]
    assert result["correct"] and checks["grad_gap_kept"]["value"] <= checks["grad_gap_kept"]["limit"]
    assert checks["kept_share"] == {"value": 1.0, "floor": KEPT_FLOOR}
    assert list(result)[-1] == "checks" and lines[-1] == f"kept_share 1.0 floor {KEPT_FLOOR!r}"


def test_cartpole_run_computes_no_kept_particles(tiny, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("a cell whose limits do not name grad_gap_kept drew kept particles")

    monkeypatch.setattr(load_cell("cartpole-k6-f64").variant, "kept_particles", refused)
    result, _ = run_cell("cartpole-k6-f64", 2**33 + 2, 0.5, False, t_start=0.0, device="cpu",
                         require_cuda=False, overrides=tiny)
    assert result["correct"] and "kept_share" not in result["checks"]


def _reference_numbers(cell, cfg, seed, **fault):
    inputs, step_seed = _inputs(cfg, seed)
    kept = kept_of(cell, cfg, inputs, step_seed)
    truth = cell.variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept)
    return compare(cell.variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept, **fault),
                   truth)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gradient_only_fault_fails_grad_gap_kept_and_passes_the_forward(seed, tiny):
    """The last transition cut out of the backward: the forward is bit for
    bit the reference's, so only the kept gradient can see it."""
    cell, cfg = _cell(tiny)
    numbers = _reference_numbers(cell, cfg, seed, detach_last=True)
    assert numbers["cost_gap_median"] == 0.0 and numbers["loss_gap_first"] == 0.0
    assert numbers["cost_gap_median"] <= cell.limits["cost_gap_median"]
    assert numbers["grad_gap_kept"] > cell.limits["grad_gap_kept"]
    assert not verdict(numbers, cell.limits)


@pytest.mark.parametrize("share", [0.4, 0.5])
def test_kept_share_under_the_floor_reads_inf(share, tiny):
    cell, cfg = _cell(tiny)
    inputs, step_seed, steps, program = first_steps(cell.variant, cfg, cell.traffic, 4, CPU)
    s = dims(cfg)["S"]
    kept = torch.arange(s) < int(share * s)
    program["grad_kept"] = cell.variant.kept_gradient(steps, step_seed, kept)
    numbers = compare(program, cell.variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept))
    assert numbers["kept_share"] == int(share * s) / s
    if share < KEPT_FLOOR:
        assert numbers["grad_gap_kept"] == math.inf and not verdict(numbers, cell.limits)
    else:
        assert numbers["grad_gap_kept"] <= cell.limits["grad_gap_kept"]


def test_twin_with_no_nudge_keeps_every_particle(tiny):
    cell, cfg = _cell(tiny)
    inputs, step_seed = _inputs(cfg, 6)
    args = (cfg, inputs["drift"], inputs["policy"], step_seed, torch.float64, cfg["jitter"]["float64"])
    assert torch.equal(twin_gaps(*args, eps=0.0), torch.zeros(dims(cfg)["S"], dtype=torch.float64))
    gaps = twin_gaps(*args)
    assert gaps.max() > 0  # one ulp does move the rollout
    assert kept_particles(*args, tau=float(gaps.max())).all()
    assert not kept_particles(*args, tau=float(gaps.min()) / 2).any()


def test_nudged_reference_departs_from_itself_by_rounding_alone(tiny):
    """The reference started at every step from its initial states' twin (the
    witness for the program's readings under chaos) moves the numbers, and at
    a size with no chaos by rounding alone."""
    cell, cfg = _cell(tiny)
    numbers = _reference_numbers(cell, cfg, 7, nudge=True)
    assert 0.0 < numbers["loss_gap"] < 1e-9 and numbers["change_gap"] < 1e-9, numbers
    assert verdict(numbers, cell.limits)


def test_kept_gradient_follows_the_reference_and_the_kept_set_moves_it(tiny):
    """The program's kept gradient is the reference's to rounding, and it is
    not the gradient of all the particles' mean."""
    cell, cfg = _cell(tiny)
    variant = cell.variant
    inputs, step_seed, steps, program = first_steps(variant, cfg, cell.traffic, 8, CPU)
    kept = torch.arange(dims(cfg)["S"]) % 4 != 0
    program["grad_kept"] = variant.kept_gradient(steps, step_seed, kept)
    ref = variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept)
    assert compare(program, ref)["grad_gap_kept"] < 1e-9
    every = variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=torch.ones_like(kept))
    assert compare(dict(program, grad_kept=every["grad_kept"]), ref)["grad_gap_kept"] > 1e-3


@pytest.mark.parametrize("config, routes", [
    ("double-pendulum-pathwise", {torch.float32: "resident", torch.float64: "ring"}),
    ("cartpole-swingup-pathwise", {torch.float32: "resident", torch.float64: "ring"}),
])
def test_k6_forward_route_at_the_configurations_widths(config, routes):
    """``rollout_cuda.fwd_plan`` (which mirrors the kernel's shared-memory
    sizing) streams the drift tables in float64 and keeps them resident in
    float32 at both configurations' widths."""
    import json

    from benchmark.harness.spec import BENCH_DIR
    from gpflowpilco_torch.ops.rollout_cuda import RolloutMeta, fwd_plan

    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    n = dims(cfg)
    meta = RolloutMeta(num_steps=n["T"], dt=1.0, squash_scale=2 * cfg["action_scale"] - 1e-5,
                       active_dims=tuple(cfg["active_dims"]), state_dim=n["D"], enc_dim=n["De"],
                       act_dim=n["U"], num_latent=n["L"], pol_latent=n["Lp"])
    assert {dtype: fwd_plan(meta, n["B"], n["M"], dtype)[0] for dtype in routes} == routes


def _record(spans):
    """A closed step record of (name, parent, ms) spans."""
    from gpflowpilco_torch.utils import tracing

    out, t = [], 0
    for name, parent, ms in spans:
        out.append(tracing.Span(name, parent, t, t + int(ms * 1e6)))
        t += 1
    return tracing.Step(1, -1, False, False, 0, 0, tuple(out), 1)


def test_operands_ms_reads_graph_fwd_on_a_replayed_step(monkeypatch):
    """The graphed region's forward: ``graph.fwd`` where it was replayed, its
    operands and K6's launch where it ran eager."""
    from gpflowpilco_torch.utils import tracing

    replayed = _record([("opt.iter", -1, 9.0), ("opt.loss", 0, 5.0), ("graph.fwd", 1, 0.25)])
    eager = _record([("opt.iter", -1, 9.0), ("opt.loss", 0, 5.0), ("rollout.operands", 1, 1.5),
                     ("kuu.factor", 2, 0.5), ("sync.kuu", 3, 0.25), ("k6.fwd", 1, 0.125),
                     ("opt.backward", 0, 2.0), ("k6.bwd", 6, 1.0)])
    read = metric_reader("operands_ms")
    monkeypatch.setattr(tracing, "steps", lambda: [replayed])
    assert read({"window": {"steps": 1}}) == pytest.approx(0.25)
    monkeypatch.setattr(tracing, "steps", lambda: [eager, replayed])
    assert read({"window": {"steps": 2}}) == pytest.approx((1.5 - 0.25 + 0.125 + 0.25) / 2)
