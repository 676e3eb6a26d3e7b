"""The plain reference against the port on the CPU at a tiny size, and the
control (the reference a precision lower) against the reference."""
import json

import pytest
import torch

from benchmark.harness.check import NUMBERS, compare, verdict
from benchmark.harness.inputs import STEPS, derived_seed, make_inputs
from benchmark.harness.run_cell import DTYPES, first_steps, kept_of, merged
from benchmark.harness.spec import BENCH_DIR, load_benchmark, load_cell, variant_module

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
CONFIGS = sorted(p.stem for p in (BENCH_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_follows_the_port_in_float64(config, tiny):
    """Both sides in float64 on the same inputs and draws: the losses, the
    first step's per-particle costs, its gradient, the changes and the kept
    particles' gradient agree to rounding (every configuration file, also
    one that no cell runs yet)."""
    cfg = merged(json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text()), tiny)
    traffic = json.loads((BENCH_DIR / "traffic" / "k6-f64.json").read_text())
    variant = variant_module(traffic["system"])
    inputs, step_seed, steps, program = first_steps(variant, cfg, traffic, 2**31 + 5, torch.device("cpu"))
    cell = load_cell(CELLS[0])
    kept = kept_of(cell, cfg, inputs, step_seed, tau=1e-8)
    program["grad_kept"] = variant.kept_gradient(steps, step_seed, kept)
    numbers = compare(program, variant.reference_record(cfg, traffic, inputs, step_seed, kept=kept))
    assert set(numbers) == set(NUMBERS) | {"kept_share"}
    assert numbers["kept_share"] == 1.0  # nothing chaotic at this size
    assert max(numbers[k] for k in NUMBERS) < 1e-9, numbers


@pytest.mark.parametrize("name", CELLS)
def test_port_meets_its_cell_limits_at_a_tiny_size(name, tiny):
    cell = load_cell(name)
    cfg = merged(cell.config, tiny)
    inputs, step_seed, steps, program = first_steps(cell.variant, cfg, cell.traffic, 11, torch.device("cpu"))
    kept = kept_of(cell, cfg, inputs, step_seed)
    if kept is not None:
        program["grad_kept"] = cell.variant.kept_gradient(steps, step_seed, kept)
    numbers = compare(program, cell.variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept))
    assert verdict(numbers, cell.limits), numbers


def _control_fails(name, cfg, device, seeds):
    cell = load_cell(name)
    for seed in seeds:
        inputs = make_inputs(cfg, seed, DTYPES[cell.traffic["dtype"]], device)
        step_seed = derived_seed(seed, STEPS)
        kept = kept_of(cell, cfg, inputs, step_seed)
        ref = cell.variant.reference_record(cfg, cell.traffic, inputs, step_seed, kept=kept)
        control = cell.variant.reference_record(cfg, cell.traffic, inputs, step_seed, control=True, kept=kept)
        assert not verdict(compare(control, ref), cell.limits), seed


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny):
    """The cell's control (the reference a precision lower in the program's
    place; float32 below float64) at a size a test run holds."""
    _control_fails(name, merged(load_cell(name).config, tiny), torch.device("cpu"), (1, 2, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _control_fails(name, load_cell(name).config, torch.device("cuda:0"), (1, 2, 3))
