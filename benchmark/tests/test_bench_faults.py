"""A whole run on the CPU at a tiny size, with the look for a card skipped:
sound, it is correct; with the timed path broken underneath, it is not.
Also the result line's keys."""
import json

import pytest

from benchmark.harness.run_cell import run_cell
from benchmark.harness.spec import load_cell
from benchmark.run import _finite
from gpflowpilco_torch.loops import pilco
from gpflowpilco_torch.utils import optimizers

CELL = "cartpole-k6-f64"  # tiny float64 numbers sit far inside every cell's limits


def _run(tiny, trace=False):
    return run_cell(CELL, 2**32 + 9, 0.5, trace, t_start=0.0, device="cpu", require_cuda=False,
                    overrides=tiny)[0]


def test_sound_run_is_correct_and_its_line_has_the_keys(tiny):
    result = _run(tiny)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(load_cell(CELL).limits)
    assert set(result["metrics"]) == {"policy_steps_per_s", "setup_s"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    line = json.loads(json.dumps(_finite(result), allow_nan=False))
    assert line["metrics"]["setup_s"]["unit"] == "s"


def test_traced_line_has_per_layer_metrics(tiny):
    result = _run(tiny, trace=True)
    assert result["correct"]
    assert {"step_ms_p95", "paths_ms", "rollout_fwd_ms", "backward_update_ms"} <= set(result["metrics"])


def _unchanged(*args, **kwargs):
    return True  # the step returns its state unchanged


def _half_batch(*args, **kwargs):
    costs = _half_batch.original(*args, **kwargs)
    return costs[: costs.shape[0] // 2]  # the mean is taken over half of the particles


def _backward_halved(*args, **kwargs):
    costs = _backward_halved.original(*args, **kwargs)
    return costs.detach() + 0.5 * (costs - costs.detach())  # the forward as it was, half the gradient


@pytest.mark.parametrize("cell, fault", [(CELL, "unchanged"), (CELL, "half_batch"),
                                         ("double-pendulum-k6-f64", "unchanged"),
                                         ("double-pendulum-k6-f64", "half_batch"),
                                         ("double-pendulum-k6-f64", "backward_halved")])
def test_broken_step_is_not_correct(cell, fault, tiny, monkeypatch):
    """Each fault the cell can have, planted under the timed path: the step
    returns its state unchanged; the mean is taken over half the particles;
    (where the cell checks the gradient under chaos, ``grad_gap_kept``) the
    backward alone is wrong."""
    if fault == "unchanged":
        monkeypatch.setattr(optimizers, "_guarded_step", _unchanged)
    else:
        broken = {"half_batch": _half_batch, "backward_halved": _backward_halved}[fault]
        broken.original = pilco.fused_rollout_costs
        monkeypatch.setattr(pilco, "fused_rollout_costs", broken)
    result, _ = run_cell(cell, 2**32 + 9, 0.5, False, t_start=0.0, device="cpu", require_cuda=False,
                         overrides=tiny)
    assert not result["correct"]


def test_window_counts_the_launches_of_its_own_steps(tiny, monkeypatch):
    """The window keeps how often each counted entry ran between its open
    and its close: once a step on the kernels' route."""
    import torch

    from benchmark.harness.run_cell import first_steps, merged

    counts = {"rollout_fwd_f64": 0}
    original = pilco.fused_rollout_costs

    def counted(*args, **kwargs):
        counts["rollout_fwd_f64"] += 1
        return original(*args, **kwargs)

    monkeypatch.setattr(pilco, "fused_rollout_costs", counted)
    cell = load_cell(CELL)
    _, _, steps, _ = first_steps(cell.variant, merged(cell.config, tiny), cell.traffic, 5,
                                 torch.device("cpu"), 0.3, counters=[counts])
    assert steps.window_steps > 0
    assert steps.launches_in_window == {"rollout_fwd_f64": steps.window_steps}
    assert counts["rollout_fwd_f64"] > steps.window_steps  # the warm-up's are not the window's


def test_a_window_off_the_kernels_route_gives_no_result():
    from types import SimpleNamespace

    from benchmark.harness.run_cell import OffRoute, check_route

    traffic = load_cell(CELL).traffic
    steps = SimpleNamespace(window_steps=5, launches_in_window={"rollout_fwd_f64": 5, "rollout_bwd_f64": 5})
    entry = {"ms": 1.0, "entries": 5}
    check_route(traffic, steps, {"k6": {"fwd": entry, "bwd": entry}})
    check_route(traffic, steps, None)
    with pytest.raises(OffRoute):  # the trace holds no forward kernel
        check_route(traffic, steps, {"k6": {"bwd": entry}})
    with pytest.raises(OffRoute):  # nothing profiled at all
        check_route(traffic, steps, {})
    steps.launches_in_window["rollout_fwd_f64"] = 0  # the loss took the plain rollout
    with pytest.raises(OffRoute):
        check_route(traffic, steps, None)
