"""The port's span store and counters (gpflowpilco_torch/utils/tracing.py):
the span tree of one pathwise step on K6's route, the host-sync count, a
span from another thread, the ring's bound, the spans in a profiler's
trace, and the benchmark's readers of them on the CPU route.

The steps run the benchmark's cell (``benchmark/harness/system.py``) cut
to a size the CPU runs in seconds. On the CPU the fused rollout runs its
plain version, so the ``k6.*`` spans, which time the card's entries, are
absent here.
"""
import importlib
import json
import math
import sys
import threading

import pytest
import torch

from benchmark.harness.inputs import make_inputs
from benchmark.harness.run_cell import merged, run_cell
from benchmark.harness.spec import load_cell, metric_reader
from benchmark.harness.system import build_system
from gpflowpilco_torch.utils import tracing
from gpflowpilco_torch.utils.optimizers import adam_minimize, adam_minimize_multistart

torch.set_num_threads(1)

CELL = "cartpole-k6-f64"
TINY = {"particles": 32, "bases": 64, "horizon": 0.5, "drift": {"num_inducing": 24},
        "policy": {"num_inducing": 8}}
NEW_METRICS = ("host_syncs_per_step", "sync_wait_ms", "dispatch_ms", "operands_ms", "backward_ms",
               "update_ms", "first_step_ms", "loss_graph_replays_per_step", "paths_graph_replays_per_step")
HARNESS_SPANS = {"step", "paths", "rollout_fwd", "backward_update"}  # benchmark/harness/trace.py's
KERNEL_MODULES = ("path_eval", "enc_match", "gpr_match", "kexp", "mm_glue", "mm_match", "rollout")


def _system(seed=5):
    cell = load_cell(CELL)
    cfg = merged(cell.config, TINY)
    cpu = torch.device("cpu")
    return build_system(cfg, cell.traffic, make_inputs(cfg, seed, torch.float64, cpu), seed, cpu)


def _steps(system, num_steps):
    """The step records of ``num_steps`` Adam steps of the cell's update."""
    tracing.reset()
    adam_minimize(system.loss, system.params, num_steps=num_steps, schedule=system.schedule,
                  global_clipnorm=1.0)
    return tracing.steps()


def _tree(record):
    return sorted((s.name, record.spans[s.parent].name if s.parent >= 0 else None) for s in record.spans)


def test_pathwise_k6_route_step_span_tree_and_self_times():
    """The first step factors the frozen drift's Kuu under ``paths.condition``;
    the second reuses that factor, so only the policy's is taken."""
    records = _steps(_system(), 2)
    assert [r.step for r in records] == [1, 2]
    assert all(r.candidate == -1 and not r.profiled and not r.aborted and r.dropped == 0 for r in records)
    later = [
        ("opt.iter", None), ("opt.loss", "opt.iter"), ("opt.backward", "opt.iter"),
        ("opt.guard", "opt.iter"), ("opt.update", "opt.iter"),
        ("paths.draw", "opt.loss"), ("paths.condition", "opt.loss"), ("rollout.operands", "opt.loss"),
        ("kuu.factor", "rollout.operands"), ("sync.guard", "opt.guard"),
    ]
    first = later + [("kuu.factor", "paths.condition"), ("sync.kuu", "kuu.factor")]
    assert [_tree(r) for r in records] == [sorted(first), sorted(later)]
    # the drift's Kuu syncs, the policy's (inside the particle loss) does not
    rec = records[0]
    assert [rec.spans[s.parent].parent for s in rec.spans if s.name == "sync.kuu"] == [
        next(i for i, s in enumerate(rec.spans) if s.name == "paths.condition")]
    assert tracing.counters()["kuu_cache.misses"] == 1 and tracing.counters()["kuu_cache.hits"] == 1
    for rec in records:
        for i, s in enumerate(rec.spans):
            kids = [c for c in rec.spans if c.parent == i]
            assert s.end_ns >= s.start_ns
            assert all(s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns for c in kids)
            assert s.ns - sum(c.ns for c in kids) >= 0  # the self time
            assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))  # siblings in turn


def test_host_syncs_three_a_step_and_one_more_per_escalation(monkeypatch):
    """The drift's Kuu checks once where it is factored and the guard once
    (the policy's Kuu escalates on the device, with no sync); a later step
    reuses the drift's factor and checks the guard alone; a drift Kuu that
    needs one jitter escalation, factored again after an in-place change,
    checks once more."""
    system = _system()
    rec = _steps(system, 1)[-1]
    assert rec.host_syncs == 2
    assert tracing.counters()["host_syncs.kuu"] == 1 and tracing.counters()["host_syncs.guard"] == 1
    rec = _steps(system, 1)[-1]
    assert rec.host_syncs == 1 and "host_syncs.kuu" not in tracing.counters()
    gram = system.drift.kernel.gram

    def shifted(a, b=None):  # a negative eigenvalue that the first jitter does not lift, the second does
        k = gram(a, b)
        return k - 5e-5 * torch.eye(k.shape[-1], dtype=k.dtype) if b is None else k

    monkeypatch.setattr(system.drift.kernel, "gram", shifted)
    with torch.no_grad():
        system.drift.z.add_(0.0)  # a new version of z, its values unchanged
    rec = _steps(system, 1)[-1]
    assert rec.host_syncs == 3 and tracing.counters()["host_syncs.kuu"] == 2
    assert [s.name for s in rec.spans].count("sync.kuu") == 2
    assert "opt.update" in [s.name for s in rec.spans]  # the step's gradients were finite


def test_multistart_records_carry_the_candidate():
    params = [[torch.nn.Parameter(torch.ones(3, dtype=torch.float64) * k)] for k in (1, 2)]
    losses = [lambda p=p: (p[0] ** 2).sum() for p in params]
    tracing.reset()
    adam_minimize_multistart(losses, params, num_steps=2)
    held = tracing.steps()
    assert [(r.step, r.candidate, r.host_syncs) for r in held] == [(1, 0, 1), (2, 0, 1), (3, 1, 1), (4, 1, 1)]


def test_span_on_another_thread_joins_the_open_step():
    """As autograd's device thread runs K6's backward while the step's own
    thread waits in ``backward()``."""
    def device_thread():
        with tracing.span("k6.bwd"):
            with tracing.span("sync.guard"):
                pass

    tracing.reset()
    with tracing.step("opt.iter"):
        with tracing.span("opt.backward"):
            worker = threading.Thread(target=device_thread)
            worker.start()
            worker.join(timeout=30)
        with tracing.span("opt.update"):
            pass
    assert not worker.is_alive()
    (rec,) = tracing.steps()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("opt.iter", -1), ("opt.backward", 0), ("k6.bwd", 1), ("sync.guard", 2), ("opt.update", 0)]


def test_ring_keeps_its_bound_and_drops_spans_past_its_slots():
    tracing.reset()
    for _ in range(tracing.RING + 5):
        with tracing.step("opt.iter"):
            with tracing.span("opt.loss"):
                pass
    with tracing.step("opt.iter"):
        for _ in range(tracing.SLOTS + 3):
            with tracing.span("opt.loss"):
                pass
    held = tracing.steps()
    assert len(held) == tracing.RING
    assert held[0].step == 7 and held[-1].step == tracing.RING + 6
    assert len(held[-1].spans) == tracing.SLOTS and held[-1].dropped == 4
    store = tracing._store
    size = sum(len(a) * a.itemsize for a in vars(store).values() if hasattr(a, "buffer_info"))
    assert size < 8 * 2**20


def test_spans_reach_the_profilers_chrome_trace(tmp_path):
    system = _system()
    _steps(system, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        adam_minimize(system.loss, system.params, num_steps=1, schedule=system.schedule)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    annotated = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    rec = tracing.steps()[-1]
    assert rec.profiled and not tracing.steps()[0].profiled
    assert {s.name for s in rec.spans} <= annotated
    assert not annotated & HARNESS_SPANS


def test_counters_show_every_launch_count_under_its_own_key():
    modules = [importlib.import_module(f"gpflowpilco_torch.ops.{m}_cuda") for m in KERNEL_MODULES]
    keys = [k for m in modules for k in m.launches]
    assert len(set(keys)) == len(keys)
    rc = modules[-1]
    rc.launches["rollout_fwd_f64"] += 2
    assert tracing.counters()["rollout_fwd_f64"] == 2
    rc.reset_launches()
    counts = tracing.counters()
    assert all(counts[k] == m.launches[k] for m in modules for k in m.launches)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_gives_none_without_records(name, monkeypatch):
    read = metric_reader(name)
    tracing.reset()
    assert read({"window": {"steps": 5}}) is None
    monkeypatch.delitem(sys.modules, tracing.__name__)  # a program without the span store
    assert read({"window": {"steps": 5}}) is None


def test_run_cell_reads_the_new_metrics_on_the_cpu_route():
    result, _ = run_cell(CELL, 2**32 + 11, 0.5, True, t_start=0.0, device="cpu", require_cuda=False,
                         overrides=TINY)
    assert result["correct"] and result["attempted"] > 0
    metrics = result["metrics"]
    assert all(math.isfinite(metrics[m]["value"]) for m in NEW_METRICS if m in metrics)
    # the guard alone: the drift's Kuu was factored in the warm-up
    assert metrics["host_syncs_per_step"] == {"value": 1.0, "unit": "syncs"}
    assert metrics["loss_graph_replays_per_step"] == {"value": 0.0, "unit": "replays"}  # eager here
    assert metrics["paths_graph_replays_per_step"] == {"value": 0.0, "unit": "replays"}
    assert {"dispatch_ms", "operands_ms", "backward_ms", "update_ms", "first_step_ms"} <= set(metrics)
