"""The data-driven layout: every cell, configuration, traffic mix, limit
file, variant and metric reader is found by name, a new one is picked up
with no edit, and BENCHMARK.json keeps to its contract's shape."""
import hashlib
import json
import re
import shutil
from pathlib import Path

from benchmark.harness.check import NUMBERS
from benchmark.harness.spec import BENCH_DIR, ROOT, load_benchmark, load_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_and_reader_is_found():
    bench = load_benchmark()
    for work in bench["workloads"]:
        cell = load_cell(work["name"])
        assert cell.limits and set(cell.limits) <= set(NUMBERS)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_benchmark_json_shape():
    bench = load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]}) == len(
        bench["end_to_end"]) + len(bench["per_layer"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e


def test_new_cell_config_mix_and_metric_are_picked_up(tmp_path):
    """A later change adds files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = load_benchmark()
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "cartpole-wide-policy"
    cfg["policy"]["num_inducing"] = 40
    (root / "benchmark/configs/cartpole-wide-policy.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/k6-f64-short.json").write_text(
        (BENCH_DIR / "traffic/k6-f64.json").read_text().replace('"warmup_steps": 8', '"warmup_steps": 4'))
    (root / "benchmark/workloads/cartpole-wide-k6.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}}))
    (root / "benchmark/metrics/steps_in_window.py").write_text(
        'def read(run):\n    return float(run["window"]["steps"])\n')
    bench["configs"].append({"name": "cartpole-wide-policy", "source": "https://example.org/x",
                             "file": "benchmark/configs/cartpole-wide-policy.json", "reduced": [],
                             "why": "a wider policy"})
    bench["workloads"].append({"name": "cartpole-wide-k6", "config": "cartpole-wide-policy",
                               "traffic": "k6-f64-short", "chips": 1, "why": "wider policy"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "policy optimizer",
                               "moves": "policy_steps_per_s", "workloads": ["cartpole-wide-k6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("cartpole-wide-k6", root)
    assert cell.config["policy"]["num_inducing"] == 40 and cell.traffic["warmup_steps"] == 4
    assert cell.limits["loss_gap"] == 1e-3
    assert [m["name"] for m in cell.per_layer][-1] == "steps_in_window"
    assert "steps_in_window" not in [m["name"] for m in load_cell("cartpole-k6-f64", root).per_layer]
    reader = metric_reader("steps_in_window", root / "benchmark")
    assert reader({"window": {"steps": 7}}) == 7.0
    from benchmark.harness.run_cell import run_cell

    tiny = {"particles": 32, "bases": 64, "horizon": 0.5, "drift": {"num_inducing": 24}}
    result, _ = run_cell("cartpole-wide-k6", 7, 0.5, True, t_start=0.0, device="cpu",
                         require_cuda=False, root=root, overrides=tiny)
    assert result["metrics"]["steps_in_window"]["value"] == result["attempted"] > 0


PLAIN_VARIANT = '''"""PathwisePILCO with the fused rollout off: each particle's cost through
the port's plain rollout, timed as a span of its own."""
from pathlib import Path

from benchmark.harness.spec import variant_module
from gpflowpilco_torch.loops import pilco

_pathwise = variant_module("pathwise", Path(__file__).resolve().parents[1])
make_inputs, dims, step_ops = _pathwise.make_inputs, _pathwise.dims, _pathwise.step_ops
reference_record, FAULTS = _pathwise.reference_record, _pathwise.FAULTS
SPANS = ((pilco, "particle_rollout_costs", "plain_rollout"),)
COSTS = TWIN = kept_particles = twin_gaps = kept_gradient = witness = None


def build_system(cfg, traffic, inputs, step_seed, device):
    system = _pathwise.build_system(cfg, traffic, inputs, step_seed, device)
    system.loop.use_fused_rollout = False
    return system
'''


def _hashes(tree):
    return {p.relative_to(tree): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_variant_is_new_files_only(tmp_path, tiny):
    """A variant (its module, traffic mix, limits, a reader of its span and
    BENCHMARK.json entries) runs a cell correct, and no file of the
    benchmark that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(root / "benchmark")
    added = {"systems/pathwise_plain.py": PLAIN_VARIANT,
             "workloads/cartpole-plain-f64.json": (BENCH_DIR / "workloads/cartpole-k6-f64.json").read_text(),
             "metrics/plain_rollout_ms.py": (BENCH_DIR / "metrics/rollout_fwd_ms.py").read_text().replace(
                 '"rollout_fwd"', '"plain_rollout"')}
    traffic = json.loads((BENCH_DIR / "traffic/k6-f64.json").read_text())
    traffic.update(system="pathwise_plain", route="plain", sources=[], launches_per_step={},
                   kernel_groups={}, traced_kernels=[])
    added["traffic/plain-f64.json"] = json.dumps(traffic)
    for name, text in added.items():
        (root / "benchmark" / name).write_text(text)
    bench = load_benchmark()
    bench["workloads"].append({"name": "cartpole-plain-f64", "config": "cartpole-swingup-pathwise",
                               "traffic": "plain-f64", "chips": 1, "why": "the plain rollout"})
    bench["per_layer"].append({"name": "plain_rollout_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "particle loss",
                               "moves": "policy_steps_per_s", "workloads": ["cartpole-plain-f64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from benchmark.harness.run_cell import run_cell

    result, _ = run_cell("cartpole-plain-f64", 2**33 + 3, 0.5, True, t_start=0.0, device="cpu",
                         require_cuda=False, root=root, overrides=tiny)
    assert result["correct"] and result["attempted"] > 0
    assert result["metrics"]["plain_rollout_ms"]["value"] > 0
    assert not {"paths_ms", "rollout_fwd_ms", "k6_fwd_roofline"} & set(result["metrics"])
    after = _hashes(root / "benchmark")
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {Path(name) for name in added}
