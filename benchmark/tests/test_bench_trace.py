"""The trace's reduction from the kernel groups and spans a cell names, on a
fixed synthetic trace of K6's kernels: ``k6-f64``'s groups and the pathwise
variant's spans give the summary that K6's patterns and the spans
``paths``, ``rollout_fwd`` and ``backward_update`` give."""
from benchmark.harness.spec import load_cell
from benchmark.harness.trace import reduce
from benchmark.harness.window import UPDATE_SPAN


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _step(t0):
    """One profiled step's harness spans, host ops and device work from ``t0`` (us)."""
    def ann(name, at, dur):
        return _ev("user_annotation", name, t0 + at, dur)

    def cpu(name, at, dur):
        return _ev("cpu_op", name, t0 + at, dur)

    def ker(name, at, dur):
        return _ev("kernel", name, t0 + at, dur)

    return [
        ann("step", 0, 100), ann("paths", 2, 20), ann("rollout_fwd", 25, 15),
        ann("backward_update", 50, 48), ann("graph.fwd", 26, 12),
        cpu("aten::linalg_cholesky", 4, 10), cpu("cudaGraphLaunch", 27, 3), cpu("aten::add_", 52, 30),
        cpu("cudaStreamSynchronize", 84, 12),
        _ev("gpu_memset", "Memset (Device)", t0 + 1, 1), ker("trsm_left_kernel<double, 256>", 10, 5),
        _ev("gpu_memcpy", "Memcpy HtoD", t0 + 24, 1),
        ker("void fwd_panels<double>(Params)", 28, 2), ker("void fwd_warp<double, 6, true>(Params)", 31, 8),
        ker("void fwd_warp_probe<double>(Params)", 40, 1),  # neither K6 pattern's word
        ker("void bwd_jac<double, 6>(Params)", 60, 10), ker("void bwd_maps<double>(Params)", 71, 3),
        ker("void bwd_adjoint<double>(Params)", 75, 2), ker("void bwd_grads<double>(Params)", 78, 2),
    ]


# three steps (the first warms the profiler, so the slice is 100-300 us), a
# kernel that the slice's end cuts and a fill after it
EVENTS = (_step(0) + _step(100) + _step(200)
          + [_ev("kernel", "potrf_kernel<double>", 295, 10), _ev("gpu_memset", "Memset (Device)", 320, 4)])

# EVENTS reduced with K6's patterns (forward: fwd_panels, fwd_warp, entry
# fwd_warp; backward: bwd_jac, bwd_maps, bwd_adjoint, bwd_grads, entry
# bwd_jac) and the spans paths, rollout_fwd and backward_update
FIXED = {
    "slice_s": 0.00019999999999999998, "busy_s": 7.5e-05, "steps": 2,
    "k6": {"fwd": {"ms": 0.01, "entries": 2}, "bwd": {"ms": 0.017, "entries": 2}},
    "device_ops": [["bwd_jac<double, 6>(Params)", 1.9999999999999998e-05],
                   ["fwd_warp<double, 6, true>(Params)", 1.6e-05],
                   ["trsm_left_kernel<double, 256>", 9.999999999999999e-06],
                   ["potrf_kernel<double>", 9.999999999999999e-06], ["bwd_maps<double>(Params)", 6e-06],
                   ["fwd_panels<double>(Params)", 4e-06], ["bwd_adjoint<double>(Params)", 4e-06],
                   ["bwd_grads<double>(Params)", 4e-06], ["Memset (Device)", 2e-06], ["Memcpy HtoD", 2e-06]],
    "idle_gaps": [["backward_update/backward_update", 3.7999999999999995e-05],
                  ["backward_update/cudaStreamSynchronize", 3.6e-05], ["paths/paths", 1.8e-05],
                  ["paths/aten::linalg_cholesky", 1.6e-05], ["rollout_fwd/graph.fwd", 8e-06],
                  ["backward_update/aten::add_", 6e-06], ["rollout_fwd/rollout_fwd", 2e-06],
                  ["step/step", 1e-06]],
}


def test_k6_groups_and_pathwise_spans_read_as_the_fixed_ones():
    cell = load_cell("cartpole-k6-f64")
    spans = (UPDATE_SPAN, *(name for _, _, name in cell.variant.SPANS))
    summary = reduce(EVENTS, cell.traffic["kernel_groups"], spans)
    assert summary == FIXED and list(summary) == list(FIXED)


def test_groups_and_spans_are_the_callers():
    """A group whose entry kernel never ran reads empty; a span the caller
    does not name does not name a gap."""
    groups = {"k2": {"fwd": {"kernels": r"\bkexp_fwd\b", "entry": r"\bkexp_fwd\b"}}}
    summary = reduce(EVENTS, groups, (UPDATE_SPAN,))
    assert summary["k2"] == {} and "k6" not in summary
    assert {name.split("/")[0] for name, _ in summary["idle_gaps"]} == {"backward_update", "step"}
    assert summary["busy_s"] == FIXED["busy_s"] and summary["device_ops"] == FIXED["device_ops"]
