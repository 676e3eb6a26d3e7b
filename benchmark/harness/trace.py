"""Reduce the profiled slice's trace to the device's busy time, each
operation's time, K6's time per entry and the idle gaps.

The slice runs from the start of the second profiled step span to the end
of the last (the first step warms the profiler). Device time is every
kernel, copy and fill; busy time is the union of their intervals inside the
slice. An idle gap is named by the harness's span that encloses it and the
innermost host operation running at its middle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
SPANS = ("paths", "rollout_fwd", "backward_update")
K6 = {"fwd": re.compile(r"\b(fwd_panels|fwd_warp)\b"),
      "bwd": re.compile(r"\b(bwd_jac|bwd_maps|bwd_adjoint|bwd_grads)\b")}
K6_ENTRY = {"fwd": re.compile(r"\bfwd_warp\b"), "bwd": re.compile(r"\bbwd_jac\b")}


def export_events(profiler) -> List[dict]:
    """The profiler's Chrome-trace events (written to a temporary file under
    TMPDIR, read back and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        profiler.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _short(name: str, n: int = 96) -> str:
    name = re.sub(r"^void ", "", name)
    return name if len(name) <= n else name[: n - 3] + "..."


def reduce(events: List[dict]) -> Dict:
    """Summary of the slice; {} when the trace holds no step span or no
    device operation."""
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == "step" and "dur" in e)
    if len(steps) < 2:
        return {}
    lo, hi = steps[1][0], steps[-1][1]
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    if not device:
        return {}
    clipped = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device]
    busy = _union(clipped)
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"]
    k6 = {}
    for kind, pattern in K6.items():
        total = sum(e["dur"] for e in device if e.get("cat") == "kernel" and pattern.search(e["name"]))
        entries = sum(1 for e in device if e.get("cat") == "kernel" and K6_ENTRY[kind].search(e["name"]))
        if entries:
            k6[kind] = dict(ms=1e-3 * total / entries, entries=entries)
    # idle gaps, each named by what the host ran at its middle: the covering
    # host op that started last (the innermost on its thread)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and "dur" in e
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    spans = [e for e in host if e.get("cat") == "user_annotation" and e["name"] in SPANS]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inner = "no host op"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i]["ts"] + host[i]["dur"] >= mid:
                inner = host[i]["name"]
                break
        outer = [e["name"] for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
        gaps[f"{outer[0] if outer else 'step'}/{inner}"] += b - a
    top = lambda d: [[_short(k), 1e-6 * v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(
        slice_s=1e-6 * (hi - lo), busy_s=1e-6 * busy_us, steps=len(steps) - 1, k6=k6,
        device_ops=top(by_name), idle_gaps=top(gaps),
    )
