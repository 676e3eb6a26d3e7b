"""Reduce the profiled slice's trace to the device's busy time, each
operation's time, each kernel group's time per entry and the idle gaps.

The slice runs from the start of the second profiled step span to the end
of the last (the first step warms the profiler). Device time is every
kernel, copy and fill; busy time is the union of their intervals inside the
slice. A kernel group (the traffic's ``kernel_groups``) gives, per kind,
its kernels' device time over the count of its entry kernel, one per call.
An idle gap is named by the harness's span that encloses it (``step``
where no other does) and the innermost host operation running at its
middle.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


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


def _group(kernels: List[dict], kinds: Dict[str, Dict[str, str]]) -> Dict[str, dict]:
    """{kind: {"ms": device ms per entry call, "entries": calls}} of the kinds
    whose entry kernel ran."""
    out = {}
    for kind, names in kinds.items():
        pattern, entry = re.compile(names["kernels"]), re.compile(names["entry"])
        total = sum(e["dur"] for e in kernels if pattern.search(e["name"]))
        entries = sum(1 for e in kernels if entry.search(e["name"]))
        if entries:
            out[kind] = dict(ms=1e-3 * total / entries, entries=entries)
    return out


def reduce(events: List[dict], groups: Dict[str, Dict[str, Dict[str, str]]],
           spans: Iterable[str]) -> Dict:
    """Summary of the slice, with ``summary[group][kind]`` for each of
    ``groups`` (``{group: {kind: {"kernels": regex, "entry": regex}}}``) and
    the idle gaps named by the harness's ``spans`` (``step`` where none
    encloses them); {} when the trace holds no step span or no device
    operation."""
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
    kernels = [e for e in device if e.get("cat") == "kernel"]
    # idle gaps, each named by what the host ran at its middle: the covering
    # host op that started last (the innermost on its thread)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and "dur" in e
                   and e["ts"] < hi and e["ts"] + e["dur"] > lo), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    names = set(spans)
    enclosing = [e for e in host if e.get("cat") == "user_annotation" and e["name"] in names]
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
        outer = [e["name"] for e in enclosing if e["ts"] <= mid <= e["ts"] + e["dur"]]
        gaps[f"{outer[0] if outer else 'step'}/{inner}"] += b - a
    top = lambda d: [[_short(k), 1e-6 * v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(
        slice_s=1e-6 * (hi - lo), busy_s=1e-6 * busy_us, steps=len(steps) - 1,
        **{group: _group(kernels, kinds) for group, kinds in groups.items()},
        device_ops=top(by_name), idle_gaps=top(gaps),
    )
