"""Spans and counters of the port's hot path, held in memory.

``span(name)``, a context manager or a decorator, records its name and its
start and end on ``time.perf_counter_ns``; spans nest, so each has the span
it opened under as its parent.
``step(name)`` opens a step record and its top span: ``adam_minimize`` and
``adam_minimize_multistart`` open one each iteration (``opt.iter``), so
every span of an optimizer step shares the record's step id, and the
candidate's index under the multistart. The last ``RING`` records are held
in about 7 MB, each with up to ``SLOTS`` spans; a span beyond that is
dropped and counted. A span opened while no step is open is not held; it
still times itself (``seconds``) and reaches a profiler's trace.

While a torch profiler is active, each span also enters
``record_function(name)``, so the port's spans sit in the profiler's Chrome
trace beside the device's events, on its clock, and the step record is
marked ``profiled``. With no profiler active the cost is the clock reads and
the array writes.

The store is written by one thread at a time, with no lock: the open spans
form one stack, whatever thread opens them, and a span opened on another
thread joins the open step under its innermost open span. That is the span
that waits for the thread, as ``opt.backward`` waits in ``backward()``
while autograd runs a CUDA backward (``k6.bwd``) on its device thread. Two
threads must not hold spans open, or sync, at once.

``host_sync(site, flag)`` is the one read in a step's path that waits for
the device: it returns ``bool(flag)``, counts the read under ``site`` and in
the open step's record, and times the wait in a ``sync.<site>`` span. The
kernel modules' ``launches`` dicts are registered here, so ``counters()``
shows them beside the host syncs under their own keys. ``graph_event(kind)``
counts the CUDA graphs of ``ops/graphs.py``, shown as ``graphs.<kind>``: the
particle loss's ``captures``, ``replays`` (forward replays, also counted in
the open step's record as ``graph_replays``) and ``eager`` calls, and the
path conditioning's ``paths_captures``, ``paths_replays`` (in the record as
``paths_graph_replays``) and ``paths_eager``. ``kuu_cache_event(kind)``
counts the frozen drift's Kuu factor taken from its cache (``hits``) or
factored (``misses``; ``models/gp.py:frozen_chol_kuu``), shown as
``kuu_cache.<kind>``.

    from gpflowpilco_torch.utils import tracing
    tracing.steps()[-1].spans      # the newest step's span tree
    tracing.counters()             # host syncs by site, kernel launches by entry
"""
from __future__ import annotations

import array
import collections
import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

RING = 16384  # step records held
SLOTS = 20  # spans a step record holds
# graph_event's kinds: the particle loss's, then the path conditioning's
GRAPH_EVENTS = ("captures", "replays", "eager", "paths_captures", "paths_replays", "paths_eager")
KUU_CACHE_EVENTS = ("hits", "misses")  # kuu_cache_event's kinds

_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    parent: int  # index of the parent in the step's spans, -1 for the top
    start_ns: int
    end_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Step(NamedTuple):
    step: int  # monotonic id, from 1 in the process
    candidate: int  # index under adam_minimize_multistart, -1 elsewhere
    profiled: bool  # a torch profiler was active during the step
    aborted: bool  # the step ended by an exception
    host_syncs: int
    dropped: int  # spans beyond SLOTS, not held
    spans: Tuple[Span, ...]  # in the order they opened
    graph_replays: int  # forward replays of the particle loss's CUDA graph
    paths_graph_replays: int = 0  # replays of the path conditioning's CUDA graph (0 if not given)


class _Store:
    """The ring of step records, the open spans and the counters."""

    def __init__(self):
        self.names: List[str] = []
        self.table: Dict[str, "_Span"] = {}
        self.launches: List[Dict[str, int]] = []
        self.lock = threading.Lock()
        # per span slot (record x SLOTS + slot): start << 8 | name id, and end, in ns
        self.start = array.array("q", bytes(8 * RING * SLOTS))
        self.end = array.array("q", bytes(8 * RING * SLOTS))
        self.reset()

    def reset(self):
        # per record, written as its step closes: (step id, candidate, profiled,
        # aborted, host syncs, spans held, spans dropped, graph replays, path
        # graph replays)
        self.closed: List[Optional[tuple]] = [None] * RING
        self.seq = 0  # the newest step's id
        self.cur = -1  # ring index of the open step, -1 for none
        self.slots = iter(())  # the open step's free slots; none outside a step
        self.dropped = 0  # the open step's spans beyond its slots
        self.profiled = False  # a profiler was active in the open step
        # the slot of each open span (-1 if not held), innermost last, each
        # followed by its record_function where a profiler was active
        self.open: list = []
        self.push, self.pop = self.open.append, self.open.pop
        self.site_syncs: Dict[str, int] = collections.defaultdict(int)
        self.synced = 0  # host syncs in all
        self.graphs = dict.fromkeys(GRAPH_EVENTS, 0)
        self.kuu = dict.fromkeys(KUU_CACHE_EVENTS, 0)

    def record(self, index: int) -> Step:
        """The closed record ``index``. Spans nest (one stack), so a span's
        parent is the latest opened before it that ends no earlier."""
        seq, candidate, profiled, aborted, syncs, n, dropped, replays, paths = self.closed[index]
        base = index * SLOTS
        spans: List[Span] = []
        outer: List[int] = []
        for k in range(base, base + n):
            start, end = self.start[k], self.end[k]
            while outer and spans[outer[-1]].end_ns < end:
                outer.pop()
            spans.append(Span(self.names[start & 255], outer[-1] if outer else -1, start >> 8, end))
            outer.append(len(spans) - 1)
        return Step(seq, candidate, profiled, aborted, syncs, dropped, tuple(spans), replays, paths)


_store = _Store()


class _Span:
    """One name's span: a context manager, and a decorator (``__call__``)."""

    __slots__ = ("id", "name", "t0", "t1")

    def __init__(self, name: str, index: int):
        self.name, self.id = name, index
        self.t0 = self.t1 = 0

    def __enter__(self) -> "_Span":
        s = _store
        k = next(s.slots, -1)
        if k < 0 and s.cur >= 0:
            s.dropped += 1
        s.push(k)
        if _profiling():
            rf = record_function(self.name)
            rf.__enter__()
            s.push(rf)
            s.profiled = True
        self.t0 = t0 = _now()
        if k >= 0:
            s.start[k] = t0 << 8 | self.id
        return self

    def __exit__(self, *exc):
        self.t1 = t1 = _now()
        s = _store
        k = s.pop()
        if k.__class__ is not int:  # the span's record_function
            k.__exit__(None, None, None)
            k = s.pop()
        if k >= 0:
            s.end[k] = t1
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return wrapped

    @property
    def seconds(self) -> float:
        """The length of the span's latest closing."""
        return 1e-9 * (self.t1 - self.t0)


def span(name: str) -> _Span:
    """``with span(name):`` or ``@span(name)``: time the block, or each call."""
    try:
        return _store.table[name]
    except KeyError:
        with _store.lock:
            if name not in _store.table:
                if len(_store.names) == 256:
                    raise ValueError(f"tracing holds 256 span names; {name!r} is one more") from None
                _store.table[name] = _Span(name, len(_store.names))
                _store.names.append(name)
        return _store.table[name]


class step:
    """``with step(name, candidate):``: a step record, its top span ``name``.
    One object serves a loop's iterations in turn."""

    __slots__ = ("top", "candidate", "saved", "seq", "synced", "replayed", "paths_replayed")

    def __init__(self, name: str, candidate: int = -1):
        self.top = span(name)
        self.candidate = candidate

    def __enter__(self) -> "step":
        s = _store
        self.saved = s.cur, s.slots, s.dropped, s.profiled
        s.seq = self.seq = s.seq + 1
        rec = s.cur = self.seq % RING
        s.slots, s.dropped = iter(range(rec * SLOTS, (rec + 1) * SLOTS)), 0
        s.profiled = _profiling()
        self.synced, self.replayed, self.paths_replayed = s.synced, s.graphs["replays"], s.graphs["paths_replays"]
        self.top.__enter__()
        return self

    def __exit__(self, exc_type, *exc):
        self.top.__exit__()
        s = _store
        s.closed[s.cur] = (self.seq, self.candidate, s.profiled or _profiling(), exc_type is not None,
                           s.synced - self.synced, SLOTS - s.slots.__length_hint__(), s.dropped,
                           s.graphs["replays"] - self.replayed, s.graphs["paths_replays"] - self.paths_replayed)
        s.cur, s.slots, s.dropped, s.profiled = self.saved
        return False


def host_sync(site: str, flag: torch.Tensor) -> bool:
    """``bool(flag)``: the host waits for the device. Counted under ``site``
    and in the open step, and timed by a ``sync.<site>`` span."""
    with span("sync." + site):
        value = bool(flag)
    s = _store
    s.site_syncs[site] += 1
    s.synced += 1
    return value


def graph_event(kind: str) -> None:
    """Count one of ``GRAPH_EVENTS``: a capture, a forward replay (counted in
    the open step's record too) or an eager call of a graphed region."""
    _store.graphs[kind] += 1


def kuu_cache_event(kind: str) -> None:
    """Count one of ``KUU_CACHE_EVENTS``: a frozen drift's Kuu factor reused
    or factored."""
    _store.kuu[kind] += 1


def register_launches(counts: Dict[str, int]) -> Dict[str, int]:
    """Show a kernel module's launch counts in ``counters()``; returns them."""
    _store.launches.append(counts)
    return counts


def launch_counts() -> List[Dict[str, int]]:
    """The registered launch-count dicts, in registration order."""
    return list(_store.launches)


def steps() -> List[Step]:
    """The closed step records held, oldest first."""
    s = _store
    out = []
    for seq in range(max(1, s.seq - RING + 1), s.seq + 1):
        i = seq % RING
        if s.closed[i] is not None and s.closed[i][0] == seq:
            out.append(s.record(i))
    return out


def counters() -> Dict[str, int]:
    """``host_syncs.<site>`` for each site that has synced, ``graphs.<kind>``
    for each of ``GRAPH_EVENTS``, ``kuu_cache.<kind>`` for each of
    ``KUU_CACHE_EVENTS``, and every registered launch count under its own
    key."""
    out = {f"host_syncs.{site}": n for site, n in sorted(_store.site_syncs.items())}
    out.update({f"graphs.{kind}": n for kind, n in _store.graphs.items()})
    out.update({f"kuu_cache.{kind}": n for kind, n in _store.kuu.items()})
    for counts in _store.launches:
        out.update(counts)
    return out


def reset():
    """Drop the held records, the host-sync, graph and Kuu-cache counts, with no
    span open (launch counts are the kernel modules', reset by
    ``reset_launches``)."""
    _store.reset()
