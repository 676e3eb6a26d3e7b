"""CUDA graphs over regions of the policy step: the particle loss
(``models/pathwise.py:pathwise_rollout_loss_fused``), from the policy's
leaves to the per-particle costs, and, forward only, the path conditioning
of a frozen drift (``models/pathwise.py:paths_from_noise``).

``graphed(fn, inputs, modules, tensors, consts)`` returns ``fn(*inputs)``. On
the card, with grad enabled and a parameter of ``modules`` that requires it
(the leaves), the region becomes two CUDA graphs, after the pattern of
``torch.cuda.make_graphed_callables``: the forward graph runs ``fn``, the
backward graph the VJP of its output back to the leaves, and an
``autograd.Function`` replays them, so ``loss.backward()`` replays the
backward graph and autograd accumulates its gradients into ``p.grad``.

- ``inputs`` are copied into static buffers before each forward replay;
  everything else ``fn`` reads (the reads: the modules' parameters and
  buffers, ``tensors``) is read in place, so Adam's in-place updates reach
  the graph. ``fn`` must draw no random numbers and read no other tensor.
- A region is keyed by ``consts`` (the Python values ``fn`` bakes in), the
  inputs' shapes, dtypes and device, the modules' tensor names, and the
  address, shape, stride, dtype and ``requires_grad`` of every read, not
  their version counters, which every Adam step moves. The first call on a
  key runs eager (it warms the libraries and the kernels up); the second
  warms up once more on a side stream, captures both graphs there and
  replays; later calls replay. The ``MAX_ENTRIES`` most recently used keys
  are kept, each with its own memory pool, and the entry of the least
  recently used is dropped with its pool. An entry holds the tensors it
  reads, so no other tensor takes their addresses.
- Eager, as before: off the card or off the current device, with grad
  disabled, and where no leaf requires grad or an input or one of
  ``tensors`` does (the region then raises or differentiates as before).
- While it warms up and captures, each leaf is swapped in its module for a
  new leaf on the same storage (``fresh_leaves``): the autograd nodes an
  earlier step's graph may still hold for the leaves were made on another
  stream, and a backward into them would make that stream wait on the
  capture, which breaks it.
- The costs are handed out as a clone, and the gradients as clones, never
  the static buffers. A backward after the region's next forward replay,
  or after an in-place change to a tensor it reads, raises, as autograd
  does for a saved tensor changed in place.

Counts stay honest: a capture runs no kernel, so what its Python adds to the
launch dicts (``tracing.register_launches``) is taken back out and added on
each replay instead (``held_counts``, ``add_moves``). ``tracing.graph_event``
counts captures, forward replays and eager calls; the replays open the spans
``graph.fwd`` (input copies and replay) and ``graph.bwd`` (on autograd's
device thread), and a capture ``graph.capture``.

``replayed(fn, inputs, tensors, consts)`` is the forward-only sibling, for
the path conditioning, which no gradient passes through: on the card, where
the inputs and ``tensors`` lie on the current device and none requires grad,
``fn(*inputs)`` is one CUDA graph, keyed as above in a cache of its own,
eager on a key's first call, warmed up and captured on its second. Its inputs
are copied in, ``tensors`` read in place, its outputs handed out as clones.
It opens no span of its own (the caller's ``paths.condition`` holds it) and
counts ``paths_captures``, ``paths_replays`` (in the step record too) and
``paths_eager``.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils import tracing

# Captured regions kept. A multistart update runs its candidates one after
# another on fresh copies, so no candidate's key comes back once the next
# starts; two keys come back where two policies take turns, as a sharded
# step and the plain one it is checked against (chip_smoke.py, scale-out).
MAX_ENTRIES = 2
# Forward-only regions kept, apart from the loss's: a multistart's candidates
# share one drift, so one entry serves them; two where two drifts take turns.
FORWARD_ENTRIES = 2

Moves = List[Tuple[Dict[str, int], Dict[str, int]]]  # (launch dict, its keys' increments)


# --------------------------------------------------------- launch bookkeeping
@contextlib.contextmanager
def held_counts(dicts: Sequence[Dict[str, int]]):
    """Undo what the block adds to the launch-count ``dicts``, even when it
    raises; yields a list that receives the moves (``add_moves`` replays
    them)."""
    before = [dict(d) for d in dicts]
    moves: Moves = []
    try:
        yield moves
    finally:
        for d, was in zip(dicts, before):
            moved = {k: n - was.get(k, 0) for k, n in d.items() if n != was.get(k, 0)}
            if moved:
                moves.append((d, moved))
            d.clear()
            d.update(was)


def add_moves(moves: Moves) -> None:
    """Add each recorded move to its launch dict."""
    for d, moved in moves:
        for k, n in moved.items():
            d[k] += n


@contextlib.contextmanager
def fresh_leaves(modules: Sequence[torch.nn.Module], leaves: Sequence[torch.Tensor]):
    """Swap each of ``leaves`` wherever ``modules`` hold it as a parameter for
    a new leaf parameter on its storage while the block runs; yields the new
    leaves in ``leaves``' order."""
    fresh = {id(p): torch.nn.Parameter(p.detach()) for p in leaves}
    swapped = []
    try:
        for module in modules:
            for sub in module.modules():
                for name, p in sub._parameters.items():
                    if p is not None and id(p) in fresh:
                        swapped.append((sub, name, p))
                        sub._parameters[name] = fresh[id(p)]
        yield [fresh[id(p)] for p in leaves]
    finally:
        for sub, name, p in swapped:
            sub._parameters[name] = p


# --------------------------------------------------------- keys and the cache
def region_key(consts: tuple, inputs: Sequence[torch.Tensor], reads: Sequence[torch.Tensor]) -> tuple:
    """What a captured region depends on: its Python constants, the copied
    inputs' shapes and dtypes, and where and how each tensor read in place
    lies in memory."""
    return (consts, inputs[0].device,
            tuple((t.shape, t.dtype) for t in inputs),
            tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.requires_grad) for t in reads))


class Cache:
    """The ``size`` most recently used entries by key; an entry pushed out
    is ``release``d."""

    def __init__(self, size: int):
        self.size = size
        self.entries: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()

    def get(self, key, default=None):
        entry = self.entries.get(key, default)
        if key in self.entries:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.size:
            _, old = self.entries.popitem(last=False)
            if old is not None:
                old.release()

    def clear(self) -> None:
        while self.entries:
            _, old = self.entries.popitem()
            if old is not None:
                old.release()


_cache = Cache(MAX_ENTRIES)
_forward_cache = Cache(FORWARD_ENTRIES)
_UNSEEN = object()


def clear() -> None:
    """Drop every captured region and its memory pool."""
    _cache.clear()
    _forward_cache.clear()


# --------------------------------------------------------- the two graphs
class Graphs:
    """One captured region: static inputs, the forward and backward graphs,
    the static output, its cotangent and the leaves' gradients."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], modules: Sequence[torch.nn.Module],
                 reads: Sequence[torch.Tensor], leaves: Sequence[torch.Tensor]):
        device = inputs[0].device
        self.reads = tuple(reads)
        self.inputs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in inputs]
        for s, t in zip(self.inputs, inputs):
            s.copy_(t)
        stream = torch.cuda.Stream(device)
        dicts = tracing.launch_counts()
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            # the warm-up PyTorch asks for, on the capture stream
            with torch.cuda.stream(stream), fresh_leaves(modules, leaves) as fresh:
                out = fn(*self.inputs)
                torch.autograd.grad(out, fresh, torch.ones_like(out), allow_unused=True)
                del out
            torch.cuda.synchronize()
            pool = torch.cuda.graph_pool_handle()
            self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with fresh_leaves(modules, leaves) as fresh:
                with held_counts(dicts) as self.fwd_moves:
                    with torch.cuda.graph(self.fwd, pool=pool, stream=stream):
                        costs = fn(*self.inputs)
                self.grad_out = torch.empty_like(costs)
                with held_counts(dicts) as self.bwd_moves:
                    with torch.cuda.graph(self.bwd, pool=pool, stream=stream):
                        self.grads = torch.autograd.grad(costs, fresh, self.grad_out, allow_unused=True)
        self.costs = costs.detach()
        self.replays = 0
        self.versions: List[int] = []

    def forward(self, inputs: Sequence[torch.Tensor]) -> int:
        """Copy ``inputs`` in and replay the forward graph; returns the
        replay's number."""
        with tracing.span("graph.fwd"):
            for s, t in zip(self.inputs, inputs):
                s.copy_(t)
            self.fwd.replay()
        add_moves(self.fwd_moves)
        tracing.graph_event("replays")
        self.replays += 1
        self.versions = [t._version for t in self.reads]
        return self.replays

    def backward(self, replay: int, grad: torch.Tensor) -> List:
        """The leaves' gradients for the cotangent ``grad`` of forward replay
        ``replay``, by a backward replay."""
        if self.bwd is None or replay != self.replays:
            raise RuntimeError("the particle loss's CUDA graph ran another forward (or was dropped) "
                               "before this backward; its saved state is gone")
        if [t._version for t in self.reads] != self.versions:
            raise RuntimeError("a tensor the particle loss's CUDA graph reads was modified in place "
                               "between its forward and its backward")
        with tracing.span("graph.bwd"):
            self.grad_out.copy_(grad)
            self.bwd.replay()
            out = [None if g is None else g.clone() for g in self.grads]
        add_moves(self.bwd_moves)
        return out

    def release(self) -> None:
        """Free the graphs and, with them, their memory pool."""
        for g in (self.fwd, self.bwd):
            g.reset()
        self.fwd = self.bwd = None
        self.inputs = self.grads = self.costs = self.grad_out = self.reads = None


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graphs: Graphs, inputs, *leaves):
        ctx.graphs = graphs
        ctx.replay = graphs.forward(inputs)
        return graphs.costs.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return (None, None, *ctx.graphs.backward(ctx.replay, grad))


def _engaged(inputs: Sequence[torch.Tensor], leaves: Sequence[torch.Tensor],
             tensors: Sequence[torch.Tensor]) -> bool:
    device = inputs[0].device
    return (device.type == "cuda" and bool(leaves) and torch.is_grad_enabled()
            and device.index == torch.cuda.current_device()
            and not any(t.requires_grad for t in (*inputs, *tensors)))


def graphed(fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
            modules: Sequence[torch.nn.Module], tensors: Sequence[torch.Tensor], consts: tuple) -> torch.Tensor:
    """``fn(*inputs)``, replayed from CUDA graphs where the module docstring
    says. ``fn`` reads, beside ``inputs``, the parameters and buffers of
    ``modules`` and ``tensors``; the modules' parameters that require grad
    are the leaves the backward graph differentiates."""
    named = [nt for m in modules for nt in (*m.named_parameters(), *m.named_buffers())]
    reads = [t for _, t in named] + list(tensors)
    leaves = [t for _, t in named if t.requires_grad]
    if not _engaged(inputs, leaves, tensors):
        tracing.graph_event("eager")
        return fn(*inputs)
    key = region_key((consts, tuple(n for n, _ in named)), inputs, reads)
    entry = _cache.get(key, _UNSEEN)
    if entry is _UNSEEN:  # the first call on the key: eager
        _cache.put(key, None)
        tracing.graph_event("eager")
        return fn(*inputs)
    if entry is None:
        with tracing.span("graph.capture"):
            entry = Graphs(fn, inputs, modules, reads, leaves)
        tracing.graph_event("captures")
        _cache.put(key, entry)
    return _Replay.apply(entry, tuple(inputs), *leaves)


# --------------------------------------------------------- forward only
class Forward:
    """One captured forward-only region: static inputs, the graph and its
    static outputs."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], reads: Sequence[torch.Tensor]):
        device = inputs[0].device
        self.reads = tuple(reads)
        self.inputs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in inputs]
        for s, t in zip(self.inputs, inputs):
            s.copy_(t)
        stream = torch.cuda.Stream(device)
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            with torch.cuda.stream(stream):  # the warm-up PyTorch asks for, on the capture stream
                fn(*self.inputs)
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=stream):
                self.outputs = tuple(fn(*self.inputs))

    def __call__(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        for s, t in zip(self.inputs, inputs):
            s.copy_(t)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)

    def release(self) -> None:
        """Free the graph and, with it, its memory pool."""
        self.graph.reset()
        self.graph = self.inputs = self.outputs = self.reads = None


def replayed(fn: Callable[..., Tuple[torch.Tensor, ...]], inputs: Sequence[torch.Tensor],
             tensors: Sequence[torch.Tensor], consts: tuple) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs)``, a tuple of tensors, replayed from one forward-only
    CUDA graph where the module docstring says. ``fn`` reads, beside
    ``inputs``, only ``tensors``, and draws no random numbers."""
    device = inputs[0].device
    engaged = (device.type == "cuda" and device.index == torch.cuda.current_device()
               and all(t.device == device and not t.requires_grad for t in (*inputs, *tensors)))
    if not engaged:
        tracing.graph_event("paths_eager")
        return fn(*inputs)
    key = region_key(consts, inputs, tensors)
    entry = _forward_cache.get(key, _UNSEEN)
    if entry is _UNSEEN:  # the first call on the key: eager
        _forward_cache.put(key, None)
        tracing.graph_event("paths_eager")
        return fn(*inputs)
    if entry is None:
        with tracing.span("graph.capture"):
            entry = Forward(fn, inputs, tensors)
        tracing.graph_event("paths_captures")
        _forward_cache.put(key, entry)
    tracing.graph_event("paths_replays")
    return entry(inputs)
