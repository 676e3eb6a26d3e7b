"""The particle loss's CUDA-graph machinery on the CPU: the sync-free
escalating Cholesky (ops/linalg.py:safe_cholesky_on_device) against
``safe_cholesky``, and the graph cache's plain parts (ops/graphs.py): the
region key, the eviction, the launch-count bookkeeping of a capture and its
replays, and the eager route the CPU takes. The captures and replays
themselves run only on the card (tests/test_torch_gpu.py)."""
import pytest
import torch

from gpflowpilco_torch.ops import graphs
from gpflowpilco_torch.ops.linalg import safe_cholesky, safe_cholesky_on_device
from gpflowpilco_torch.utils import tracing

JITTER = {torch.float32: 1e-4, torch.float64: 1e-6}


def _bits(t):
    """The tensor's bit patterns, every NaN as one pattern."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _batch(dtype, lowest):
    """Two 6 x 6 symmetric matrices: one well conditioned, one whose
    smallest eigenvalue is ``lowest`` (None: as healthy as the first)."""
    gen = torch.Generator().manual_seed(3)
    q, _ = torch.linalg.qr(torch.randn(2, 6, 6, dtype=torch.float64, generator=gen))
    eig = torch.tensor([[1.0, 1.5, 2.0, 2.5, 3.0, 3.5]] * 2, dtype=torch.float64)
    if lowest is not None:
        eig[1, 0] = lowest
    a = (q * eig[:, None, :]) @ q.mT
    return (0.5 * (a + a.mT)).to(dtype)


def _host_syncs():
    return sum(n for k, n in tracing.counters().items() if k.startswith("host_syncs."))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("escalations", [0, 1, 2, "all"])
def test_torch_safe_cholesky_on_device_matches_safe_cholesky(escalations, dtype):
    """Factors and gradients bit for bit ``safe_cholesky``'s, the whole batch
    at the jitter level the worst matrix needs, NaN where every attempt
    fails, and no host sync."""
    j0 = JITTER[dtype]
    # the second matrix's smallest eigenvalue: lifted by the first, the
    # second or the third jitter level (j0, 100 j0, 1e4 j0), or by none
    lowest = {0: None, 1: -0.5 * 100 * j0, 2: -0.5 * 1e4 * j0, "all": -50.0 * 1e4 * j0}[escalations]
    a = _batch(dtype, lowest)
    weights = torch.randn(a.shape, dtype=dtype, generator=torch.Generator().manual_seed(4))
    results = []
    for factor in (safe_cholesky, safe_cholesky_on_device):
        leaf = a.clone().requires_grad_(True)
        syncs = _host_syncs()
        chol = factor(leaf, j0)
        syncs = _host_syncs() - syncs
        torch.where(torch.isnan(chol), 0.0, chol * weights).sum().backward()
        results.append((chol.detach(), leaf.grad, syncs))
    (want, want_grad, want_syncs), (got, got_grad, got_syncs) = results
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(got_grad), _bits(want_grad))
    # safe_cholesky checks once per level below the last it reaches
    assert got_syncs == 0 and want_syncs == {0: 1, 1: 2, 2: 2, "all": 2}[escalations]
    level = 2 if escalations == "all" else escalations
    eye = torch.eye(6, dtype=dtype)
    # the healthy first matrix took the batch's jitter level too
    assert torch.equal(got[0], torch.linalg.cholesky(a[0] + j0 * 100.0**level * eye))
    assert torch.isnan(got[1]).all() == (escalations == "all")
    assert torch.isfinite(got[1]).all() == (escalations != "all")


def test_torch_graph_region_key_follows_addresses_not_versions():
    x0, w = torch.zeros(4, 2), torch.ones(4, 3)
    leaf = torch.nn.Parameter(torch.ones(3))
    frozen = torch.zeros(2, 2)
    key = graphs.region_key(("a",), (x0, w), (leaf, frozen))
    with torch.no_grad():
        leaf.add_(1.0)  # an optimizer's in-place step
    assert graphs.region_key(("a",), (torch.ones(4, 2), w.clone()), (leaf, frozen)) == key
    others = [
        graphs.region_key(("b",), (x0, w), (leaf, frozen)),  # another constant
        graphs.region_key(("a",), (torch.zeros(5, 2), w), (leaf, frozen)),  # another input shape
        graphs.region_key(("a",), (x0.double(), w), (leaf, frozen)),  # another input dtype
        graphs.region_key(("a",), (x0, w), (torch.nn.Parameter(leaf.detach().clone()), frozen)),
        graphs.region_key(("a",), (x0, w), (leaf.detach(), frozen)),  # no longer a leaf with grad
        graphs.region_key(("a",), (x0, w), (leaf, frozen.t())),  # another stride
    ]
    assert len({key, *others}) == len(others) + 1


def test_torch_graph_cache_keeps_the_most_recent_and_releases_the_rest():
    released = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def release(self):
            released.append(self.name)

    cache = graphs.Cache(2)
    cache.put("a", Entry("a"))
    cache.put("b", Entry("b"))
    assert cache.get("a").name == "a"  # "a" is now the most recently used
    cache.put("c", None)  # a key seen once: no entry to release
    assert released == ["b"] and list(cache.entries) == ["a", "c"]
    cache.put("d", Entry("d"))
    assert released == ["b", "a"] and list(cache.entries) == ["c", "d"]
    assert cache.get("b", "unseen") == "unseen"
    cache.clear()
    assert released == ["b", "a", "d"] and not cache.entries


def test_torch_graph_launch_counts_move_on_replays_not_on_the_capture():
    fwd, bwd = {"k_fwd": 5, "k_bwd": 5}, {"other": 1}
    dicts = [fwd, bwd]
    with graphs.held_counts(dicts) as moves:  # a capture's Python counts launches that do not run
        fwd["k_fwd"] += 1
        bwd["other"] += 2
    assert fwd == {"k_fwd": 5, "k_bwd": 5} and bwd == {"other": 1}
    assert moves == [(fwd, {"k_fwd": 1}), (bwd, {"other": 2})]
    for _ in range(3):  # each replay runs them
        graphs.add_moves(moves)
    assert fwd == {"k_fwd": 8, "k_bwd": 5} and bwd == {"other": 7}
    with pytest.raises(ValueError):
        with graphs.held_counts(dicts) as failed:
            fwd["k_bwd"] += 1
            raise ValueError("a capture that fails")
    assert fwd["k_bwd"] == 5 and failed == [(fwd, {"k_bwd": 1})]


def test_torch_graphed_runs_eager_on_the_cpu():
    module = torch.nn.Module()
    module.leaf = torch.nn.Parameter(torch.tensor([2.0, 3.0]))
    x = torch.tensor([1.0, 1.0])
    tracing.reset()
    with tracing.step("opt.iter"):
        for _ in range(3):
            out = graphs.graphed(lambda x: x * module.leaf, (x,), (module,), (), ("c",))
    out.sum().backward()
    assert torch.equal(module.leaf.grad, x) and not graphs._cache.entries
    counts = tracing.counters()
    assert (counts["graphs.eager"], counts["graphs.captures"], counts["graphs.replays"]) == (3, 0, 0)
    assert tracing.steps()[-1].graph_replays == 0


def test_torch_graph_fresh_leaves_share_storage_and_are_put_back():
    """While a capture runs, each leaf is a new leaf on its storage wherever
    the modules hold it (here twice: a shared parameter); after, the old."""
    inner = torch.nn.Linear(2, 2)
    outer = torch.nn.Sequential(inner, inner)
    frozen = torch.nn.Parameter(torch.zeros(2), requires_grad=False)
    outer.register_parameter("frozen", frozen)
    leaves = [inner.weight, inner.bias]
    with graphs.fresh_leaves([outer], leaves) as fresh:
        assert all(f is not p and f.data_ptr() == p.data_ptr() and f.requires_grad for f, p in zip(fresh, leaves))
        assert outer[0].weight is fresh[0] and outer[1].bias is fresh[1] and outer.frozen is frozen
        out = outer(torch.ones(1, 2)).sum()
        grads = torch.autograd.grad(out, fresh)
    assert outer[0].weight is leaves[0] and outer[1].bias is leaves[1]
    assert all(p.grad is None for p in leaves) and all(g.shape == p.shape for g, p in zip(grads, leaves))
