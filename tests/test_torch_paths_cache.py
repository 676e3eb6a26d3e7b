"""The frozen drift's Kuu factor, taken once per version
(``models/gp.py:frozen_chol_kuu``), and the path conditioning that reads it
(``models/pathwise.py:paths_from_noise``) on the CPU, where the conditioning
runs eager: the factor reused while no tensor it reads moves, factored again
after an in-place change or for a new model, the same paths bit for bit as a
call that factors anew, and today's route, gradient and all, wherever a
tensor of the model requires grad (held against the JAX package)."""
import copy

import jax
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models.pathwise import generate_paths_svgp as jax_generate
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.models.pathwise import PathNoise, draw_path_noise, paths_from_noise
from gpflowpilco_torch.ops import graphs
from gpflowpilco_torch.utils import tracing

from ._torch_export import CPU, jax_path_draws, jax_svgp, svgp_to_numpy, t

torch.set_num_threads(1)
CASES = {"whitened": {}, "unwhitened": dict(whiten=False), "mixed": dict(num_out=2), "shared": {}}


def _model(seed, case="whitened"):
    """A float64 SVGP of 3 latents, M=8, D=5, every tensor frozen; under
    ``shared`` one kernel hyperparameter set for the 3 latents."""
    raw = svgp_to_numpy(jax_svgp(seed, **CASES[case]))
    if case == "shared":
        raw.update(raw_variance=raw["raw_variance"][0], raw_lengthscales=raw["raw_lengthscales"][0],
                   num_outputs=3)
    return svgp_from_numpy(raw, CPU, torch.float64).requires_grad_(False)


def _noise(model, seed):
    return draw_path_noise(model, 10, 16, torch.Generator().manual_seed(seed))


def _same_bits(a, b):
    return all(torch.equal(x.detach().view(torch.int64), y.detach().view(torch.int64)) for x, y in zip(a, b))


def _factored_anew(model, noise):
    """The paths of a copy of ``model`` whose tensors require grad, so that
    its Kuu is factored in the call, as before the factor was held."""
    return paths_from_noise(copy.deepcopy(model).requires_grad_(True), noise)


def _kuu_counts():
    counts = tracing.counters()
    return counts["kuu_cache.misses"], counts["kuu_cache.hits"], counts.get("host_syncs.kuu", 0)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_frozen_drift_factors_kuu_once_and_gives_the_same_paths(case):
    """Three calls on fresh draws: the first factors (one escalation check),
    the second and the third reuse the factor; each call's paths are bit for
    bit a call that factors anew."""
    model = _model(1, case)
    tracing.reset()
    got = [paths_from_noise(model, _noise(model, k)) for k in range(3)]
    assert _kuu_counts() == (1, 2, 1)
    counts = tracing.counters()
    assert [counts[f"graphs.paths_{k}"] for k in ("eager", "captures", "replays")] == [3, 0, 0]
    for k, paths in enumerate(got):
        assert _same_bits(paths, _factored_anew(model, _noise(model, k))), k
        assert all(not x.requires_grad for x in paths)


@pytest.mark.parametrize("name", ["z", "kernel.raw_lengthscales", "kernel.raw_variance"])
def test_torch_in_place_change_to_the_frozen_drift_factors_kuu_again(name):
    """An in-place change under ``no_grad`` (a refit between episodes) to a
    tensor the factor reads makes the next call factor again, and its paths
    are those of a new model with the changed values, itself a new factor."""
    model = _model(2)
    noise = _noise(model, 5)
    before = paths_from_noise(model, noise)
    with torch.no_grad():
        model.get_parameter(name).mul_(1.1)
    tracing.reset()
    after = paths_from_noise(model, noise)
    assert _kuu_counts() == (1, 0, 1)
    fresh = copy.deepcopy(model)  # every tensor new, the values the changed model's
    assert _same_bits(after, paths_from_noise(fresh, noise))
    assert _kuu_counts() == (2, 0, 2)
    assert not torch.equal(after.v, before.v)
    assert paths_from_noise(model, noise) is not None and _kuu_counts() == (2, 1, 2)


def test_torch_change_the_factor_does_not_read_keeps_the_factor():
    """q(u) is not read by Kuu's factor: an in-place change to q_mu reuses
    the factor and the paths follow the new q_mu."""
    model = _model(3)
    noise = _noise(model, 6)
    paths_from_noise(model, noise)
    with torch.no_grad():
        model.q_mu.add_(0.25)
    tracing.reset()
    got = paths_from_noise(model, noise)
    assert _kuu_counts() == (0, 1, 0)
    assert _same_bits(got, _factored_anew(model, noise))


@pytest.mark.parametrize("name", ["z", "kernel.raw_lengthscales", "q_sqrt"])
def test_torch_drift_that_requires_grad_factors_every_call_with_its_gradient(name):
    """Where one tensor of the drift requires grad, every call factors Kuu as
    before (nothing taken from or put into the held factors), and the
    gradient of the paths' update weights to that tensor is the JAX
    package's."""
    jm = jax_svgp(4)
    model = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64).requires_grad_(False)
    model.get_parameter(name).requires_grad_(True)
    key = jax.random.PRNGKey(12)
    noise = PathNoise(**{k: t(v) for k, v in jax_path_draws(jm, key, 10, 16).items()})
    weights = np.random.default_rng(13).normal(size=(10, 3, 8))
    tracing.reset()
    for _ in range(2):
        got = paths_from_noise(model, noise)
    assert tracing.counters()["kuu_cache.misses"] == 0 and tracing.counters()["kuu_cache.hits"] == 0
    assert tracing.counters()["host_syncs.kuu"] == 2 and model.held_kuu is None
    (grad,) = torch.autograd.grad((got.v * t(weights)).sum(), [model.get_parameter(name)])
    want = jax.grad(lambda m: (jax_generate(m, key, 10, 16).v * weights).sum())(jm)
    for part in name.split("."):
        want = getattr(want, part)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-9, atol=1e-11)


def test_torch_paths_region_runs_eager_on_the_cpu():
    """Off the card the conditioning runs eager: no entry is made, and the
    step record counts no replay of either region."""
    model = _model(5)
    tracing.reset()
    with tracing.step("opt.iter"):
        paths_from_noise(model, _noise(model, 0))
    rec = tracing.steps()[-1]
    assert rec.paths_graph_replays == 0 and rec.graph_replays == 0
    assert tracing.counters()["graphs.paths_eager"] == 1 and not graphs._forward_cache.entries
