"""The PyTorch port's HMC sampler, statistically, with the bars of the JAX
package's tests/test_hmc.py: a Gaussian's moments, a GPR hyperposterior,
ChEES trajectory adaptation, and reproducibility from a generator seed."""
import numpy as np
import torch

from gpflowpilco_torch.models.gp import GPR, gpr_lml, gpr_view
from gpflowpilco_torch.models.hmc import HMCConfig, run_hmc
from gpflowpilco_torch.models.kernels import RBF
from gpflowpilco_torch.utils import bijectors as bij

torch.set_num_threads(1)
f64 = torch.float64


def _gaussian(mean, scales):
    mean, scales = torch.tensor(mean, dtype=f64), torch.tensor(scales, dtype=f64)
    return lambda q: -0.5 * torch.sum(((q - mean) / scales) ** 2, -1)


def test_torch_hmc_recovers_gaussian_moments():
    gen = torch.Generator().manual_seed(21)
    log_prob = _gaussian([1.0, -2.0, 0.5], [0.5, 1.5, 1.0])
    init = torch.randn((8, 3), generator=gen, dtype=f64)
    res = run_hmc(log_prob, init, gen, HMCConfig(num_warmup=400, num_samples=600, num_leapfrog=8))
    xs = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(xs.mean(0), [1.0, -2.0, 0.5], atol=0.1)
    np.testing.assert_allclose(xs.std(0), [0.5, 1.5, 1.0], rtol=0.15)
    accept = float(res.accept_prob.mean())
    assert 0.5 < accept <= 1.0, accept
    assert res.samples.shape == (600, 8, 3) and torch.isfinite(res.final_logp).all()


def test_torch_hmc_gpr_hyperposterior():
    """Chains over a GPR's raw (variance, lengthscales, noise), batched
    through a stacked view of the model: the noise posterior concentrates
    near the true 0.1^2."""
    rng = np.random.default_rng(23)
    x = torch.as_tensor(rng.uniform(-2, 2, size=(40, 2)), dtype=f64)
    y = torch.sin(x[:, :1]) + 0.1 * torch.as_tensor(rng.normal(size=(40, 1)), dtype=f64)
    model = GPR(RBF(torch.zeros((), dtype=f64), torch.zeros(2, dtype=f64)), x, y,
                torch.zeros(1, dtype=f64), bij.positive_inv(torch.tensor(0.1, dtype=f64)))
    model.mean_const.requires_grad_(False)
    names = [n for n, _ in model.named_parameters()]
    assert names == ["mean_const", "raw_noise", "kernel.raw_variance", "kernel.raw_lengthscales"]

    def log_prob(q):  # q (C, 4): noise, variance, lengthscales; the mean stays 0
        full = torch.cat([torch.zeros_like(q[:, :1]), q], -1)
        lml = gpr_lml(gpr_view(model, full))
        return lml - 0.5 * torch.sum((q / 3.0) ** 2, -1)  # weak N(0, 3^2) prior

    gen = torch.Generator().manual_seed(24)
    init = torch.zeros((4, 4), dtype=f64)
    init[:, 0] = float(model.raw_noise.detach())
    res = run_hmc(log_prob, init, gen, HMCConfig(num_warmup=150, num_samples=150, num_leapfrog=8))
    assert torch.isfinite(res.final_logp).all()
    accept = float(res.accept_prob.mean())
    assert 0.4 < accept <= 1.0, accept
    med = float(torch.median(bij.positive(res.samples[..., 0])))
    assert 0.002 < med < 0.05, med


def test_torch_chees_hmc_adapts_trajectory_and_recovers_moments():
    gen = torch.Generator().manual_seed(29)
    log_prob = _gaussian([0.0, 0.0, 0.0], [10.0, 1.0, 0.1])
    init = torch.randn((16, 3), generator=gen, dtype=f64)
    cfg = HMCConfig(num_warmup=500, num_samples=500, adapt_trajectory="chees", max_leapfrog=128,
                    init_step_size=0.05)
    res = run_hmc(log_prob, init, gen, cfg)
    xs = res.samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(xs.mean(0), np.zeros(3), atol=0.6)
    np.testing.assert_allclose(xs.std(0), [10.0, 1.0, 0.1], rtol=0.25)
    accept = float(res.accept_prob.mean())
    assert 0.5 < accept <= 1.0, accept
    assert float(res.trajectory_length) > 2.0, float(res.trajectory_length)


def test_torch_hmc_is_reproducible_from_a_seed():
    log_prob = _gaussian([0.0, 1.0], [1.0, 2.0])
    runs = []
    for seed in (5, 5, 6):
        gen = torch.Generator().manual_seed(seed)
        init = torch.randn((3, 2), generator=gen, dtype=f64)
        runs.append(run_hmc(log_prob, init, gen, HMCConfig(num_warmup=20, num_samples=20, num_leapfrog=5)))
    assert torch.equal(runs[0].samples, runs[1].samples)
    assert torch.equal(runs[0].accept_prob, runs[1].accept_prob)
    assert not torch.equal(runs[0].samples, runs[2].samples)
