"""The cell's inputs, made on the device from ``--seed``: the drift's and the
policy's raw parameters and the seed of the steps' generator.

The drift stands for an SVGP fitted to the first random-action episodes of
the task (``_episodes``, the task's equations of motion in ``dynamics.py``):
its lengthscales are the configuration's times a factor drawn per latent and
input, and its other parameters are fitted in closed form to the episodes'
one-step deltas (``_fit_drift``). The policy is as at the start of a first
update: its inducing inputs episode states, its q_mu 1e-3 N(0, 1). Both sides of the
comparison get these same tensors; the measured package receives clones.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .dynamics import deltas

WEIGHTS, STEPS = 1, 2  # seed purposes
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def derived_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed from the run's seed (any size) and a purpose."""
    state = np.random.SeedSequence([int(seed) % 2**64, purpose])
    return int(state.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def dims(cfg: dict) -> dict:
    """The shapes a configuration fixes."""
    d, u, na = cfg["state_dim"], cfg["action_dim"], len(cfg["active_dims"])
    de = 2 * na + d - na
    return dict(S=cfg["particles"], B=cfg["bases"], D=d, U=u, De=de, Dxu=de + u,
                L=cfg["drift"]["num_latent"], M=cfg["drift"]["num_inducing"],
                Lp=cfg["policy"]["num_latent"], Mp=cfg["policy"]["num_inducing"],
                T=int(math.ceil(cfg["horizon"] / cfg["step_size"])))


def softplus_inv_shifted(value: torch.Tensor) -> torch.Tensor:
    """raw with softplus(raw) + 1e-6 = value."""
    y = value - 1e-6
    return y + torch.log(-torch.expm1(-y))


def logit_interval(value: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """raw with low + (high - low) sigmoid(raw) = value."""
    p = (value - low) / (high - low)
    return torch.log(p) - torch.log1p(-p)


def _encode(x, active):
    rest = [i for i in range(x.shape[-1]) if i not in active]
    xa = x[..., list(active)]
    return torch.cat([torch.sin(xa), torch.cos(xa), x[..., rest]], dim=-1)


def _lengthscales(gen, spec, rows, dtype, device):
    """The configuration's lengthscales times a factor drawn per row and input."""
    base = torch.as_tensor(spec["lengthscales"], dtype=dtype, device=device)
    factor = torch.exp(0.2 * torch.randn((rows, base.shape[0]), generator=gen, dtype=dtype,
                                         device=device))
    return torch.clamp(base * factor, 2 * spec["ls_low"], 0.5 * spec["ls_high"])


def _episodes(cfg: dict, gen, n: dict, dtype, device):
    """``drift.episodes`` random-action episodes of the task from the
    initial-state distribution, as a PILCO run starts: the visited states
    (N, D), the actions (N, U), each uniform on the action box, and the
    one-step deltas (N, D), in float64."""
    f64, e, t = torch.float64, cfg["drift"]["episodes"], n["T"]
    mean = torch.as_tensor(cfg["state_mean"], dtype=f64, device=device)
    tril = torch.as_tensor(cfg["state_scale_tril"], dtype=f64, device=device)
    x = mean + torch.randn((e, n["D"]), generator=gen, dtype=dtype, device=device).to(f64) @ tril.T
    acts = cfg["action_scale"] * (2.0 * torch.rand((t, e, n["U"]), generator=gen, dtype=dtype,
                                                   device=device).to(f64) - 1.0)
    states, steps = [], []
    for a in acts:
        states.append(x)
        steps.append(deltas(cfg["dynamics"], x, a, cfg["step_size"]))
        x = x + steps[-1]
    flat = lambda ts: torch.stack(ts, 1).reshape(e * t, -1)  # noqa: E731
    return flat(states), acts.transpose(0, 1).reshape(e * t, -1), flat(steps)


def _fit_drift(cfg: dict, data, gen, n: dict, dtype, device) -> dict:
    """The drift's raw parameters, fitted in closed form (float64) to the
    episodes' transitions: the inducing inputs a random subset of M of them,
    encoded; the mean constant the deltas' mean; each latent's variance its
    targets' variance and the noise ``noise_ratio`` of it; q(u) the exact
    posterior of the latent values at the inducing inputs, whitened."""
    dc, f64 = cfg["drift"], torch.float64
    states, acts, delta = data
    pick = torch.randperm(states.shape[0], generator=gen, device=device)[: n["M"]]
    z = torch.cat([_encode(states[pick], tuple(cfg["active_dims"])), acts[pick]], dim=-1)  # (M, Dxu)
    mean = delta.mean(0)
    w = None
    targets = delta[pick] - mean
    if dc["coregionalize"]:
        w = torch.eye(n["D"], n["L"], dtype=f64, device=device) + dc["mixing_std"] * torch.randn(
            (n["D"], n["L"]), generator=gen, dtype=dtype, device=device).to(f64)
        w_inv = torch.as_tensor(np.linalg.inv(w.cpu().numpy()), dtype=f64, device=device)
        targets = targets @ w_inv.T  # the latents' values under the mixing
    ls = _lengthscales(gen, dc, n["L"], dtype, device).to(f64)
    var = torch.clamp(targets.var(0), min=1e-6)  # (L,)
    sz = z[None] / ls[:, None, :]
    gram = torch.exp(-0.5 * torch.sum((sz[:, :, None] - sz[:, None, :]) ** 2, dim=-1))
    k = var[:, None, None] * gram  # (L, M, M)
    eye = torch.eye(n["M"], dtype=f64, device=device)
    luu = torch.linalg.cholesky(k + cfg["jitter"][str(dtype).split(".")[-1]] * eye)
    la = torch.linalg.cholesky(k + (dc["noise_ratio"] * var)[:, None, None] * eye)
    m_u = k @ torch.cholesky_solve(targets.T[..., None], la)  # (L, M, 1) posterior mean at Z
    s_u = k - k @ torch.cholesky_solve(k, la)  # posterior covariance at Z
    q_mu = torch.linalg.solve_triangular(luu, m_u, upper=False)[..., 0].T  # (M, L)
    s_w = torch.linalg.solve_triangular(luu, torch.linalg.solve_triangular(luu, s_u, upper=False).mT,
                                        upper=False)
    s_w = 0.5 * (s_w + s_w.mT) + 1e-8 * eye
    cast = lambda t: t.to(dtype).contiguous()  # noqa: E731
    return dict(
        raw_variance=cast(softplus_inv_shifted(var)),
        raw_lengthscales=cast(logit_interval(ls, dc["ls_low"], dc["ls_high"])),
        z=cast(z[None].repeat(n["L"], 1, 1)),
        q_mu=cast(q_mu),
        q_sqrt=cast(torch.linalg.cholesky(s_w)),
        mean_const=cast(mean),
        w=None if w is None else cast(w),
    )


def make_inputs(cfg: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, Dict[str, Optional[torch.Tensor]]]:
    """{"drift": raw parameters, "policy": raw parameters}, by the names of
    the SVGP's parameters (the kernel's without their module prefix)."""
    n = dims(cfg)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, WEIGHTS))
    kw = dict(generator=gen, dtype=dtype, device=device)
    pc = cfg["policy"]
    data = _episodes(cfg, gen, n, dtype, device)
    drift = _fit_drift(cfg, data, gen, n, dtype, device)
    pick = torch.randperm(data[0].shape[0], generator=gen, device=device)[: n["Mp"]]
    zp = _encode(data[0][pick], tuple(cfg["active_dims"])).to(dtype)
    policy = dict(
        raw_variance=softplus_inv_shifted(torch.as_tensor(pc["variance"], dtype=dtype, device=device)),
        raw_lengthscales=logit_interval(_lengthscales(gen, pc, n["Lp"], dtype, device), pc["ls_low"],
                                        pc["ls_high"]),
        z=zp[None].repeat(n["Lp"], 1, 1).contiguous(),
        q_mu=pc["q_mu_std"] * torch.randn((n["Mp"], n["Lp"]), **kw),
        q_sqrt=torch.eye(n["Mp"], dtype=dtype, device=device)[None].repeat(n["Lp"], 1, 1),
        mean_const=torch.zeros((n["U"],), dtype=dtype, device=device),
        w=torch.eye(n["U"], n["Lp"], dtype=dtype, device=device) if pc["coregionalize"] else None,
    )
    return dict(drift=drift, policy=policy)
