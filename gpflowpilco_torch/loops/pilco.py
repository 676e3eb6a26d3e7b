"""Pathwise and moment-matching PILCO (counterpart of gpflowpilco_tpu/loops/pilco.py).

Ported: the data plumbing, the SVGP drift (one latent per output, or
coregionalized: a (P, L) mixing matrix over L latent GPs, optionally with one
shared kernel) fit by L-BFGS (with zero-weight padding rows, the refit from
the incumbent and per-output noise), by minibatched Adam on the stochastic
ELBO, or by exact natural-gradient steps on q(u) alternating with Adam on the
hyperparameters (``DriftSpec.optimizer`` 'lbfgs', 'adam', 'natgrad_adam'), the exact
GPR drift fit by L-BFGS and, with ``DriftSpec(model_type="gpr",
optimizer="hmc")``, HMC over its hyperparameters thinned to a
``GPREnsemble``, the optimism noise floor, the single-start and multistart
Adam policy updates, the real-environment step with its random first
episodes and the retain-best acting gate, checkpoints, the step and unroll
hooks, ``PathwisePILCO``'s SVGP particle loss (its drift evaluation goes
through the CUDA kernel op ops/path_eval_cuda.py under
``use_fused_paths``), and
``MomentMatchingPILCO``'s SVGP moment-matched loss (its eKuffu pair grid
goes through the CUDA kernel op ops/kexp_cuda.py under ``use_fused_mm``;
under ``use_fused_match`` the whole drift and policy matches, the encoder
match, the PSD guard and the Euler update go through the kernel ops of
ops/mm_match_cuda.py, ops/enc_match_cuda.py and ops/mm_glue_cuda.py), and
both losses for GPR and GPREnsemble drifts (the MM drift match through
ops/kexp_cuda.py's GPR grid or the GPR whole-match kernel op of
ops/gpr_match_cuda.py; the pathwise GPR paths in plain torch, as in the JAX
package). An ensemble's members ride one rollout as its batch axis. Under
``use_fused_rollout`` the whole pathwise rollout loss, for SVGP, GPR and
ensemble drifts, is one kernel op (ops/rollout_cuda.py, its operands packed
from the models by models/pathwise.py).

Models are ``nn.Module``s trained in place. Randomness comes from
``torch.Generator``s seeded from (seed, number of episodes, purpose), the
counterpart of the JAX package's per-iteration key folds.

As in the JAX package, ``PathwisePILCO`` runs its loss in the loop dtype
whatever ``PolicySpec.loss_dtype`` says (that option only keeps the loss
off the fused rollout), and evaluates its SVGP paths through the path-eval
kernel op (float32 or float64, the loop dtype) only under ``use_fused_paths``.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import math
import os
import pickle
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from ..components import Encoder, GaussianObjective
from ..config import default_device
from ..convert import model_from_numpy, model_to_numpy
from ..dynamics.forward import forward_concrete, forward_moments
from ..dynamics.solvers import euler_rollout, moment_matching_euler_rollout
from ..envs.base import env_step
from ..envs.base import rollout as env_rollout
from ..models.builders import build_gpr, build_svgp, dynamics_mask, gpr_mask, policy_mask
from ..models.gp import (
    GPR,
    SVGP,
    GPREnsemble,
    gpr_lml,
    gpr_predict_f,
    gpr_stack,
    gpr_view,
    svgp_elbo,
    svgp_predict_f,
)
from ..models.hmc import HMCConfig, run_hmc
from ..models.natgrad import natgrad_step
from ..models.pathwise import (
    PathwiseGPRTransform,
    PathwiseSVGPTransform,
    generate_paths_gpr,
    generate_paths_svgp,
    pathwise_rollout_loss_fused,
)
from ..models.priors import pilco_snr_penalty
from ..moment_matching.gp import GPRTransform, SVGPTransform
from ..moment_matching.rules import SinCos, SquashedProbit
from ..moments import Chain, DtypeIsland, GaussianMoments
from ..utils import bijectors as bij
from ..utils.optimizers import (
    adam_minimize,
    adam_minimize_multistart,
    lbfgs_minimize,
    make_policy_schedule,
)
from .core import EpisodeData, EpisodeSpec, stack_episodes

# generator purposes (the JAX package's fold_in salts play this role)
_DYNAMICS, _POLICY_INIT, _POLICY_OPT, _STEP, _HMC, _EXPECTED_REWARD = 0, 1, 2, 7, 11, 23
_VALIDATION, _RESTART = 99, 1000
_MINIBATCH = 3  # index of the drift's minibatch draws under _DYNAMICS
_SVGP_OPTIMIZERS = ("lbfgs", "adam", "natgrad_adam")

logger = logging.getLogger("gpflowpilco_torch.pilco")


def _cast_module(module: torch.nn.Module, dtype: Optional[torch.dtype]) -> torch.nn.Module:
    """A view of ``module`` whose floating parameters are cast to ``dtype``,
    the casts in the autograd graph, so gradients reach the original
    parameters (the counterpart of the JAX package's _cast_floats on a model
    pytree). The module itself when ``dtype`` is None or already its own."""
    if dtype is None or all(
        t.dtype == dtype for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()
    ):
        return module
    view = copy.copy(module)  # a new __dict__ holding the same entries
    view._parameters = {
        name: None if p is None else (p.to(dtype) if p.is_floating_point() else p)
        for name, p in module._parameters.items()
    }
    view._buffers = {
        name: None if b is None else (b.to(dtype) if b.is_floating_point() else b)
        for name, b in module._buffers.items()
    }
    view._modules = {name: _cast_module(m, dtype) for name, m in module._modules.items()}
    return view


def _same_structure(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    """True when two models have the same parameter names, shapes and dtypes."""
    pa = [(n, p.shape, p.dtype) for n, p in a.named_parameters()]
    pb = [(n, p.shape, p.dtype) for n, p in b.named_parameters()]
    return pa == pb


@dataclasses.dataclass(frozen=True)
class DriftSpec:
    """Dynamics-model build/train options: ``model_type='svgp'`` with
    ``optimizer`` 'lbfgs', 'adam' (minibatched ELBO) or 'natgrad_adam'
    (exact conjugate natural-gradient updates of q(u) alternating with Adam
    on the hyperparameters), and ``model_type='gpr'`` with 'lbfgs' or
    'hmc'."""

    reinitialize: bool = True
    model_type: str = "svgp"
    num_centers: int = 256
    noise_variance: float = 1.0
    # per-output (P,) SVGP likelihood noise, each output's initial noise
    # scaled by its target's variance, instead of one shared scalar: a
    # shared floor rises to the largest output's residual and erases the
    # small outputs' signal
    per_output_noise: bool = False
    # when reinitializing, also fit from the previous episode's parameters
    # and keep the better ELBO (guards against bad-basin from-scratch refits)
    refit_from_incumbent: bool = True
    snr_threshold: float = 1e5
    snr_power: float = 30.0
    max_iters: int = 1000
    lbfgs_tol: float = 1e-5
    # 'lbfgs' | 'adam' | 'natgrad_adam' (SVGP) | 'hmc' (GPR)
    optimizer: str = "lbfgs"
    # natgrad_adam: the natural-gradient step size on q(u) (1 is the exact
    # conjugate update) and Adam's learning rate on the hyperparameters
    natgrad_gamma: float = 1.0
    hyper_lr: float = 0.05
    # adam: rows per with-replacement minibatch and the learning rate
    batch_size: int = 1024
    adam_lr: float = 0.01
    # pad the training set to a multiple of this with zero-weight rows (0 disables)
    pad_data_multiple: int = 240
    ls_low: float = 0.01
    ls_high: float = 100.0
    # pessimistic refit: when the last episode's model-predicted reward
    # (eReward) beat its realized reward by more than this, each output's
    # fitted likelihood noise is floored at optimism_noise_mult x the
    # incumbent drift's held-out MSE on that episode's transitions (SVGP and
    # GPR drifts; never an HMC ensemble). 0 disables.
    optimism_tolerance: float = 0.0
    optimism_noise_mult: float = 1.0
    # HMC posterior over GPR hyperparameters (requires model_type='gpr'):
    # chains start around the L-BFGS MAP fit and are thinned to an ensemble
    # of hmc_ensemble hyperparameter draws
    hmc_chains: int = 8
    hmc_warmup: int = 200
    hmc_samples: int = 200
    hmc_leapfrog: int = 16
    hmc_step_size: float = 0.02
    hmc_ensemble: int = 8
    hmc_init_jitter: float = 0.05
    # 'jitter' (fixed-cap random trajectories) or 'chees' (adapted
    # integration time, at most 4 * hmc_leapfrog steps)
    hmc_adapt: str = "jitter"
    # linear coregionalization of the SVGP drift: num_latent < outputs mixes
    # that many latent GPs through a trained (P, L) matrix
    coregionalize: Optional[bool] = None
    num_latent: Optional[int] = None
    # one hyperparameter set shared by all latents (SharedRBF)
    shared_kernel: bool = False
    # round the inducing count up to a multiple of this (capped at
    # num_centers), so M changes at most a few times as the data grow; 0
    # disables
    pad_inducing_multiple: int = 0


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Policy build/train options."""

    reinitialize: bool = False
    num_centers: int = 30
    step_limit: int = 5000
    initial_learning_rate: float = 0.01
    global_clipnorm: float = 1.0
    batch_size: int = 1024  # pathwise particles
    num_bases: int = 1024  # pathwise Fourier bases
    action_scale: float = 10.0  # squash to (-scale, scale)
    coregionalize: Optional[bool] = None
    num_latent: Optional[int] = None
    # multistart policy optimization: candidate 0 continues the current
    # policy, candidate 1 is the best-validated snapshot (retain_best_policy),
    # the rest are fresh q_mu draws; the lowest best-seen loss wins
    num_restarts: int = 4
    # act with the best-measured snapshot unless the trained policy's own
    # model-predicted reward beats the snapshot's measured score
    retain_best_policy: bool = True
    # mixed-precision MM loss: the trained parameters and the drift fit stay
    # in the loop dtype, while the moment-matched rollout loss (and so its
    # gradient) computes in this dtype. At a fitted drift the float32 MM
    # gradient decorrelates from the float64 truth (the 30-step recursion is
    # chaotic), so the H100's native float64 runs the loss. MM only: the
    # pathwise loss raises on it.
    loss_dtype: Optional[torch.dtype] = None
    # keep the policy chain (policy match and probit/BVN squash) as a
    # loop-dtype island inside the loss_dtype loss: a float64 carry and
    # drift match alone restore the truth gradient
    loss_policy_f32: bool = True
    # the JAX package's double-float MM loss; here it is the float64 loss
    # (loss_dtype=torch.float64), which it emulates
    loss_compensated: bool = False
    # scan unroll of the JAX MM rollout; accepted and ignored, since eager
    # PyTorch has no scan to unroll
    mm_unroll: int = 30


def _svgp_loss(model: SVGP, x, y, spec: DriftSpec, weights=None, num_data=None) -> torch.Tensor:
    """The SVGP drift's training loss: minus the ELBO plus the SNR penalty."""
    return -(
        svgp_elbo(model, x, y, num_data=num_data, weights=weights)
        + pilco_snr_penalty(model, spec.snr_threshold, spec.snr_power)
    )


def gpr_log_posterior(model: GPR, spec: DriftSpec) -> Callable:
    """The HMC target over ``model``'s hyperparameters: flat (C, dim)
    vectors, in ``named_parameters`` order, to (C,) LML plus SNR penalty."""

    def log_prob(q):
        m = gpr_view(model, q)
        return gpr_lml(m) + pilco_snr_penalty(m, spec.snr_threshold, spec.snr_power)

    return log_prob


class PILCOBase:
    """Shared machinery: data plumbing, model builds, real-env stepping."""

    def __init__(
        self,
        env,
        episode_spec: EpisodeSpec,
        objective: GaussianObjective,
        encoder: Optional[Encoder] = None,
        directory: Optional[str] = None,
        seed: int = 0,
        device=None,
        dtype: torch.dtype = torch.float32,
        env_substeps: int = 10,
        drift_spec: DriftSpec = DriftSpec(),
        policy_spec: PolicySpec = PolicySpec(),
        metrics: Optional[dict] = None,
    ):
        self.env = env
        self.episode_spec = episode_spec
        self.objective = objective
        self.encoder = encoder
        self.directory = Path(directory) if directory else None
        self.seed = seed
        self.device = default_device(device)
        self.dtype = dtype
        self.env_substeps = env_substeps
        self.drift_spec = drift_spec
        self.policy_spec = policy_spec
        self.metrics = metrics or {}

        self.episodes: List[EpisodeData] = []
        # hooks: step callbacks get (loop, episode) after the episode is
        # appended; unroll callbacks get (loop, states, actions) right after
        # the trajectory is collected, before the metrics
        self.step_callbacks: List[Callable] = []
        self.unroll_callbacks: List[Callable] = []
        self.drift_model: Optional[SVGP] = None
        self.policy_model: Optional[SVGP] = None
        # best-measured policy snapshot and the policy that acted last
        self.best_policy_model: Optional[SVGP] = None
        self.best_policy_score: float = float("-inf")
        self.acting_model: Optional[SVGP] = None
        # route the pathwise SVGP drift evaluations through the path-eval
        # kernel op (ops/path_eval_cuda.py); plain torch otherwise
        self.use_fused_paths: bool = False
        # route the MM eKuffu pair grid through the CUDA contraction kernel
        # (ops/kexp_cuda.py)
        self.use_fused_mm: bool = False
        # the whole-match kernel (ops/mm_match_cuda.py) for the policy match,
        # and, in the MM loss, for the frozen drift with the fused encoder,
        # PSD guard and Euler update
        self.use_fused_match: bool = False
        # the whole pathwise rollout loss as one kernel op (ops/rollout_cuda.py)
        # where the configuration qualifies (PathwisePILCO._fused_rollout_eligible);
        # otherwise the per-step path
        self.use_fused_rollout: bool = False

    # ------------------------------------------------------------------ randomness
    def iteration_generator(self, purpose: int, *index: int) -> torch.Generator:
        """A generator seeded from (seed, episodes so far + 1, purpose,
        *index), so a rerun of the same iteration draws the same numbers
        (``index`` tells apart, e.g., the multistart candidates)."""
        state = np.random.SeedSequence([self.seed, len(self.episodes) + 1, purpose, *index])
        seed = int(state.generate_state(1, np.uint64)[0]) & (2**63 - 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------ data
    def encode(self, x):
        return x if self.encoder is None else self.encoder(x)

    def get_data_dynamics(self):
        """(encode(x_t), u_t) -> x_{t+1} - x_t over all episodes."""
        states, actions = stack_episodes(self.episodes)
        states, actions = self._tensor(states), self._tensor(actions)
        zu = torch.cat([self.encode(states)[:, :-1, :], actions], dim=-1)
        dx = states[:, 1:, :] - states[:, :-1, :]
        return zu.reshape(-1, zu.shape[-1]), dx.reshape(-1, dx.shape[-1])

    def get_data_policy(self):
        states, actions = stack_episodes(self.episodes)
        z = self.encode(self._tensor(states))[:, :-1, :]
        u = self._tensor(actions)
        return z.reshape(-1, z.shape[-1]), u.reshape(-1, u.shape[-1])

    # ------------------------------------------------------------------ builds
    def build_dynamics(self):
        spec = self.drift_spec
        x, y = self.get_data_dynamics()
        if spec.model_type == "gpr":
            return build_gpr(
                x, y, noise_variance=spec.noise_variance, ls_low=spec.ls_low, ls_high=spec.ls_high
            )
        if spec.model_type != "svgp":
            raise ValueError(f"drift model_type={spec.model_type!r}: 'svgp' or 'gpr'")
        return build_svgp(
            x, y,
            num_inducing=spec.num_centers,
            generator=self.iteration_generator(_DYNAMICS),
            coregionalize=spec.coregionalize,
            num_latent=spec.num_latent,
            noise_variance=spec.noise_variance,
            per_output_noise=spec.per_output_noise,
            shared_kernel=spec.shared_kernel,
            pad_inducing_multiple=spec.pad_inducing_multiple,
            ls_low=spec.ls_low,
            ls_high=spec.ls_high,
        )

    def build_policy(self) -> SVGP:
        x, u = self.get_data_policy()
        spec = self.policy_spec
        gen = self.iteration_generator(_POLICY_INIT)
        num_latent = u.shape[-1] if spec.num_latent is None else spec.num_latent
        q_mu = 1e-3 * torch.randn(
            (min(spec.num_centers, x.shape[0]), num_latent),
            generator=gen, dtype=self.dtype, device=self.device,
        )
        return build_svgp(
            x, u,
            num_inducing=spec.num_centers,
            generator=gen,
            coregionalize=spec.coregionalize,
            num_latent=spec.num_latent,
            q_mu=q_mu,
            noise_variance=1.0,
        )

    def policy_chain(self, policy_model: SVGP) -> Chain:
        """Squashed deterministic policy: u = 2*scale*(Phi(g) - 0.5)."""
        scale = self.policy_spec.action_scale
        if self.use_fused_match:
            # the whole-match kernel with the full adjoint: the policy trains
            policy_t = SVGPTransform(
                model=policy_model, deterministic=True, fused_match=True
            ).with_cache()
        else:
            policy_t = SVGPTransform(
                model=policy_model, deterministic=True, fused=self.use_fused_mm
            ).with_cache()
        return Chain(SquashedProbit(scale=2.0 * scale - 1e-5), policy_t)

    # ------------------------------------------------------------------ training
    def _optimism_noise_floor(self, prev_model) -> Optional[torch.Tensor]:
        """The per-output (P,) likelihood-noise floor of a pessimistic refit,
        or None. It applies when the last episode's model-predicted reward
        (eReward) beat its realized reward by more than
        ``DriftSpec.optimism_tolerance``: the floor is
        ``optimism_noise_mult`` x the incumbent drift's MSE on that
        episode's transitions, rows it never trained on."""
        spec = self.drift_spec
        if (
            not spec.optimism_tolerance
            or prev_model is None
            or isinstance(prev_model, GPREnsemble)
            or not self.episodes
        ):
            return None
        m = self.episodes[-1].metrics
        e_rew, rew = m.get("eReward"), m.get("rewards")
        if e_rew is None or rew is None or not (np.isfinite(e_rew) and np.isfinite(rew)):
            return None
        if float(e_rew) - float(rew) <= spec.optimism_tolerance:
            return None
        x, y = self.get_data_dynamics()
        n = min(self.episode_spec.num_steps, x.shape[0])
        xs, ys = x[-n:], y[-n:]
        with torch.no_grad():
            predict = svgp_predict_f if isinstance(prev_model, SVGP) else gpr_predict_f
            mu, _ = predict(prev_model, xs)
            mse = torch.mean((ys - mu) ** 2, dim=0)  # (P,)
        logger.info(
            "pessimistic refit: eReward %.2f - reward %.2f > tol %.2f; held-out per-output MSE floor %s",
            float(e_rew), float(rew), spec.optimism_tolerance,
            np.array2string(mse.cpu().numpy(), precision=3),
        )
        return spec.optimism_noise_mult * mse

    @staticmethod
    def _apply_noise_floor(model, floor: torch.Tensor):
        """Raise the fitted likelihood noise to at least ``floor`` ((P,)), in
        place; a scalar noise takes the mean floor, so one large output
        cannot drown the small outputs' signal. Returns the model."""
        with torch.no_grad():
            noise = model.noise_variance
            f = floor.to(noise.dtype)
            f = f if noise.dim() else f.mean()
            model.raw_noise.copy_(bij.positive_inv(torch.maximum(noise, f)))
        return model

    def update_dynamics(self):
        spec = self.drift_spec
        if spec.optimizer == "hmc" and spec.model_type != "gpr":
            raise ValueError(
                "DriftSpec.optimizer='hmc' samples exact-GP hyperparameter "
                "posteriors and requires model_type='gpr'"
            )
        if spec.model_type == "svgp" and spec.optimizer not in _SVGP_OPTIMIZERS:
            raise ValueError(
                f"DriftSpec.optimizer={spec.optimizer!r}: an SVGP drift takes one of {_SVGP_OPTIMIZERS}"
            )
        noise_floor = self._optimism_noise_floor(self.drift_model)
        info = self._update_gpr() if spec.model_type == "gpr" else self._update_svgp()
        # the pessimistic refit; an HMC ensemble is already honestly Bayesian
        if noise_floor is not None and not isinstance(self.drift_model, GPREnsemble):
            self._apply_noise_floor(self.drift_model, noise_floor)
            info["pessimistic"] = True
        return info

    def _update_svgp(self):
        """Fit the SVGP drift (ELBO plus the SNR penalty) by
        ``DriftSpec.optimizer``. L-BFGS fits a fresh build and, when it has
        the same shapes, the incumbent too, and keeps the better."""
        spec = self.drift_spec
        prev_model = self.drift_model
        if self.drift_model is None or spec.reinitialize:
            self.drift_model = self.build_dynamics()
        model = self.drift_model
        x, y = self.get_data_dynamics()
        num_data = x.shape[0]
        freeze_inducing = model.num_inducing >= num_data
        if spec.optimizer == "adam":
            return self._fit_svgp_adam(model, x, y, freeze_inducing)

        weights = None
        if spec.pad_data_multiple:
            mult = spec.pad_data_multiple
            pad = ((num_data + mult - 1) // mult) * mult - num_data
            if pad > 0:
                x = torch.cat([x, x[:1].repeat(pad, 1)], dim=0)
                y = torch.cat([y, y[:1].repeat(pad, 1)], dim=0)
                weights = torch.cat([
                    torch.ones((num_data,), dtype=x.dtype, device=x.device),
                    torch.zeros((pad,), dtype=x.dtype, device=x.device),
                ])
        if spec.optimizer == "natgrad_adam":
            return self._fit_svgp_natgrad(model, x, y, weights, freeze_inducing)

        # from-scratch refits occasionally land in a bad basin: when an
        # incumbent of the same shapes exists, also fit from its parameters
        # and keep the better finite loss
        candidates = [model]
        if (
            spec.refit_from_incumbent
            and spec.reinitialize
            and isinstance(prev_model, SVGP)
            and _same_structure(prev_model, model)
        ):
            candidates.append(copy.deepcopy(prev_model))
        best = None
        for cand in candidates:
            params = dynamics_mask(cand, freeze_inducing=freeze_inducing)
            fl, it = lbfgs_minimize(
                lambda c=cand: _svgp_loss(c, x, y, spec, weights=weights), params,
                max_iters=spec.max_iters, tol=spec.lbfgs_tol,
            )
            if best is None or (
                math.isfinite(fl) and (not math.isfinite(best[1]) or fl < best[1])
            ):
                best = (cand, fl, it)
        self.drift_model, final_loss, iters = best
        return {"loss": final_loss, "iters": iters, "refit_candidates": len(candidates)}

    def _fit_svgp_adam(self, model: SVGP, x, y, freeze_inducing: bool):
        """The minibatched stochastic ELBO: every Adam step draws a fresh
        with-replacement batch of ``batch_size`` real rows (at most the data)
        and scales the data term to all of them; no gradient clipping."""
        spec = self.drift_spec
        num_data = x.shape[0]
        gen = self.iteration_generator(_DYNAMICS, _MINIBATCH)
        size = min(spec.batch_size, num_data)

        def loss():
            idx = torch.randint(0, num_data, (size,), generator=gen, device=x.device)
            return _svgp_loss(model, x[idx], y[idx], spec, num_data=num_data)

        losses, _ = adam_minimize(
            loss, dynamics_mask(model, freeze_inducing=freeze_inducing),
            num_steps=spec.max_iters, learning_rate=spec.adam_lr, global_clipnorm=None,
        )
        finite = losses[np.isfinite(losses)]
        return {"loss": float(finite[-1]) if finite.size else float("nan"), "iters": spec.max_iters}

    def _fit_svgp_natgrad(self, model: SVGP, x, y, weights, freeze_inducing: bool):
        """``max_iters // 10`` rounds of one natural-gradient step on q(u)
        (``natgrad_gamma``) and one Adam step at ``hyper_lr`` on the other
        trainable parameters, then a last natural-gradient step."""
        spec = self.drift_spec
        trainable = {id(p) for p in dynamics_mask(model, freeze_inducing)}
        hypers = [
            p for name, p in model.named_parameters()
            if id(p) in trainable and name not in ("q_mu", "q_sqrt")
        ]
        opt = torch.optim.Adam(hypers, lr=spec.hyper_lr, betas=(0.9, 0.999), eps=1e-8)
        rounds = max(1, spec.max_iters // 10)
        val = torch.tensor(float("inf"))
        for _ in range(rounds):
            natgrad_step(model, x, y, gamma=spec.natgrad_gamma, weights=weights)
            val = _svgp_loss(model, x, y, spec, weights=weights)
            for p, g in zip(hypers, torch.autograd.grad(val, hypers)):
                p.grad = g
            opt.step()
        natgrad_step(model, x, y, gamma=spec.natgrad_gamma, weights=weights)
        return {"loss": float(val.detach()), "iters": rounds}

    def _update_gpr(self):
        """L-BFGS MAP fit of an exact GPR (LML plus the SNR penalty; the data
        stay fixed), then, for ``optimizer='hmc'``, the HMC ensemble. As in
        the JAX package, a GPR is fit by L-BFGS whatever other optimizer is
        named."""
        spec = self.drift_spec
        # an HMC ensemble is a sampling product, not an optimizable state:
        # each refit restarts from a fresh point model
        if self.drift_model is None or spec.reinitialize or isinstance(self.drift_model, GPREnsemble):
            self.drift_model = self.build_dynamics()
        model = self.drift_model

        def loss():
            return -(gpr_lml(model) + pilco_snr_penalty(model, spec.snr_threshold, spec.snr_power))

        final_loss, iters = lbfgs_minimize(
            loss, gpr_mask(model), max_iters=spec.max_iters, tol=spec.lbfgs_tol
        )
        info = {"loss": final_loss, "iters": iters}
        if spec.optimizer == "hmc":
            self.drift_model, hmc_info = self._hmc_gpr_ensemble(model)
            info.update(hmc_info)
        return info

    def _hmc_gpr_ensemble(self, map_model: GPR):
        """HMC over the GPR's unconstrained hyperparameters, the chains
        started around the MAP fit, thinned to a K-member GPREnsemble: K
        draws at linspace(samples // 2, samples - 1, K), the chains taken
        round-robin."""
        spec = self.drift_spec
        flat0 = torch.cat([p.detach().reshape(-1) for p in map_model.parameters()])
        log_prob = gpr_log_posterior(map_model, spec)
        t0 = time.perf_counter()
        gen = self.iteration_generator(_HMC)
        init = flat0 + spec.hmc_init_jitter * torch.randn(
            (spec.hmc_chains, flat0.shape[0]), generator=gen, dtype=flat0.dtype, device=flat0.device
        )
        result = run_hmc(
            log_prob, init, gen,
            HMCConfig(
                num_warmup=spec.hmc_warmup,
                num_samples=spec.hmc_samples,
                num_leapfrog=spec.hmc_leapfrog,
                init_step_size=spec.hmc_step_size,
                adapt_trajectory=spec.hmc_adapt,
                max_leapfrog=4 * spec.hmc_leapfrog,
            ),
        )
        k = spec.hmc_ensemble
        t_idx = np.linspace(spec.hmc_samples // 2, spec.hmc_samples - 1, k).astype(np.int64)
        c_idx = np.arange(k) % spec.hmc_chains
        draws = result.samples[torch.as_tensor(t_idx), torch.as_tensor(c_idx)]  # (K, dim)
        ensemble = GPREnsemble(gpr_stack(map_model, draws), num_members=k)
        info = {
            "hmc_accept": float(result.accept_prob.mean()),
            "hmc_step_size": float(result.step_size),
        }
        info["hmc_seconds"] = time.perf_counter() - t0  # after the reads above wait for the device
        return ensemble, info

    def policy_loss_fn(self, policy_model: SVGP, generator, drift=None, x0=None):
        raise NotImplementedError

    def policy_loss_drift(self) -> SVGP:
        """The drift the policy loss uses, frozen: no gradient reaches it."""
        self.drift_model.requires_grad_(False)
        return self.drift_model

    def update_policy(self):
        spec = self.policy_spec
        if self.policy_model is None or spec.reinitialize:
            self.policy_model = self.build_policy()
        model = self.policy_model
        drift = self.policy_loss_drift()
        schedule = make_policy_schedule(spec.step_limit, spec.initial_learning_rate)
        if spec.num_restarts > 1:
            return self._update_policy_multistart(model, drift, schedule)
        gen = self.iteration_generator(_POLICY_OPT)  # fresh paths every step
        losses, notfinite = adam_minimize(
            lambda: self.policy_loss_fn(model, gen, drift=drift),
            policy_mask(model),
            num_steps=spec.step_limit,
            schedule=schedule,
            global_clipnorm=spec.global_clipnorm,
        )
        finite = losses[np.isfinite(losses)]
        return {
            "loss": float(finite[-1]) if finite.size else float("nan"),
            "losses": losses,
            "nan_frac": float(np.mean(~np.isfinite(losses))),
            # optimizer steps skipped because gradients were non-finite
            "skipped_steps": notfinite,
        }

    def _update_policy_multistart(self, model: SVGP, drift, schedule):
        """K candidates, each trained with its own generator: candidate 0
        continues ``model`` (in place), candidate 1 is a copy of the
        best-validated snapshot when ``retain_best_policy`` keeps one, the
        rest are copies of ``model`` with fresh 1e-3 N(0, I) ``q_mu`` draws.
        The lowest best-seen loss wins, and its best-seen parameters become
        ``self.policy_model``. The snapshot is copied, not trained: the
        acting gate deploys it."""
        spec = self.policy_spec
        candidates = [model]
        if spec.retain_best_policy and self.best_policy_model is not None:
            candidates.append(copy.deepcopy(self.best_policy_model))
        for i in range(len(candidates), spec.num_restarts):
            cand = copy.deepcopy(model)
            with torch.no_grad():
                cand.q_mu.copy_(1e-3 * torch.randn(
                    model.q_mu.shape, generator=self.iteration_generator(_RESTART, i),
                    dtype=self.dtype, device=self.device,
                ))
            candidates.append(cand)
        gens = [self.iteration_generator(_POLICY_OPT, i) for i in range(len(candidates))]
        params = [policy_mask(c) for c in candidates]
        t0 = time.perf_counter()
        bests, best_losses, traces, notfinite = adam_minimize_multistart(
            [lambda c=c, g=g: self.policy_loss_fn(c, g, drift=drift) for c, g in zip(candidates, gens)],
            params,
            num_steps=spec.step_limit,
            schedule=schedule,
            global_clipnorm=spec.global_clipnorm,
        )
        logger.info("policy multistart: %d x %d steps in %.1f s", len(candidates), spec.step_limit,
                    time.perf_counter() - t0)
        best = int(np.argmin(best_losses))
        with torch.no_grad():
            for p, b in zip(params[best], bests[best]):
                p.copy_(b)
        self.policy_model = candidates[best]
        return {
            "loss": float(best_losses[best]),
            "losses": traces[best],
            "nan_frac": float(np.mean(~np.isfinite(traces))),
            "skipped_steps": notfinite,
            "best_restart": best,
            "restart_losses": best_losses.tolist(),
        }

    # ------------------------------------------------------------------ rollout
    def expected_reward(self, model: Optional[SVGP] = None) -> float:
        """Model-predicted expected episode reward of ``model`` (default: the
        trained policy) under the current drift, from fresh paths."""
        if self.drift_model is None or self.policy_model is None:
            return float("nan")
        with torch.no_grad():
            loss = self.policy_loss_fn(
                self.policy_model if model is None else model,
                self.iteration_generator(_EXPECTED_REWARD),
                drift=self.policy_loss_drift(),
            )
        return -float(loss)

    def policy_fn(self, model: Optional[SVGP] = None) -> Callable:
        """Raw-state -> action callable for the real environment."""
        model = self.policy_model if model is None else model
        with torch.no_grad():
            chain = self.policy_chain(model)

        def policy(state):
            with torch.no_grad():
                return chain(self.encode(state)[None])[0]

        return policy

    def step(self) -> EpisodeData:
        """Collect one real-environment episode with the current policy, or
        with uniformly random actions before there is one."""
        gen = self.iteration_generator(_STEP)
        spec = self.episode_spec
        x0 = spec.sample(gen, dtype=self.dtype, device=self.device)
        fallback = False
        if self.policy_model is None:
            actions = self.env.action_space.sample(
                gen, (spec.num_steps,), dtype=self.dtype, device=self.device
            )
            states = [x0]
            for a in actions:
                states.append(env_step(self.env, states[-1], a, spec.step_size, self.env_substeps))
            states = torch.stack(states)
            self.acting_model = None
        else:
            acting = self.policy_model
            if (
                self.policy_spec.retain_best_policy
                and self.best_policy_model is not None
                and np.isfinite(self.best_policy_score)
            ):
                e_pred = self.expected_reward()
                if not np.isfinite(e_pred) or e_pred <= self.best_policy_score:
                    acting = self.best_policy_model
                    fallback = True
            self.acting_model = acting
            states, actions = env_rollout(
                self.env, self.policy_fn(acting), x0, spec.step_size, spec.num_steps,
                self.env_substeps,
            )
        states_np = states.detach().cpu().numpy()
        actions_np = actions.detach().cpu().numpy()
        for cb in self.unroll_callbacks:
            cb(self, states_np, actions_np)

        metrics = {}
        for name, fn in self.metrics.items():
            out = fn(self, states_np, actions_np)
            if isinstance(out, dict):
                metrics.update(out)
            else:
                metrics[name] = out
        if self.policy_model is not None:
            metrics["fallback"] = fallback
        episode = EpisodeData(states=states_np, actions=actions_np, metrics=metrics)
        self.episodes.append(episode)
        for cb in self.step_callbacks:
            cb(self, episode)

        # a fallback refreshes the snapshot's score; otherwise the trained
        # policy replaces the snapshot only by measuring strictly better
        score = metrics.get("vReward", metrics.get("rewards"))
        if self.policy_model is not None and score is not None and np.isfinite(score):
            if fallback:
                self.best_policy_score = float(score)
            elif float(score) > self.best_policy_score:
                self.best_policy_score = float(score)
                self.best_policy_model = copy.deepcopy(self.policy_model)
        return episode

    # ------------------------------------------------------------------ checkpoint
    # numbered ckpt-<episodes>.pkl files written atomically (a .tmp file,
    # flushed and fsynced, then os.replace), a schema number, the newest
    # ``checkpoint_keep`` kept; restore walks newest to oldest past
    # unreadable files (one truncated by a crash mid-write). The models are
    # numpy dicts (convert.model_to_numpy), not pickled modules.
    CHECKPOINT_SCHEMA = 1
    checkpoint_keep = 3

    def save(self) -> Optional[Path]:
        """Write a checkpoint into ``directory``; None without one."""
        if self.directory is None:
            return None
        self.directory.mkdir(parents=True, exist_ok=True)
        payload = {
            "schema": self.CHECKPOINT_SCHEMA,
            "episodes": [(ep.states, ep.actions, _scrub_metrics(ep.metrics)) for ep in self.episodes],
            "drift": model_to_numpy(self.drift_model),
            "policy": model_to_numpy(self.policy_model),
            "best_policy": model_to_numpy(self.best_policy_model),
            "best_policy_score": self.best_policy_score,
        }
        path = self.directory / f"ckpt-{len(self.episodes)}.pkl"
        tmp = path.with_suffix(".pkl.tmp")
        with tmp.open("wb") as f:
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # readers never see a partial file
        for old in self._checkpoint_paths()[: -self.checkpoint_keep]:
            old.unlink(missing_ok=True)
        return path

    def _checkpoint_paths(self) -> List[Path]:
        """The numbered checkpoints, oldest to newest."""
        if self.directory is None:
            return []
        return sorted(self.directory.glob("ckpt-*.pkl"), key=lambda p: int(p.stem.split("-")[1]))

    def restore_or_initialize(self) -> bool:
        """Load the newest readable checkpoint, if there is one; raises
        ``ValueError`` on a newer schema rather than misread it."""
        for path in reversed(self._checkpoint_paths()):
            try:
                with path.open("rb") as f:
                    payload = pickle.load(f)
            except Exception:  # a crash mid-write can leave any unpickling error
                logger.warning("skipping unreadable checkpoint %s", path, exc_info=True)
                continue
            schema = payload.get("schema", 0)
            if schema > self.CHECKPOINT_SCHEMA:
                raise ValueError(
                    f"checkpoint {path} has schema {schema} > supported {self.CHECKPOINT_SCHEMA}"
                )
            self.episodes = [EpisodeData(states=s, actions=a, metrics=m) for s, a, m in payload["episodes"]]
            self.drift_model = model_from_numpy(payload["drift"], self.device, self.dtype)
            self.policy_model = model_from_numpy(payload["policy"], self.device, self.dtype)
            self.best_policy_model = model_from_numpy(payload["best_policy"], self.device, self.dtype)
            self.best_policy_score = payload["best_policy_score"]
            for model in (self.policy_model, self.best_policy_model):
                if model is not None:
                    policy_mask(model)  # the trainable flags the policies were saved with
            return True
        return False


def _scrub_metrics(metrics: dict) -> dict:
    """Metric values as plain Python numbers and lists, for pickling."""
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = np.asarray(v).tolist()
        except Exception:
            out[k] = v
    return out


class MomentMatchingPILCO(PILCOBase):
    """Classic PILCO: deterministic propagation of Gaussian state moments,
    under an SVGP, a GPR or a GPREnsemble drift."""

    @property
    def _loss_override(self) -> Optional[torch.dtype]:
        """The dtype the loss runs in when it is not the loop's:
        ``PolicySpec.loss_dtype``, or float64 under ``loss_compensated``,
        whose double-float arithmetic emulates float64 on a chip without it."""
        spec = self.policy_spec
        return torch.float64 if spec.loss_compensated else spec.loss_dtype

    @property
    def _fused_mm_on(self) -> bool:
        """The pair-grid kernel runs whenever ``use_fused_mm`` is set. The JAX
        package also required the loss to run in the loop dtype, because its
        Pallas kernels are 32-bit on the TPU; the CUDA kernel takes float32
        and float64, so the float64 drift match and the float32 policy
        island both launch it."""
        return self.use_fused_mm

    @property
    def _fused_match_on(self) -> bool:
        """The whole-match path of the MM loss (frozen drift match, fused
        encoder, PSD guard and Euler update) runs when ``use_fused_match`` is
        set and the loss runs in the loop dtype, as in the JAX package; the
        policy chain takes the whole-match kernel whenever
        ``use_fused_match`` is set (``policy_chain``)."""
        spec = self.policy_spec
        return self.use_fused_match and spec.loss_dtype is None and not spec.loss_compensated

    def _gpr_transform(self, model: GPR) -> GPRTransform:
        """Cached GPR drift transform (a stacked GPR for an ensemble). GPR
        matches are always frozen (the hyperparameters train through the LML
        or HMC), so the whole-match kernel applies whenever the whole-match
        path is on."""
        if self._fused_match_on:
            return GPRTransform(model=model, fused_match=True).with_cache()
        return GPRTransform(
            model=_cast_module(model, self._loss_override), fused=self._fused_mm_on
        ).with_cache()

    def _drift_transform(self, drift_model):
        if isinstance(drift_model, GPREnsemble):
            drift_model = drift_model.members
        if isinstance(drift_model, GPR):
            if self.policy_spec.loss_compensated:
                raise NotImplementedError(
                    "PolicySpec.loss_compensated supports SVGP drifts, as in the JAX package; "
                    "GPR and ensemble drifts take PolicySpec.loss_dtype"
                )
            return self._gpr_transform(drift_model)
        if not isinstance(drift_model, SVGP):
            raise NotImplementedError(f"no MM loss for a {type(drift_model).__name__} drift")
        if self._fused_match_on:
            return SVGPTransform(model=drift_model, fused_match=True, frozen=True).with_cache()
        return SVGPTransform(
            model=_cast_module(drift_model, self._loss_override), fused=self._fused_mm_on
        ).with_cache()

    def policy_loss_drift(self):
        """The frozen drift as a cached transform at the loss dtype, built once
        per policy update: its Cholesky, representer and pair factors do not
        change across optimizer steps. For an ensemble, one transform of the
        stacked members."""
        return self._drift_transform(super().policy_loss_drift())

    def _mm_rollout_loss(self, policy_model: SVGP, drift) -> torch.Tensor:
        """Expected cumulative cost of one moment-matched rollout under a
        cached drift transform. The per-step cost is computed after the
        rollout from the stacked moments, in one batched evaluation.

        Under a stacked GPR (an ensemble's K members) the rollout carries K
        moment sets as its batch, entry k matched against member k, and the
        loss is the mean over members of each member's cost summed over the
        steps: the posterior-averaged loss that the JAX package takes as a
        vmap of K one-entry rollouts, at one rollout's launches."""
        ld = self._loss_override
        dtype = self.dtype if ld is None else ld
        if ld is not None and self.policy_spec.loss_policy_f32:
            # the policy chain as a loop-dtype island inside the loss dtype
            pol = DtypeIsland(inner=self.policy_chain(policy_model), dtype=self.dtype, outer=ld)
        else:
            pol = self.policy_chain(_cast_module(policy_model, ld))
        spec = self.episode_spec
        members = 1
        if isinstance(drift, GPRTransform) and drift.model.stacked:
            members = drift.model.raw_noise.shape[0]
        x0 = GaussianMoments(
            mean=torch.as_tensor(spec.state_mean, dtype=dtype, device=self.device)[None].repeat(members, 1),
            cov=torch.as_tensor(spec.covariance(), dtype=dtype, device=self.device)[None].repeat(members, 1, 1),
        )
        fused = self._fused_match_on
        enc = self.encoder
        if fused and isinstance(getattr(enc, "transform", None), SinCos):
            # as in the JAX package, the fused encoder serves the rollout's
            # matches and the post-rollout cost's batched match alike
            enc = enc.with_fused()
        _, means, covs = moment_matching_euler_rollout(
            lambda t, xm: forward_moments(xm, drift, policy=pol, encoder=enc, fused_glue=fused),
            x0,
            dt=1.0,  # the drift predicts per-control-step deltas
            num_steps=spec.num_steps,
            fused_update=fused,
        )
        states = GaussianMoments(mean=means, cov=covs)  # (T, K, D) stacks
        feats = states if enc is None else enc.moment_match(states).y
        return self.objective(feats).sum() / members

    def policy_loss_fn(self, policy_model: SVGP, generator, drift=None, x0=None):
        """The MM loss; it is deterministic, so ``generator`` and ``x0`` are
        unused. ``drift`` is a cached transform or a drift model."""
        if drift is None:
            drift = self.policy_loss_drift()
        elif not isinstance(drift, (SVGPTransform, GPRTransform)):
            drift = self._drift_transform(drift)
        return self._mm_rollout_loss(policy_model, drift)


def particle_rollout_costs(policy, drift_fn, x0: torch.Tensor, encoder, objective,
                           num_steps: int) -> torch.Tensor:
    """Cumulative cost (S,) of each particle of x0 (S, D) over ``num_steps``
    Euler steps, each riding the fixed sampled drift function in
    ``drift_fn`` under the policy transform ``policy``."""

    def f(t, x):
        return forward_concrete(x, drift_fn, policy=policy, encoder=encoder)

    def acc(t, x, loss):
        return loss + objective(x if encoder is None else encoder(x))

    _, loss, _ = euler_rollout(
        f, x0,
        dt=1.0,  # the drift predicts per-control-step deltas
        num_steps=num_steps,
        accumulate=acc,
        acc_init=torch.zeros((x0.shape[0],), dtype=x0.dtype, device=x0.device),
    )
    return loss


def fused_rollout_costs(policy_model: SVGP, drift_model, paths, x0: torch.Tensor, encoder,
                        objective, action_scale: float, num_steps: int) -> torch.Tensor:
    """Cumulative cost (S,) of each particle through the whole-rollout kernel
    op; a stacked GPR's paths carry its members, particles member-major."""
    return pathwise_rollout_loss_fused(
        policy_model, drift_model, paths, x0,
        active_dims=tuple(encoder.active_dims),
        action_scale=float(action_scale),
        target=objective.target.to(x0.dtype),
        precis=objective.precis.to(x0.dtype),
        dt=1.0,  # the drift predicts per-control-step deltas
        num_steps=num_steps,
    )


class PathwisePILCO(PILCOBase):
    """Pathwise-conditioned Monte-Carlo particle rollouts: each particle rides
    its own fixed posterior sample of the drift."""

    def _particle_rollout_loss(self, policy_model: SVGP, drift_fn, x0: torch.Tensor):
        """Mean cumulative cost over the particles x0 (S, D), each riding the
        fixed sampled drift function in ``drift_fn``."""
        return particle_rollout_costs(self.policy_chain(policy_model), drift_fn, x0, self.encoder,
                                      self.objective, self.episode_spec.num_steps).mean()

    def policy_loss_fn(self, policy_model: SVGP, generator, drift=None, x0=None):
        """Particle loss on fresh sample paths of the drift (and fresh initial
        states unless ``x0`` is given). The loss runs in the loop dtype, as
        in the JAX package: ``PolicySpec.loss_dtype`` only keeps it off the
        fused rollout (``_fused_rollout_eligible``)."""
        spec = self.policy_spec
        drift_model = self.drift_model if drift is None else drift
        if isinstance(drift_model, (GPR, GPREnsemble)):
            return self._gpr_particle_loss(policy_model, drift_model, generator, x0)
        if not isinstance(drift_model, SVGP):
            raise NotImplementedError(f"no pathwise loss for a {type(drift_model).__name__} drift")
        paths = generate_paths_svgp(drift_model, generator, spec.batch_size, spec.num_bases)
        if x0 is None:
            x0 = self.episode_spec.sample(
                generator, (spec.batch_size,), dtype=self.dtype, device=self.device
            )
        if self._fused_rollout_eligible(drift_model, policy_model):
            return self._fused_rollout_loss(policy_model, drift_model, paths, x0)
        drift_fn = PathwiseSVGPTransform(model=drift_model, paths=paths, fused=self.use_fused_paths)
        return self._particle_rollout_loss(policy_model, drift_fn, x0)

    def _gpr_particle_loss(self, policy_model: SVGP, drift_model, generator, x0=None):
        """Particle loss under a GPR drift, on fresh GPR paths (plain torch,
        as in the JAX package). Under an ensemble the particle budget splits
        across the K members, batch_size // K each, so every particle rides a
        hyperparameter draw and a function sample from that member's
        posterior; the particles are taken member-major, all members in one
        rollout, and the loss is the mean over all of them (the mean over
        members of each member's mean)."""
        spec = self.policy_spec
        if isinstance(drift_model, GPREnsemble):
            model = drift_model.members
            per = max(1, spec.batch_size // drift_model.num_members)
            total = per * drift_model.num_members
        else:
            model, per = drift_model, spec.batch_size
            total = per
        paths = generate_paths_gpr(model, generator, per, spec.num_bases)
        if x0 is None:
            x0 = self.episode_spec.sample(generator, (total,), dtype=self.dtype, device=self.device)
        if self._fused_rollout_eligible(model, policy_model):
            return self._fused_rollout_loss(policy_model, model, paths, x0)
        return self._particle_rollout_loss(policy_model, PathwiseGPRTransform(model, paths), x0)

    # ------------------------------------------------------------- fused rollout
    def _fused_rollout_eligible(self, drift_model, policy_model) -> bool:
        """Whether the whole-rollout kernel op serves this configuration, a
        static check as in the JAX package: an SVGP drift (a w=None one
        needs as many latents as state dims) or a GPR (a stacked one for an
        ensemble) with as many outputs as state dims, a SinCos encoder, a
        Gaussian objective, and the loss in the loop dtype."""
        if not self.use_fused_rollout or self.policy_spec.loss_dtype is not None:
            return False
        state_dim = len(self.episode_spec.state_mean)
        if isinstance(drift_model, SVGP):
            drift_ok = drift_model.w is not None or drift_model.z.shape[0] == state_dim
        elif isinstance(drift_model, GPR):
            drift_ok = drift_model.y.shape[-1] == state_dim
        else:
            return False
        return (
            drift_ok
            and isinstance(self.encoder, Encoder)
            and isinstance(self.encoder.transform, SinCos)
            and isinstance(self.objective, GaussianObjective)
        )

    def _fused_rollout_loss(self, policy_model: SVGP, drift_model, paths, x0: torch.Tensor):
        """Mean whole-rollout loss over the particles x0 through the kernel
        op; a stacked GPR's paths carry its members, particles member-major."""
        return fused_rollout_costs(policy_model, drift_model, paths, x0, self.encoder, self.objective,
                                   self.policy_spec.action_scale, self.episode_spec.num_steps).mean()
