"""Pathwise and moment-matching PILCO (counterpart of gpflowpilco_tpu/loops/pilco.py).

Ported: the data plumbing, the SVGP drift fit by L-BFGS (with zero-weight
padding rows and the refit from the incumbent), the single-start Adam policy
update, the real-environment step with its random first episodes and the
retain-best acting gate, ``PathwisePILCO``'s SVGP particle loss (its drift
evaluation goes through the CUDA kernel op ops/path_eval_cuda.py), and
``MomentMatchingPILCO``'s SVGP moment-matched loss (its eKuffu pair grid
goes through the CUDA kernel op ops/kexp_cuda.py under ``use_fused_mm``).

Models are ``nn.Module``s trained in place. Randomness comes from
``torch.Generator``s seeded from (seed, number of episodes, purpose), the
counterpart of the JAX package's per-iteration key folds.

Not ported yet, and raising ``NotImplementedError``: multistart policy
optimization (``num_restarts > 1``), GPR/HMC drifts and the other drift
optimizers, ``loss_dtype`` for the pathwise loss, the whole-match kernel
(``use_fused_match``), checkpointing, and the optimism noise floor.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from ..components import Encoder, GaussianObjective
from ..config import default_device
from ..dynamics.forward import forward_concrete, forward_moments
from ..dynamics.solvers import euler_rollout, moment_matching_euler_rollout
from ..envs.base import env_step
from ..envs.base import rollout as env_rollout
from ..models.builders import build_svgp, dynamics_mask, policy_mask
from ..models.gp import SVGP, svgp_elbo
from ..models.pathwise import PathwiseSVGPTransform, generate_paths_svgp
from ..models.priors import pilco_snr_penalty
from ..moment_matching.gp import SVGPTransform
from ..moment_matching.rules import SquashedProbit
from ..moments import Chain, DtypeIsland, GaussianMoments
from ..utils.optimizers import adam_minimize, lbfgs_minimize, make_policy_schedule
from .core import EpisodeData, EpisodeSpec, stack_episodes

# generator purposes (the JAX package's fold_in salts play this role)
_DYNAMICS, _POLICY_INIT, _POLICY_OPT, _STEP, _EXPECTED_REWARD = 0, 1, 2, 7, 23


def _cast_module(module: torch.nn.Module, dtype: Optional[torch.dtype]) -> torch.nn.Module:
    """A view of ``module`` whose floating parameters are cast to ``dtype``,
    the casts in the autograd graph, so gradients reach the original
    parameters (the counterpart of the JAX package's _cast_floats on a model
    pytree). The module itself when ``dtype`` is None or already its own."""
    if dtype is None or all(p.dtype == dtype for p in module.parameters()):
        return module
    view = copy.copy(module)  # a new __dict__ holding the same entries
    view._parameters = {
        name: None if p is None else (p.to(dtype) if p.is_floating_point() else p)
        for name, p in module._parameters.items()
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
    """Dynamics-model build/train options. Only ``model_type='svgp'`` with
    ``optimizer='lbfgs'`` is ported."""

    reinitialize: bool = True
    model_type: str = "svgp"
    num_centers: int = 256
    noise_variance: float = 1.0
    # when reinitializing, also fit from the previous episode's parameters
    # and keep the better ELBO (guards against bad-basin from-scratch refits)
    refit_from_incumbent: bool = True
    snr_threshold: float = 1e5
    snr_power: float = 30.0
    max_iters: int = 1000
    lbfgs_tol: float = 1e-5
    optimizer: str = "lbfgs"
    # pad the training set to a multiple of this with zero-weight rows (0 disables)
    pad_data_multiple: int = 240
    ls_low: float = 0.01
    ls_high: float = 100.0
    # pessimistic refit after optimistic episodes (0 disables; not ported yet)
    optimism_tolerance: float = 0.0


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Policy build/train options. Only ``num_restarts=1`` is ported."""

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


class PILCOBase:
    """Shared machinery: data plumbing, model builds, real-env stepping."""

    def __init__(
        self,
        env,
        episode_spec: EpisodeSpec,
        objective: GaussianObjective,
        encoder: Optional[Encoder] = None,
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
        self.seed = seed
        self.device = default_device(device)
        self.dtype = dtype
        self.env_substeps = env_substeps
        self.drift_spec = drift_spec
        self.policy_spec = policy_spec
        self.metrics = metrics or {}

        self.episodes: List[EpisodeData] = []
        self.drift_model: Optional[SVGP] = None
        self.policy_model: Optional[SVGP] = None
        # best-measured policy snapshot and the policy that acted last
        self.best_policy_model: Optional[SVGP] = None
        self.best_policy_score: float = float("-inf")
        self.acting_model: Optional[SVGP] = None
        # route the MM eKuffu pair grid through the CUDA contraction kernel
        # (ops/kexp_cuda.py)
        self.use_fused_mm: bool = False
        # the whole-match kernel of the JAX package (not ported yet: raises)
        self.use_fused_match: bool = False

    # ------------------------------------------------------------------ randomness
    def iteration_generator(self, purpose: int) -> torch.Generator:
        """A generator seeded from (seed, episodes so far + 1, purpose), so a
        rerun of the same iteration draws the same numbers."""
        state = np.random.SeedSequence([self.seed, len(self.episodes) + 1, purpose])
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
    def build_dynamics(self) -> SVGP:
        spec = self.drift_spec
        if spec.model_type != "svgp":
            raise NotImplementedError(f"drift model_type={spec.model_type!r} is not ported yet")
        x, y = self.get_data_dynamics()
        return build_svgp(
            x, y,
            num_inducing=spec.num_centers,
            generator=self.iteration_generator(_DYNAMICS),
            noise_variance=spec.noise_variance,
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
        policy_t = SVGPTransform(
            model=policy_model, deterministic=True, fused=self.use_fused_mm
        ).with_cache()
        return Chain(SquashedProbit(scale=2.0 * scale - 1e-5), policy_t)

    # ------------------------------------------------------------------ training
    def update_dynamics(self):
        spec = self.drift_spec
        if spec.model_type != "svgp" or spec.optimizer != "lbfgs":
            raise NotImplementedError(
                f"drift {spec.model_type!r}/{spec.optimizer!r}: only the SVGP "
                "L-BFGS fit is ported yet"
            )
        if spec.optimism_tolerance:
            raise NotImplementedError("the optimism noise floor is not ported yet")
        prev_model = self.drift_model
        if self.drift_model is None or spec.reinitialize:
            self.drift_model = self.build_dynamics()
        model = self.drift_model
        x, y = self.get_data_dynamics()
        num_data = x.shape[0]

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

        def loss(m):
            return -(
                svgp_elbo(m, x, y, weights=weights)
                + pilco_snr_penalty(m, spec.snr_threshold, spec.snr_power)
            )

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
        freeze_inducing = model.num_inducing >= num_data
        best = None
        for cand in candidates:
            params = dynamics_mask(cand, freeze_inducing=freeze_inducing)
            fl, it = lbfgs_minimize(
                lambda c=cand: loss(c), params, max_iters=spec.max_iters, tol=spec.lbfgs_tol
            )
            if best is None or (
                math.isfinite(fl) and (not math.isfinite(best[1]) or fl < best[1])
            ):
                best = (cand, fl, it)
        self.drift_model, final_loss, iters = best
        return {"loss": final_loss, "iters": iters, "refit_candidates": len(candidates)}

    def policy_loss_fn(self, policy_model: SVGP, generator, drift=None, x0=None):
        raise NotImplementedError

    def policy_loss_drift(self) -> SVGP:
        """The drift the policy loss uses, frozen: no gradient reaches it."""
        self.drift_model.requires_grad_(False)
        return self.drift_model

    def update_policy(self):
        spec = self.policy_spec
        if spec.num_restarts > 1:
            raise NotImplementedError(
                "multistart policy optimization is not ported yet; use num_restarts=1"
            )
        if self.policy_model is None or spec.reinitialize:
            self.policy_model = self.build_policy()
        model = self.policy_model
        params = policy_mask(model)
        drift = self.policy_loss_drift()
        gen = self.iteration_generator(_POLICY_OPT)  # fresh paths every step
        losses, notfinite = adam_minimize(
            lambda: self.policy_loss_fn(model, gen, drift=drift),
            params,
            num_steps=spec.step_limit,
            schedule=make_policy_schedule(spec.step_limit, spec.initial_learning_rate),
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
    def save(self):
        raise NotImplementedError("checkpointing is not ported yet")

    def restore_or_initialize(self):
        raise NotImplementedError("checkpointing is not ported yet")


class MomentMatchingPILCO(PILCOBase):
    """Classic PILCO: deterministic propagation of Gaussian state moments.
    SVGP drifts only; GPR and ensemble drifts raise."""

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

    def _drift_transform(self, drift_model):
        if not isinstance(drift_model, SVGP):
            raise NotImplementedError("only SVGP drifts are ported for the MM loss yet")
        if self.use_fused_match:
            raise NotImplementedError("the whole-match kernel (use_fused_match) is not ported yet")
        return SVGPTransform(
            model=_cast_module(drift_model, self._loss_override), fused=self._fused_mm_on
        ).with_cache()

    def policy_loss_drift(self) -> SVGPTransform:
        """The frozen drift as a cached transform at the loss dtype, built once
        per policy update: its Cholesky, representer and pair factors do not
        change across optimizer steps."""
        return self._drift_transform(super().policy_loss_drift())

    def _mm_rollout_loss(self, policy_model: SVGP, drift: SVGPTransform) -> torch.Tensor:
        """Expected cumulative cost of one moment-matched rollout under a
        cached drift transform. The per-step cost is computed after the
        rollout from the stacked moments, in one batched evaluation."""
        ld = self._loss_override
        dtype = self.dtype if ld is None else ld
        if ld is not None and self.policy_spec.loss_policy_f32:
            # the policy chain as a loop-dtype island inside the loss dtype
            pol = DtypeIsland(inner=self.policy_chain(policy_model), dtype=self.dtype, outer=ld)
        else:
            pol = self.policy_chain(_cast_module(policy_model, ld))
        spec = self.episode_spec
        x0 = GaussianMoments(
            mean=torch.as_tensor(spec.state_mean, dtype=dtype, device=self.device)[None],
            cov=torch.as_tensor(spec.covariance(), dtype=dtype, device=self.device)[None],
        )
        _, means, covs = moment_matching_euler_rollout(
            lambda t, xm: forward_moments(xm, drift, policy=pol, encoder=self.encoder),
            x0,
            dt=1.0,  # the drift predicts per-control-step deltas
            num_steps=spec.num_steps,
        )
        states = GaussianMoments(mean=means, cov=covs)  # (T, 1, D) stacks
        feats = states if self.encoder is None else self.encoder.moment_match(states).y
        return self.objective(feats).sum()

    def policy_loss_fn(self, policy_model: SVGP, generator, drift=None, x0=None):
        """The MM loss; it is deterministic, so ``generator`` and ``x0`` are
        unused. ``drift`` is a cached transform or a drift model."""
        if drift is None:
            drift = self.policy_loss_drift()
        elif not isinstance(drift, SVGPTransform):
            drift = self._drift_transform(drift)
        return self._mm_rollout_loss(policy_model, drift)


class PathwisePILCO(PILCOBase):
    """Pathwise-conditioned Monte-Carlo particle rollouts: each particle rides
    its own fixed posterior sample of the drift."""

    def _particle_rollout_loss(self, policy_model: SVGP, drift_fn, x0: torch.Tensor):
        """Mean cumulative cost over the particles x0 (S, D), each riding the
        fixed sampled drift function in ``drift_fn``."""
        pol = self.policy_chain(policy_model)

        def f(t, x):
            return forward_concrete(x, drift_fn, policy=pol, encoder=self.encoder)

        def acc(t, x, loss):
            return loss + self.objective(self.encode(x))

        _, loss, _ = euler_rollout(
            f, x0,
            dt=1.0,  # the drift predicts per-control-step deltas
            num_steps=self.episode_spec.num_steps,
            accumulate=acc,
            acc_init=torch.zeros((x0.shape[0],), dtype=x0.dtype, device=x0.device),
        )
        return loss.mean()

    def policy_loss_fn(self, policy_model: SVGP, generator, drift=None, x0=None):
        """Particle loss on fresh sample paths of the drift (and fresh initial
        states unless ``x0`` is given)."""
        spec = self.policy_spec
        if spec.loss_dtype is not None:
            raise NotImplementedError("PolicySpec.loss_dtype applies to the MM loss only")
        drift_model = self.drift_model if drift is None else drift
        if not isinstance(drift_model, SVGP):
            raise NotImplementedError("only SVGP drifts are ported yet")
        paths = generate_paths_svgp(drift_model, generator, spec.batch_size, spec.num_bases)
        if x0 is None:
            x0 = self.episode_spec.sample(
                generator, (spec.batch_size,), dtype=self.dtype, device=self.device
            )
        drift_fn = PathwiseSVGPTransform(model=drift_model, paths=paths, fused=True)
        return self._particle_rollout_loss(policy_model, drift_fn, x0)
