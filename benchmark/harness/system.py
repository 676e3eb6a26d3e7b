"""The system under test: the port's pathwise PILCO loop, its drift and
policy SVGPs built from the cell's inputs, and the policy update's pieces
(the masked leaves, the schedule, the steps' generator) exactly as
``PILCOBase.update_policy`` assembles them for one candidate."""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from gpflowpilco_torch.components import GaussianObjective, trigonometric_encoder
from gpflowpilco_torch.loops import pilco
from gpflowpilco_torch.loops.core import EpisodeSpec
from gpflowpilco_torch.models.gp import SVGP
from gpflowpilco_torch.models.kernels import RBF
from gpflowpilco_torch.utils.optimizers import make_policy_schedule


@dataclasses.dataclass
class System:
    loop: pilco.PathwisePILCO
    policy: SVGP
    drift: SVGP
    params: List[torch.nn.Parameter]
    names: List[str]  # the leaves' names, as the reference calls them
    schedule: Callable[[int], float]
    generator: torch.Generator

    def loss(self) -> torch.Tensor:
        """One step's loss: fresh paths, fresh initial states, the rollout."""
        return self.loop.policy_loss_fn(self.policy, self.generator, drift=self.drift)


def _svgp(raw: dict, spec: dict, whiten: bool = True) -> SVGP:
    clone = lambda t: None if t is None else t.detach().clone()  # noqa: E731
    kernel = RBF(clone(raw["raw_variance"]), clone(raw["raw_lengthscales"]),
                 ls_low=spec["ls_low"], ls_high=spec["ls_high"])
    z = raw["z"]
    return SVGP(kernel=kernel, z=clone(z), q_mu=clone(raw["q_mu"]), q_sqrt=clone(raw["q_sqrt"]),
                mean_const=clone(raw["mean_const"]),
                raw_noise=torch.zeros((), dtype=z.dtype, device=z.device),
                w=clone(raw["w"]), whiten=whiten)


def build_system(cfg: dict, traffic: dict, inputs: dict, step_seed: int, device) -> System:
    dtype = inputs["policy"]["z"].dtype
    spec = EpisodeSpec(state_mean=np.asarray(cfg["state_mean"]),
                       state_scale_tril=np.asarray(cfg["state_scale_tril"]),
                       horizon=cfg["horizon"], step_size=cfg["step_size"])
    objective = GaussianObjective.create(
        target=torch.as_tensor(cfg["target"], dtype=dtype, device=device),
        precis=torch.as_tensor(cfg["precis"], dtype=dtype, device=device))
    policy_spec = pilco.PolicySpec(
        step_limit=cfg["step_limit"], initial_learning_rate=cfg["learning_rate"],
        global_clipnorm=cfg["global_clipnorm"], batch_size=cfg["particles"],
        num_bases=cfg["bases"], action_scale=cfg["action_scale"], num_restarts=1,
        num_centers=cfg["policy"]["num_inducing"])
    loop = pilco.PathwisePILCO(
        env=None, episode_spec=spec, objective=objective,
        encoder=trigonometric_encoder(active_dims=tuple(cfg["active_dims"])),
        device=device, dtype=dtype, policy_spec=policy_spec)
    loop.use_fused_rollout = traffic["route"] == "fused_rollout"
    loop.drift_model = _svgp(inputs["drift"], cfg["drift"])
    loop.policy_model = _svgp(inputs["policy"], cfg["policy"])
    drift = loop.policy_loss_drift()
    params = pilco.policy_mask(loop.policy_model)
    names = [name.split(".")[-1] for name, p in loop.policy_model.named_parameters() if p.requires_grad]
    return System(
        loop=loop, policy=loop.policy_model, drift=drift, params=params, names=names,
        schedule=make_policy_schedule(policy_spec.step_limit, policy_spec.initial_learning_rate),
        generator=torch.Generator(device=device).manual_seed(step_seed),
    )
