"""The system under test: a port PILCO loop, its drift and policy SVGPs
built from the cell's inputs, and the policy update's pieces (the masked
leaves, the schedule, the steps' generator) exactly as
``PILCOBase.update_policy`` assembles them for one candidate. A variant
module (``systems/``) picks the loop class and its routes; the pieces every
variant shares are here (``loop_args``, ``assemble``)."""
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
    loop: pilco.PILCOBase
    policy: SVGP
    drift: object  # what the loop's policy_loss_drift gives: the frozen SVGP, or a transform of it
    params: List[torch.nn.Parameter]
    names: List[str]  # the leaves' names, as the reference calls them
    schedule: Callable[[int], float]
    generator: torch.Generator

    def loss(self) -> torch.Tensor:
        """One step's loss, as the loop computes it for ``update_policy``."""
        return self.loop.policy_loss_fn(self.policy, self.generator, drift=self.drift)


def svgp(raw: dict, spec: dict, whiten: bool = True) -> SVGP:
    """The SVGP with the raw parameters ``raw`` (cloned) and the bounds of
    the configuration's group ``spec``."""
    clone = lambda t: None if t is None else t.detach().clone()  # noqa: E731
    kernel = RBF(clone(raw["raw_variance"]), clone(raw["raw_lengthscales"]),
                 ls_low=spec["ls_low"], ls_high=spec["ls_high"])
    z = raw["z"]
    return SVGP(kernel=kernel, z=clone(z), q_mu=clone(raw["q_mu"]), q_sqrt=clone(raw["q_sqrt"]),
                mean_const=clone(raw["mean_const"]),
                raw_noise=torch.zeros((), dtype=z.dtype, device=z.device),
                w=clone(raw["w"]), whiten=whiten)


def loop_args(cfg: dict, inputs: dict, device) -> dict:
    """The keywords of a ``PILCOBase`` loop for the configuration, in the
    inputs' dtype: the episode, the objective, the trigonometric encoder and
    one candidate's policy spec."""
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
    return dict(env=None, episode_spec=spec, objective=objective,
                encoder=trigonometric_encoder(active_dims=tuple(cfg["active_dims"])),
                device=device, dtype=dtype, policy_spec=policy_spec)


def assemble(loop: pilco.PILCOBase, cfg: dict, inputs: dict, step_seed: int, device) -> System:
    """Give ``loop`` the inputs' drift and policy and take the update's pieces."""
    loop.drift_model = svgp(inputs["drift"], cfg["drift"])
    loop.policy_model = svgp(inputs["policy"], cfg["policy"])
    drift = loop.policy_loss_drift()
    params = pilco.policy_mask(loop.policy_model)
    names = [name.split(".")[-1] for name, p in loop.policy_model.named_parameters() if p.requires_grad]
    spec = loop.policy_spec
    return System(
        loop=loop, policy=loop.policy_model, drift=drift, params=params, names=names,
        schedule=make_policy_schedule(spec.step_limit, spec.initial_learning_rate),
        generator=torch.Generator(device=device).manual_seed(step_seed),
    )


def build_system(cfg: dict, traffic: dict, inputs: dict, step_seed: int, device) -> System:
    """The pathwise variant's system (``systems/pathwise.py``), whatever
    system ``traffic`` names."""
    from .spec import variant_module

    return variant_module("pathwise").build_system(cfg, traffic, inputs, step_seed, device)
