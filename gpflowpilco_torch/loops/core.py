"""Episode containers and specs (counterpart of gpflowpilco_tpu/loops/core.py)."""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class EpisodeSpec(NamedTuple):
    state_mean: np.ndarray  # (D,)
    state_scale_tril: np.ndarray  # (D, D)
    horizon: float
    step_size: float

    @property
    def num_steps(self) -> int:
        return int(math.ceil(self.horizon / self.step_size))

    def sample(self, generator: Optional[torch.Generator], shape=(), dtype=None, device=None):
        """Initial states mean + tril @ N(0, I), of shape ``shape + (D,)``."""
        mean = torch.as_tensor(self.state_mean, dtype=dtype, device=device)
        tril = torch.as_tensor(self.state_scale_tril, dtype=mean.dtype, device=mean.device)
        rvs = torch.randn(
            tuple(shape) + mean.shape, generator=generator, dtype=mean.dtype, device=mean.device
        )
        return mean + torch.einsum("ij,...j->...i", tril, rvs)


class EpisodeData(NamedTuple):
    states: np.ndarray  # (T+1, D)
    actions: np.ndarray  # (T, U)
    metrics: Dict[str, float]


def stack_episodes(episodes: List[EpisodeData]):
    """(E, T+1, D), (E, T, U) state/action stacks."""
    states = np.stack([ep.states for ep in episodes])
    actions = np.stack([ep.actions for ep in episodes])
    return states, actions
