"""One drift evaluation through the encoder/policy/drift composition
(counterpart of ``forward_concrete`` in gpflowpilco_tpu/dynamics/forward.py)."""
from __future__ import annotations

import torch


def forward_concrete(x, drift, policy=None, encoder=None):
    """drift(concat[e, policy(e)]) with e = encoder(x)."""
    e = x if encoder is None else encoder(x)
    eu = e if policy is None else torch.cat([e, policy(e)], dim=-1)
    return drift(eu)
