"""Operations of one draw of S posterior sample paths of the drift
(``generate_paths_svgp``), counted from the shapes as the algorithm needs
them (an FMA as two, a cos or exp as one):

- q(u) samples: Luu (q_mu + tril(q_sqrt) eps), two lower-triangular
  products per sample and latent, M (M + 1) each;
- the prior at the inducing inputs: the projection, the phase and the cos
  per (latent, center, basis), 2 Dxu + 2, and the weighted sum per sample,
  2 S L M B;
- Kuu (the scaled squared distance, the exp and the variance per pair, 3
  Dxu + 2), its Cholesky factor (M^3 / 3 per latent) and the two
  triangular solves per sample and latent, 2 M^2.
"""
from __future__ import annotations


def path_ops(n: dict) -> int:
    s, lat, m, b, dxu = n["S"], n["L"], n["M"], n["B"], n["Dxu"]
    samples = 2 * s * lat * m * (m + 1)
    prior = lat * m * b * (2 * dxu + 2) + 2 * s * lat * m * b
    solve = lat * m * m * (3 * dxu + 2) + lat * m ** 3 // 3 + 2 * s * lat * m * m
    return samples + prior + solve


def step_ops(n: dict) -> int:
    """One policy step: the paths, then K6's forward and backward (their
    counts in ``rollout``); the policy's own Kuu and the update are tiny."""
    from .rollout import bwd_ops, fwd_ops

    return path_ops(n) + fwd_ops(n) + bwd_ops(n)
