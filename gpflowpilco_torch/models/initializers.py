"""Model initializers: median-heuristic lengthscales, k-means inducing points
(counterpart of gpflowpilco_tpu/models/initializers.py).

They run once per episode boundary, outside the hot path. The k-means++
seeding runs in numpy, as in the JAX package; the Lloyd iterations run on the
data's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def lengthscales_median(
    x: torch.Tensor, lower: Optional[float] = 0.01, upper: Optional[float] = 100.0
) -> torch.Tensor:
    """sqrt(1/2) * median pairwise distance, clipped away from the constraint
    bounds, as a (D,) tensor."""
    n = x.shape[0]
    if n > 2048:  # subsample for the O(n^2) distance matrix
        idx = np.random.default_rng(0).choice(n, 2048, replace=False)
        x = x[torch.as_tensor(idx, device=x.device)]
    d2 = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1, device=x.device)
    # quantile interpolates between the two middle values, as jnp.median does
    med = torch.quantile(torch.sqrt(d2[iu[0], iu[1]]), 0.5)
    init = torch.sqrt(torch.tensor(0.5, dtype=x.dtype, device=x.device)) * med
    lo = None if lower is None else 1.1 * lower
    hi = None if upper is None else 0.9 * upper
    if lo is not None or hi is not None:
        init = torch.clamp(init, lo, hi)
    return torch.full((x.shape[-1],), float(init), dtype=x.dtype, device=x.device)


def _lloyd(x: torch.Tensor, centers: torch.Tensor, num_iters: int) -> torch.Tensor:
    num_clusters = centers.shape[0]
    for _ in range(num_iters):
        d2 = (
            torch.sum(x**2, -1)[:, None]
            - 2.0 * x @ centers.T
            + torch.sum(centers**2, -1)[None, :]
        )
        assign = torch.argmin(d2, dim=-1)
        one_hot = torch.nn.functional.one_hot(assign, num_clusters).to(x.dtype)
        counts = one_hot.sum(0)
        sums = one_hot.T @ x
        centers = torch.where(
            counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
        )
    return centers


def inducing_points_kmeans(
    x: torch.Tensor,
    num_inducing: int,
    generator: Optional[torch.Generator] = None,
    num_iters: int = 50,
) -> torch.Tensor:
    """k-means cluster centres as inducing inputs. With n <= num_inducing the
    data itself comes back (the caller sizes M = min(M, n))."""
    n = x.shape[0]
    if n <= num_inducing:
        return x.clone()
    device = None if generator is None else generator.device
    seed = int(torch.randint(0, 2**31 - 1, (), generator=generator, device=device))
    rng = np.random.default_rng(seed)
    xn = x.detach().cpu().numpy()
    # k-means++ style seeding: distance-weighted picks from a random start
    centers = [xn[rng.integers(n)]]
    d2 = np.sum((xn - centers[0]) ** 2, -1)
    for _ in range(num_inducing - 1):
        probs = d2 / max(d2.sum(), 1e-12)
        centers.append(xn[rng.choice(n, p=probs)])
        d2 = np.minimum(d2, np.sum((xn - centers[-1]) ** 2, -1))
    init = torch.as_tensor(np.stack(centers), dtype=x.dtype, device=x.device)
    return _lloyd(x, init, num_iters)


def replace_duplicates(
    points: np.ndarray,
    variance: float,
    lengthscales: np.ndarray,
    tol: float,
    num_attempts: int = 32,
    seed: int = 0,
) -> np.ndarray:
    """Perturb points whose RBF correlation with any other exceeds ``tol``
    (PILCO's defence against a singular Kuu)."""
    if tol >= 1:
        return points
    points = np.array(points, copy=True)
    ls = np.asarray(lengthscales)
    rng = np.random.default_rng(seed)

    def corr_row(a, b):
        d2 = np.sum(((a - b) / ls) ** 2, -1)
        return np.exp(-0.5 * d2)

    corr = corr_row(points[:, None], points[None, :])
    np.fill_diagonal(corr, -np.inf)
    hits = np.sum(corr > tol, axis=-1)
    while np.any(hits > 0):
        index = int(np.argmax(hits))
        original = points[index].copy()
        for attempt in range(num_attempts):
            alt = original + 1e-3 * (1.1**attempt) * rng.normal(size=original.shape)
            xorr = corr_row(points, alt[None])
            xorr[index] = -np.inf
            if not np.any(xorr >= tol):
                points[index] = alt
                corr[index, :] = xorr
                corr[:, index] = xorr
                break
            if attempt + 1 == num_attempts:
                corr[index, :] = -np.inf
                corr[:, index] = -np.inf
        hits = np.sum(corr > tol, axis=-1)
    return points
