"""Shared helpers for the PyTorch-port tests: JAX models built from numpy
seeds and exported as numpy dicts named after the JAX fields
(the method of bench_baselines.py), for gpflowpilco_torch.convert."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gpflowpilco_tpu.models.gp import SVGP
from gpflowpilco_tpu.models.kernels import RBF
from gpflowpilco_tpu.utils import bijectors as bij

CPU = torch.device("cpu")
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def jax_svgp(seed, num_latent=3, m=8, d=5, dtype=jnp.float64, whiten=True, num_out=None):
    """A JAX SVGP with numpy-drawn parameters; a mixing matrix when
    ``num_out`` is given."""
    rng = np.random.default_rng(seed)
    arr = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    q_sqrt = np.tril(0.1 * rng.normal(size=(num_latent, m, m))) + 0.3 * np.eye(m)
    kernel = RBF.create(
        arr(rng.uniform(0.5, 1.5, size=num_latent)),
        arr(rng.uniform(0.7, 2.0, size=(num_latent, d))),
    )
    p = num_latent if num_out is None else num_out
    return SVGP(
        kernel=kernel,
        z=arr(rng.normal(size=(num_latent, m, d))),
        q_mu=arr(0.5 * rng.normal(size=(m, num_latent))),
        q_sqrt=arr(q_sqrt),
        mean_const=arr(0.1 * rng.normal(size=p)),
        raw_noise=bij.positive_inv(arr(0.05)),
        w=None if num_out is None else arr(rng.normal(size=(num_out, num_latent))),
        whiten=whiten,
    )


def svgp_to_numpy(model) -> dict:
    n = lambda a: np.asarray(a)  # noqa: E731
    return dict(
        raw_variance=n(model.kernel.raw_variance),
        raw_lengthscales=n(model.kernel.raw_lengthscales),
        z=n(model.z),
        q_mu=n(model.q_mu),
        q_sqrt=n(model.q_sqrt),
        mean_const=n(model.mean_const),
        raw_noise=n(model.raw_noise),
        w=None if model.w is None else n(model.w),
        whiten=model.whiten,
        ls_low=model.kernel.ls_low,
        ls_high=model.kernel.ls_high,
        num_outputs=getattr(model.kernel, "num_outputs", None),  # a SharedRBF's
    )


def paths_to_numpy(paths) -> dict:
    return {k: np.asarray(getattr(paths, k)) for k in ("omega", "phase", "w", "v")}


def jax_path_draws(model, key, num_samples, num_bases):
    """The draws jax generate_paths_svgp makes from ``key``, as numpy."""
    num_latent, m, d = model.z.shape
    dtype = model.z.dtype
    k_omega, k_phase, k_w, k_u = jax.random.split(key, 4)
    return dict(
        omega_normal=np.asarray(jax.random.normal(k_omega, (num_latent, num_bases, d), dtype)),
        phase=np.asarray(
            jax.random.uniform(k_phase, (num_latent, num_bases), dtype, maxval=2.0 * np.pi)
        ),
        w=np.asarray(jax.random.normal(k_w, (num_samples, num_latent, num_bases), dtype)),
        eps=np.asarray(jax.random.normal(k_u, (num_samples, num_latent, m), dtype)),
    )


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype, device=CPU)


def jax_gpr(seed, n=30, d=4, p=3, dtype=jnp.float64, noise=0.05):
    """A JAX GPR on numpy-drawn data, with numpy-drawn hyperparameters
    (lengthscales around 1, a nonzero mean)."""
    from gpflowpilco_tpu.models.gp import GPR

    rng = np.random.default_rng(seed)
    arr = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, :1] + x[:, 1:2]) * rng.uniform(0.5, 1.5, size=p) + 0.1 * rng.normal(size=(n, p))
    return GPR(
        kernel=RBF.create(arr(rng.uniform(0.7, 1.3)), arr(rng.uniform(0.8, 2.0, size=d))),
        x=arr(x),
        y=arr(y),
        mean_const=arr(0.1 * rng.normal(size=p)),
        raw_noise=bij.positive_inv(arr(noise)),
    )


def jax_gpr_members(seed, k=3, **kw):
    """A JAX GPR stacked over k members that share the data (the layout of
    GPREnsemble.members): each member's hyperparameters drawn around those
    of jax_gpr(seed)."""
    base = jax_gpr(seed, **kw)
    rng = np.random.default_rng(seed + 100)
    def stack(a):
        a = jnp.asarray(a)
        return jnp.stack([a + 0.1 * rng.normal(size=a.shape) if i else a for i in range(k)])

    members = jax.tree.map(stack, base)
    # the data are shared: undo the perturbation of x and y
    return members.__class__(
        kernel=members.kernel, x=jnp.stack([base.x] * k), y=jnp.stack([base.y] * k),
        mean_const=members.mean_const, raw_noise=members.raw_noise,
    )


def gpr_to_numpy(model) -> dict:
    n = lambda a: np.asarray(a)  # noqa: E731
    return dict(
        raw_variance=n(model.kernel.raw_variance),
        raw_lengthscales=n(model.kernel.raw_lengthscales),
        x=n(model.x),
        y=n(model.y),
        mean_const=n(model.mean_const),
        raw_noise=n(model.raw_noise),
        ls_low=model.kernel.ls_low,
        ls_high=model.kernel.ls_high,
    )
