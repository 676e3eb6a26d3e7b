"""The PyTorch port's path-eval kernel op (gpflowpilco_torch/ops/path_eval_cuda.py)
held against the JAX package.

On the CPU the op runs its plain-torch version and backward formulas; the
JAX fused op runs its Pallas kernel in interpret mode. Tolerances: 2e-5 in
float32 (the JAX kernel's own parity bar against its unfused path), 1e-10 in
float64 (the same arithmetic in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models.pathwise import PathState as JaxPathState
from gpflowpilco_tpu.models.pathwise import eval_paths_svgp as jax_eval
from gpflowpilco_torch.convert import paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.models.pathwise import PathState, eval_paths_svgp
from gpflowpilco_torch.ops import path_eval_cuda as pe

from ._torch_export import CPU, TORCH_DTYPE, jax_svgp, paths_to_numpy, svgp_to_numpy

torch.set_num_threads(1)


def _setup(dtype, s=48, num_latent=3, m=12, b=40, d=5, seed=3, num_out=None):
    jm = jax_svgp(seed, num_latent, m, d, dtype, num_out=num_out)
    # evaluation needs any paths, not posterior ones: numpy draws of the right scale
    rng = np.random.default_rng(seed + 1)
    jpaths = JaxPathState(
        omega=jnp.asarray(rng.normal(size=(num_latent, b, d)), dtype),
        phase=jnp.asarray(rng.uniform(0, 2 * np.pi, size=(num_latent, b)), dtype),
        w=jnp.asarray(rng.normal(size=(s, num_latent, b)), dtype),
        v=jnp.asarray(rng.normal(size=(s, num_latent, m)), dtype),
    )
    x = rng.normal(size=(s, d))
    tdtype = TORCH_DTYPE[dtype]
    model = svgp_from_numpy(svgp_to_numpy(jm), CPU, tdtype).requires_grad_(False)
    paths = paths_from_numpy(paths_to_numpy(jpaths), CPU, tdtype)
    return jm, jpaths, jnp.asarray(x, dtype), model, paths, torch.as_tensor(x, dtype=tdtype)


def test_torch_fused_matches_jax_fused_interpret_f32():
    from jax.experimental.pallas import tpu as pltpu

    from gpflowpilco_tpu.ops import path_eval_pallas as jpe

    jm, jpaths, jx, model, paths, x = _setup(jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpe.eval_paths_svgp_fused(jm, jpaths, jx))
    got = pe.eval_paths_svgp_fused(model, paths, x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("num_out", [None, 2])
def test_torch_fused_matches_unfused_f64(num_out):
    jm, jpaths, jx, model, paths, x = _setup(jnp.float64, num_out=num_out)
    want = np.asarray(jax_eval(jm, jpaths, jx))
    fused = pe.eval_paths_svgp_fused(model, paths, x).numpy()
    plain = eval_paths_svgp(model, paths, x).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(fused, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("free_paths", [False, True])
def test_torch_fused_grads_match_jax_grad(free_paths):
    """dx with frozen paths; dx, dw and dv with free paths, against jax.grad
    of the JAX package's eval_paths_svgp (float64)."""
    jm, jpaths, jx, model, paths, x = _setup(jnp.float64)

    def jax_loss(x_, w_, v_):
        p = dataclasses.replace(jpaths, w=w_, v=v_)
        return jnp.sum(jnp.sin(jax_eval(jm, p, x_)))

    argnums = (0, 1, 2) if free_paths else (0,)
    want = jax.grad(jax_loss, argnums=argnums)(jx, jpaths.w, jpaths.v)

    x = x.clone().requires_grad_(True)
    w = paths.w.clone().requires_grad_(free_paths)
    v = paths.v.clone().requires_grad_(free_paths)
    f = pe.eval_paths_svgp_fused(model, PathState(paths.omega, paths.phase, w, v), x)
    torch.sum(torch.sin(f)).backward()
    got = (x.grad, w.grad, v.grad) if free_paths else (x.grad,)
    if not free_paths:
        assert w.grad is None and v.grad is None
    for g, wnt, name in zip(got, want, ("dx", "dw", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-9, atol=1e-12, err_msg=name)


def test_torch_frozen_paths_take_dx_only_branch(monkeypatch):
    used = []
    orig_dx, orig_full = pe._bwd_dx, pe._bwd_full
    monkeypatch.setattr(pe, "_bwd_dx", lambda *a: (used.append("dx"), orig_dx(*a))[1])
    monkeypatch.setattr(pe, "_bwd_full", lambda *a: (used.append("full"), orig_full(*a))[1])
    _, _, _, model, paths, x = _setup(jnp.float64, s=16, b=16, m=6)

    x1 = x.clone().requires_grad_(True)
    pe.eval_paths_svgp_fused(model, paths, x1).sum().backward()
    assert used == ["dx"]

    used.clear()
    w = paths.w.clone().requires_grad_(True)
    pe.eval_paths_svgp_fused(model, paths._replace(w=w), x).sum().backward()
    assert used == ["full"] and w.grad is not None


def test_torch_fused_refuses_grads_it_cannot_give():
    _, _, _, model, paths, x = _setup(jnp.float64, s=8, b=8, m=4)
    omega = paths.omega.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        pe.eval_paths_svgp_fused(model, paths._replace(omega=omega), x)
    model.kernel.raw_lengthscales.requires_grad_(True)  # a drift hyperparameter
    with pytest.raises(NotImplementedError):
        pe.eval_paths_svgp_fused(model, paths, x)


def test_torch_path_eval_operand_shapes_are_checked():
    """The CUDA wrapper validates every operand's shape before it passes
    pointers to the kernel."""
    _, _, _, model, paths, x = _setup(jnp.float32, s=8, b=8, m=4)
    ops = (x, *pe.fused_operands(model, paths))
    g = torch.zeros((8, 3))
    assert pe.operand_shape(*ops, g) == (8, 3, 8, 4, 5)
    with pytest.raises(ValueError, match="phase"):
        pe.operand_shape(*ops[:4], ops[4][:, :1], *ops[5:])
    with pytest.raises(ValueError, match="g has"):
        pe.operand_shape(*ops, g[:, :2])
    with pytest.raises(ValueError, match="D <= 16"):
        wide = torch.zeros((8, 17))
        pe.operand_shape(wide, *ops[1:3], torch.zeros((3, 8, 17)), ops[4],
                         torch.zeros((3, 4, 17)), ops[6], torch.zeros((3, 17)))


def test_torch_path_eval_launch_counts_stay_zero_on_cpu():
    pe.reset_launches()
    _, _, _, model, paths, x = _setup(jnp.float32, s=8, b=8, m=4)
    x = x.requires_grad_(True)
    pe.eval_paths_svgp_fused(model, paths, x).sum().backward()
    assert pe.launches == {"path_eval_fwd": 0, "path_eval_bwd_dx": 0, "path_eval_bwd_full": 0}
