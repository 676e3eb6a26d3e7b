"""The PyTorch port's GPR moment match against the JAX package, float64: the
unfused rule, the pair-grid route (K2 with R = 4 rows, its plain version
here) and the GPR whole match (K3g, its plain version here), each for one
GPR and for 3 stacked members against the JAX package's vmap. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.moment_matching.gp import GPRTransform as JaxGPRTransform
from gpflowpilco_tpu.moment_matching.gp import gpr_match_cache as jax_gpr_match_cache
from gpflowpilco_tpu.moments import GaussianMoments as JaxMoments
from gpflowpilco_tpu.ops.kexp_pallas import build_fused_gpr_grid as jax_build_fused_gpr_grid
from gpflowpilco_tpu.ops.kexp_pallas import ekuffu_contract_gpr as jax_ekuffu_contract_gpr
from gpflowpilco_tpu.ops.mm_match_pallas import build_fused_gpr_match_grid as jax_build_match_grid
from gpflowpilco_tpu.ops.mm_match_pallas import fused_gpr_match as jax_fused_gpr_match
from gpflowpilco_torch.convert import gpr_from_numpy
from gpflowpilco_torch.moment_matching.gp import GPRTransform, gpr_match_cache
from gpflowpilco_torch.moments import GaussianMoments
from gpflowpilco_torch.ops.gpr_match_cuda import build_fused_gpr_match_grid, fused_gpr_match
from gpflowpilco_torch.ops.kexp_cuda import build_fused_gpr_grid, ekuffu_contract_gpr

from ._torch_export import CPU, gpr_to_numpy, jax_gpr, jax_gpr_members, t

torch.set_num_threads(1)
D, P = 4, 4


def _moments(seed, k=None):
    """mx (1, D), sxx (1, D, D), or (k, D), (k, D, D) for k members."""
    rng = np.random.default_rng(seed)
    n = 1 if k is None else k
    a = rng.normal(size=(n, D, D))
    mx = 0.3 * rng.normal(size=(n, D))
    sxx = 0.04 * a @ a.transpose(0, 2, 1) + 0.15 * np.eye(D)
    return mx, sxx


def _scaled(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _weights(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


@pytest.mark.parametrize("deterministic", [False, True])
def test_torch_match_gpr_matches_jax(deterministic):
    """Unfused match_gpr: f1, sff and cross to 1e-10 of each output's scale,
    and the gradient of a weighted sum of them in (mx, sxx) to 1e-9."""
    jm = jax_gpr(20, d=D, p=P)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    mx, sxx = _moments(21)
    w = _weights(22, [(1, P), (1, P, P), (1, D, P)])

    def jfn(m, s):
        out = JaxGPRTransform(model=jm, deterministic=deterministic).with_cache().moment_match(
            JaxMoments(mean=m, cov=s))
        outs = (out.y.mean, out.y.cov, out.cross_covariance(preinv=True))
        return sum(jnp.sum(wi * o) for wi, o in zip(w, outs)), outs

    (_, want), jgrad = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(mx), jnp.asarray(sxx))
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    out = GPRTransform(tm.requires_grad_(False), deterministic=deterministic).with_cache().moment_match(
        GaussianMoments(tmx, tsxx))
    outs = (out.y.mean, out.y.cov, out.cross_covariance(preinv=True))
    for got, ref in zip(outs, want):
        assert _scaled(got.detach(), ref) <= 1e-10
    sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
    assert _scaled(tmx.grad, jgrad[0]) <= 1e-9
    assert _scaled(tsxx.grad, jgrad[1]) <= 1e-9


@pytest.mark.parametrize("stacked", [False, True])
def test_torch_gpr_pair_grid_route_matches_jax(stacked):
    """The pair-grid route (K2 with R = 4 rows of alpha^T): the port's plain
    version against the JAX package's ekuffu_contract_gpr with its Pallas
    kernel in interpret mode, 1e-10 of the scale; 3 stacked members (on the
    kernel's pair axis here) against the JAX package's vmap."""
    if stacked:
        jm = jax_gpr_members(23, d=D, p=P)
        mx, sxx = _moments(24, k=3)
    else:
        jm = jax_gpr(23, d=D, p=P)
        mx, sxx = _moments(24)

    def jone(m, a, s):
        c = jax_gpr_match_cache(m)
        grid = jax_build_fused_gpr_grid(m.kernel.variance, m.kernel.lengthscales, m.x, c.alpha, c.kyy_inv)
        return jax_ekuffu_contract_gpr(grid, a, s)

    with pltpu.force_tpu_interpret_mode():
        if stacked:
            want = jax.vmap(lambda m, a, s: jone(m, a[None], s[None]))(jm, jnp.asarray(mx), jnp.asarray(sxx))
            want = tuple(w[:, 0] for w in want)
        else:
            want = jone(jm, jnp.asarray(mx), jnp.asarray(sxx))
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64)
    with torch.no_grad():
        c = gpr_match_cache(tm, fused=True)
        assert c.fused_grid.alphat.shape == ((3 if stacked else 1), P, 30)
        got = ekuffu_contract_gpr(c.fused_grid, t(mx), t(sxx))
        ref_grid = build_fused_gpr_grid(tm.kernel.variance, tm.kernel.lengthscales, tm.x, c.alpha, c.kyy_inv)
        assert torch.equal(ref_grid.qm, c.fused_grid.qm)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _scaled(g, w) <= 1e-10


@pytest.mark.parametrize("stacked", [False, True])
def test_torch_gpr_whole_match_matches_jax(stacked):
    """The GPR whole match (K3g): the port's plain version against the JAX
    package's fused_gpr_match (Pallas, interpret mode), values and the
    frozen (mx, sxx) cotangents to 1e-9 of the scale; 3 stacked members,
    each matched against its own moments, against the JAX package's vmap."""
    if stacked:
        jm = jax_gpr_members(25, d=D, p=P)
        mx, sxx = _moments(26, k=3)
    else:
        jm = jax_gpr(25, d=D, p=P)
        mx, sxx = _moments(26)
    w = _weights(27, [(mx.shape[0], P), (mx.shape[0], P, P), (mx.shape[0], D, P)])

    def jone(m, a, s, wts):
        grid = jax_build_match_grid(m, uncertainty=True)
        outs = jax_fused_gpr_match(grid, a, s)
        return sum(jnp.sum(wi * o) for wi, o in zip(wts, outs)), outs

    with pltpu.force_tpu_interpret_mode():
        if stacked:
            def jsum(a, s):
                vals, outs = jax.vmap(lambda m, a1, s1, w0, w1, w2: jone(m, a1[None], s1[None], (w0, w1, w2)))(
                    jm, a, s, *(jnp.asarray(x)[:, None] for x in w))
                return jnp.sum(vals), tuple(o[:, 0] for o in outs)
        else:
            def jsum(a, s):
                return jone(jm, a, s, [jnp.asarray(x) for x in w])
        (_, want), jgrad = jax.value_and_grad(jsum, argnums=(0, 1), has_aux=True)(
            jnp.asarray(mx), jnp.asarray(sxx))

    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64).requires_grad_(False)
    c = gpr_match_cache(tm)
    grid = build_fused_gpr_match_grid(tm, c.alpha, c.kyy_inv, uncertainty=True)
    assert grid.meta.num_members == (3 if stacked else 1)
    tmx, tsxx = t(mx).requires_grad_(True), t(sxx).requires_grad_(True)
    outs = fused_gpr_match(grid, tmx, tsxx)
    for g, ref in zip(outs, want):
        assert g.shape == ref.shape and _scaled(g.detach(), ref) <= 1e-9
    sum(torch.sum(t(wi) * o) for wi, o in zip(w, outs)).backward()
    assert _scaled(tmx.grad, jgrad[0]) <= 1e-9
    assert _scaled(tsxx.grad, jgrad[1]) <= 1e-9


@pytest.mark.parametrize("route", ["fused", "fused_match"])
def test_torch_gpr_kernel_routes_match_unfused(route):
    """Through GPRTransform, both kernel routes (their plain versions here)
    agree with the unfused rule on a stacked GPR with a batch of
    (2, 3 members) moments, values to 1e-10 of the scale."""
    jm = jax_gpr_members(28, d=D, p=P)
    tm = gpr_from_numpy(gpr_to_numpy(jm), CPU, torch.float64).requires_grad_(False)
    mx, sxx = _moments(29, k=6)
    x = GaussianMoments(t(mx).reshape(2, 3, D), t(sxx).reshape(2, 3, D, D))
    with torch.no_grad():
        ref = GPRTransform(tm).with_cache().moment_match(x)
        got = GPRTransform(tm, **{route: True}).with_cache().moment_match(x)
    for a, b in ((got.y.mean, ref.y.mean), (got.y.cov, ref.y.cov), (got.cross, ref.cross)):
        assert a.shape == b.shape and _scaled(a, b) <= 1e-10
