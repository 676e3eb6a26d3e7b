"""The PyTorch port's rollout pieces and the pathwise particle loss held
against the JAX package in float64: the cartpole environment and RK4, the
encoder/cost/policy chain, the Euler rollout, and the loss with its gradient
in the policy's raw parameters on identical exported paths, x0 and models."""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.dynamics import solvers as jsolvers
from gpflowpilco_tpu.envs.base import clip_derivative as jax_clip_derivative
from gpflowpilco_tpu.envs.base import env_step as jax_env_step
from gpflowpilco_tpu.envs.cartpole import CartPole as JaxCartPole
from gpflowpilco_tpu.loops.pilco import PathwisePILCO as JaxPathwisePILCO
from gpflowpilco_tpu.loops.pilco import PolicySpec as JaxPolicySpec
from gpflowpilco_tpu.models.pathwise import PathwiseSVGPTransform as JaxPathwiseSVGPTransform
from gpflowpilco_tpu.models.pathwise import generate_paths_svgp as jax_generate
from gpflowpilco_tpu.moment_matching.rules import Probit as JaxProbit
from gpflowpilco_tpu.moment_matching.rules import Scale as JaxScale
from gpflowpilco_tpu.moment_matching.rules import Shift as JaxShift
from gpflowpilco_tpu.moments import Chain as JaxChain
from gpflowpilco_torch.convert import paths_from_numpy, svgp_from_numpy
from gpflowpilco_torch.dynamics import solvers as tsolvers
from gpflowpilco_torch.envs.base import clip_derivative, env_step
from gpflowpilco_torch.envs.cartpole import CartPole
from gpflowpilco_torch.loops.pilco import PolicySpec
from gpflowpilco_torch.models.builders import policy_mask
from gpflowpilco_torch.models.pathwise import PathwiseSVGPTransform
from gpflowpilco_torch.moment_matching.rules import Probit, Scale, Shift, SquashedProbit
from gpflowpilco_torch.moments import Chain

from ._torch_export import CPU, jax_svgp, paths_to_numpy, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import experiment as jax_experiment  # noqa: E402
import run_torch  # noqa: E402

torch.set_num_threads(1)


def test_torch_cartpole_env_step_and_rk4_match_jax():
    rng = np.random.default_rng(0)
    states = rng.normal(size=(6, 4)) * [1.0, 3.0, 2.0, 4.0]
    actions = rng.uniform(-15.0, 15.0, size=(6, 1))  # some beyond the +-10 box
    got = env_step(CartPole(), t(states), t(actions), 0.1, 10)
    want = jax_env_step(JaxCartPole(), jnp.asarray(states), jnp.asarray(actions), 0.1, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)

    def ode(lib):
        return lambda x: lib.stack([x[..., 1], -lib.sin(x[..., 0])], -1)

    tip, jtip = CartPole().get_tip_coordinates(t(states)), JaxCartPole().get_tip_coordinates(states)
    for g, w in zip(tip, jtip):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    deriv = rng.normal(size=(6, 4)) * 5.0
    np.testing.assert_allclose(
        clip_derivative(t(deriv), t(states), [-2.0] * 4, [2.0] * 4).numpy(),
        np.asarray(jax_clip_derivative(jnp.asarray(deriv), jnp.asarray(states), [-2.0] * 4, [2.0] * 4)),
        rtol=1e-12, atol=1e-12,
    )

    x0 = rng.normal(size=(3, 2))
    got = tsolvers.rk4_integrate(ode(torch), t(x0), 0.7, 7)
    want = jsolvers.rk4_integrate(ode(jnp), jnp.asarray(x0), 0.7, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_torch_euler_rollout_matches_jax():
    x0 = np.random.default_rng(1).normal(size=(5, 3))
    tx, tacc, txs = tsolvers.euler_rollout(
        lambda tt, xx: -0.3 * xx + 0.1 * tt, t(x0), 0.5, 4,
        accumulate=lambda tt, xx, a: a + torch.sum(xx * xx, -1), acc_init=t(np.zeros(5)),
    )
    jx, jacc, jxs = jsolvers.euler_rollout(
        lambda tt, xx: -0.3 * xx + 0.1 * tt, jnp.asarray(x0), 0.5, 4,
        accumulate=lambda tt, xx, a: a + jnp.sum(xx * xx, -1), acc_init=jnp.zeros(5),
    )
    for g, w in ((tx, jx), (tacc, jacc), (txs, jxs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_torch_encoder_cost_and_policy_chain_match_jax():
    jloop = JaxPathwisePILCO(*_jax_task(), dtype=jnp.float64)
    tloop = run_torch.build_loop(0, CPU, torch.float64)
    jpol = jax_svgp(3, num_latent=1, m=6, d=5)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    states = np.random.default_rng(2).normal(size=(7, 4)) * [1.0, 3.0, 2.0, 4.0]
    jfeat = jax.jit(jloop.encode)(jnp.asarray(states))
    tfeat = tloop.encode(t(states))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tloop.objective(tfeat).numpy(), np.asarray(jax.jit(lambda f: jloop.objective(f))(jfeat)),
        rtol=1e-12, atol=1e-14,
    )
    # the squash collapses Chain(Scale, Shift, Probit), as in the JAX package
    g = t(np.linspace(-3.0, 3.0, 13))
    np.testing.assert_allclose(
        Chain(Scale(19.0), Shift(-0.5), Probit())(g).numpy(),
        np.asarray(JaxChain(JaxScale(19.0), JaxShift(-0.5), JaxProbit())(jnp.asarray(g.numpy()))),
        rtol=1e-12, atol=1e-12,
    )
    torch.testing.assert_close(SquashedProbit(19.0)(g), Chain(Scale(19.0), Shift(-0.5), Probit())(g))
    np.testing.assert_allclose(
        tloop.policy_chain(tpol)(tfeat).detach().numpy(),
        np.asarray(jax.jit(lambda p, f: jloop.policy_chain(p)(f))(jpol, jfeat)),
        rtol=1e-10, atol=1e-12,
    )


def _jax_task(horizon=3.0):
    env, encoder, objective, spec = jax_experiment.build_task(jnp.float64, horizon=horizon)
    return env, spec, objective, encoder


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_particle_loss_and_grad_match_jax(seed):
    """The pathwise policy loss through the port's kernel op (its plain
    version on the CPU) against the JAX unfused loss, float64: the loss to
    rel 1e-9, the gradient in the policy's raw parameters to cos >= 0.9999
    with norm ratio within 1e-6."""
    s, b, horizon = 12, 16, 0.5  # 5 Euler steps
    jloop = JaxPathwisePILCO(
        *_jax_task(horizon), dtype=jnp.float64,
        policy_spec=JaxPolicySpec(batch_size=s, num_bases=b, num_restarts=1),
    )
    tloop = run_torch.build_loop(
        seed, CPU, torch.float64,
        policy_spec=PolicySpec(batch_size=s, num_bases=b, num_restarts=1), horizon=horizon,
    )
    jdrift = jax_svgp(10 + seed, num_latent=4, m=8, d=6)
    jdrift = dataclasses.replace(jdrift, q_mu=0.2 * jdrift.q_mu)  # a gentle drift
    jpol = jax_svgp(20 + seed, num_latent=1, m=6, d=5)
    k_paths, k_init = jax.random.split(jax.random.PRNGKey(seed))
    jpaths = jax_generate(jdrift, k_paths, s, b)
    x0 = np.asarray(jloop.episode_spec.sample(k_init, (s,)))

    def jax_loss(pm):
        return jloop._particle_rollout_loss(
            pm, JaxPathwiseSVGPTransform(model=jdrift, paths=jpaths), k_init, s
        )

    want_loss, want_grad = jax.jit(jax.value_and_grad(jax_loss))(jpol)

    tdrift = svgp_from_numpy(svgp_to_numpy(jdrift), CPU, torch.float64).requires_grad_(False)
    tpol = svgp_from_numpy(svgp_to_numpy(jpol), CPU, torch.float64)
    policy_mask(tpol)
    drift_fn = PathwiseSVGPTransform(
        tdrift, paths_from_numpy(paths_to_numpy(jpaths), CPU, torch.float64), fused=True
    )
    loss = tloop._particle_rollout_loss(tpol, drift_fn, t(x0))
    loss.backward()

    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-9 * abs(float(want_loss))
    got = np.concatenate([
        tpol.kernel.raw_lengthscales.grad.numpy().ravel(),
        tpol.z.grad.numpy().ravel(),
        tpol.q_mu.grad.numpy().ravel(),
    ])
    want = np.concatenate([
        np.asarray(want_grad.kernel.raw_lengthscales).ravel(),
        np.asarray(want_grad.z).ravel(),
        np.asarray(want_grad.q_mu).ravel(),
    ])
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    ratio = np.linalg.norm(got) / np.linalg.norm(want)
    assert np.linalg.norm(want) > 0
    assert cos >= 0.9999 and abs(ratio - 1.0) <= 1e-6, (cos, ratio)
