"""The PyTorch port's optimizers and loop: Adam and L-BFGS against the JAX
package's drivers (float64), the not-yet-ported options of the pathwise and
moment-matching loops, and one tiny pathwise PILCO iteration on the CPU."""
import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflowpilco_tpu.models.gp import svgp_elbo as jax_elbo
from gpflowpilco_tpu.models.priors import pilco_snr_penalty as jax_snr
from gpflowpilco_tpu.utils import optimizers as jopt
from gpflowpilco_torch.convert import svgp_from_numpy
from gpflowpilco_torch.loops.driver import outer_loop
from gpflowpilco_torch.loops.pilco import DriftSpec, MomentMatchingPILCO, PathwisePILCO, PolicySpec
from gpflowpilco_torch.models.gp import svgp_elbo
from gpflowpilco_torch.models.priors import pilco_snr_penalty
from gpflowpilco_torch.utils import optimizers as topt

from ._torch_export import CPU, jax_svgp, svgp_to_numpy, t

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
import run_torch  # noqa: E402

torch.set_num_threads(1)


def _tiny_loop(seed=5, loop_cls=PathwisePILCO, **policy):
    return run_torch.build_loop(
        seed, CPU, torch.float64,
        drift_spec=DriftSpec(num_centers=6, max_iters=10, pad_data_multiple=0),
        policy_spec=PolicySpec(
            **{**dict(num_centers=5, step_limit=10, batch_size=8, num_bases=16, num_restarts=1), **policy}
        ),
        horizon=0.8,  # 8 steps
        loop_cls=loop_cls,
    )


def test_torch_pathwise_iteration_runs():
    loop = _tiny_loop()
    loop.step()  # random-action first episode
    assert len(loop.episodes) == 1
    assert loop.episodes[0].states.shape == (9, 4) and loop.episodes[0].actions.shape == (8, 1)
    assert np.all(np.abs(loop.episodes[0].actions) <= 10.0)

    info_d = loop.update_dynamics()
    assert np.isfinite(info_d["loss"]) and info_d["refit_candidates"] == 1
    info_p = loop.update_policy()
    assert np.isfinite(info_p["loss"]) and info_p["losses"].shape == (10,)
    ep = loop.step()
    assert len(loop.episodes) == 2 and np.isfinite(ep.metrics["rewards"])
    assert loop.best_policy_model is not None and loop.best_policy_model is not loop.policy_model

    # second iteration through the driver: the incumbent drift joins the refit
    outer_loop(loop, num_episodes=3, log_summaries=False)
    assert len(loop.episodes) == 3 and "fallback" in loop.episodes[-1].metrics


@pytest.mark.parametrize(
    "what", ["restarts", "loss_dtype", "optimism", "gpr", "save", "mm_fused_match", "mm_gpr"]
)
def test_torch_unported_options_raise(what):
    """``loss_dtype`` raises in the pathwise loop only; the MM loop takes it.
    The MM cases: the whole-match kernel and a GPR drift."""
    loop = _tiny_loop(
        loop_cls=MomentMatchingPILCO if what.startswith("mm_") else PathwisePILCO,
        **({"num_restarts": 4} if what == "restarts" else {}),
    )
    if what == "loss_dtype":
        loop.policy_spec = PolicySpec(loss_dtype=torch.float64, num_restarts=1)
    if what == "optimism":
        loop.drift_spec = DriftSpec(optimism_tolerance=1.0)
    if what in ("gpr", "mm_gpr"):
        loop.drift_spec = DriftSpec(model_type="gpr")
    if what == "mm_fused_match":
        loop.use_fused_match = True
    loop.step()
    with pytest.raises(NotImplementedError):
        if what == "save":
            loop.save()
        elif what in ("optimism", "gpr", "mm_gpr"):
            loop.update_dynamics()
        else:
            loop.update_dynamics()
            loop.update_policy()


def test_torch_policy_schedule_matches_optax():
    want = jopt.make_policy_schedule(300, 0.01)
    got = topt.make_policy_schedule(300, 0.01)
    for count in (0, 1, 99, 100, 101, 199, 200, 299, 400):
        assert math.isclose(got(count), float(want(count)), rel_tol=1e-12), count


def _quadratic(lib, poison_at=None):
    """A loss with a large gradient (so the clip acts), non-finite at one call."""
    target = np.array([3.0, -2.0, 0.5])
    target = jnp.asarray(target) if lib is jnp else torch.as_tensor(target)
    calls = []

    def loss(p):
        calls.append(1)
        val = lib.sum((p - target) ** 4) + 10.0 * lib.sum(p * p)
        if poison_at is not None and len(calls) == poison_at:
            val = val * float("nan")
        return val

    return loss


def test_torch_adam_matches_optax_adam_with_clip():
    p0 = np.array([0.1, 0.2, -0.3])
    sched = jopt.make_policy_schedule(30, 0.05)
    want_p, want_losses, _ = jopt.adam_minimize(
        _quadratic(jnp), jnp.asarray(p0), num_steps=30, schedule=sched, global_clipnorm=1.0
    )
    p = t(p0).requires_grad_(True)
    loss = _quadratic(torch)
    losses, skipped = topt.adam_minimize(
        lambda: loss(p), [p], num_steps=30,
        schedule=topt.make_policy_schedule(30, 0.05), global_clipnorm=1.0,
    )
    assert skipped == 0
    np.testing.assert_allclose(losses, np.asarray(want_losses), rtol=1e-10)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(want_p), rtol=1e-10)


def test_torch_adam_skips_nonfinite_steps():
    """A step whose gradient is not finite moves nothing: 12 steps with one
    poisoned land where 11 clean steps do."""
    p0 = np.array([0.1, 0.2, -0.3])
    p = t(p0).requires_grad_(True)
    loss = _quadratic(torch, poison_at=4)
    losses, skipped = topt.adam_minimize(lambda: loss(p), [p], num_steps=12, learning_rate=0.05)
    assert skipped == 1 and np.isnan(losses[3])
    q = t(p0).requires_grad_(True)
    clean = _quadratic(torch)
    topt.adam_minimize(lambda: clean(q), [q], num_steps=11, learning_rate=0.05)
    np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-12)


def test_torch_lbfgs_converged_elbo_matches_jax():
    """L-BFGS is held on the converged loss (ELBO + SNR penalty, as the drift
    fit uses), not on the iterates: the two line searches differ."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, size=(30, 1))
    y = np.sin(2.0 * x) + 0.1 * rng.normal(size=(30, 1))
    jm = jax_svgp(2, num_latent=1, m=6, d=1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _, want, _ = jopt.lbfgs_minimize(
        lambda m: -(jax_elbo(m, jx, jy) + jax_snr(m)), jm, max_iters=1000, tol=1e-9
    )
    tm = svgp_from_numpy(svgp_to_numpy(jm), CPU, torch.float64)
    got, iters = topt.lbfgs_minimize(
        lambda: -(svgp_elbo(tm, t(x), t(y)) + pilco_snr_penalty(tm)),
        list(tm.parameters()), max_iters=1000, tol=1e-9,
    )
    assert 0 < iters < 1000  # converged, not cut
    assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, float(want))
