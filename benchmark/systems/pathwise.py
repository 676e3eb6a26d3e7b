"""The pathwise variant: ``PathwisePILCO``'s particle loss on fresh sample
paths of the drift and fresh initial states, the rollout through K6 where
the traffic's ``route`` is ``fused_rollout``. Its plain reference is
``reference/pathwise.py``; the contract is ``systems/__init__.py``'s."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.counts.paths import step_ops  # noqa: F401
from benchmark.harness.inputs import DTYPES, STEPS, derived_seed, dims, make_inputs  # noqa: F401
from benchmark.harness.system import System, assemble, loop_args
from benchmark.reference import pathwise as ref
from gpflowpilco_torch.loops import pilco

SPANS = ((pilco, "generate_paths_svgp", "paths"), (pilco, "fused_rollout_costs", "rollout_fwd"))
COSTS = (pilco, "fused_rollout_costs")
FAULTS = {"half_batch": dict(half_batch=True), "detach_last": dict(detach_last=True)}
TWIN = dict(nudge=True)


def build_system(cfg: dict, traffic: dict, inputs: dict, step_seed: int, device) -> System:
    loop = pilco.PathwisePILCO(**loop_args(cfg, inputs, device))
    loop.use_fused_rollout = traffic["route"] == "fused_rollout"
    return assemble(loop, cfg, inputs, step_seed, device)


def reference_record(cfg: dict, traffic: dict, inputs: dict, step_seed: int, *, control: bool = False,
                     half_batch: bool = False, kept=None, detach_last: bool = False,
                     nudge: bool = False) -> dict:
    """The reference's record in float64, or, with ``control``, the reference
    in the traffic's control precision, the one below the cell's (its
    Cholesky factors still in the cell's precision); with ``kept``, also the
    kept particles' gradient. ``half_batch``, ``detach_last`` and ``nudge``
    pass to ``reference_steps``."""
    draw = DTYPES[traffic["dtype"]]
    dtype, factor = torch.float64, torch.float64
    if control:
        dtype, factor = DTYPES[traffic["control"]], draw
    return ref.reference_steps(cfg, inputs["drift"], inputs["policy"], step_seed,
                               traffic["checked_steps"], draw_dtype=draw, dtype=dtype,
                               jitter=cfg["jitter"][traffic["dtype"]], factor_dtype=factor,
                               half_batch=half_batch, kept=kept, detach_last=detach_last, nudge=nudge)


def twin_gaps(cfg: dict, traffic: dict, inputs: dict, step_seed: int) -> torch.Tensor:
    dtype = traffic["dtype"]
    return ref.twin_gaps(cfg, inputs["drift"], inputs["policy"], step_seed, DTYPES[dtype],
                         cfg["jitter"][dtype])


def kept_particles(cfg: dict, traffic: dict, inputs: dict, step_seed: int, tau: float) -> torch.Tensor:
    dtype = traffic["dtype"]
    return ref.kept_particles(cfg, inputs["drift"], inputs["policy"], step_seed, DTYPES[dtype],
                              cfg["jitter"][dtype], tau)


def kept_gradient(steps, step_seed: int, kept: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The first step's raw gradient of the kept particles' mean cost through
    the port's own step: the window's system with its leaves set back to
    their start and its generator to the step seed, then ``policy_loss_fn``
    and ``backward()``. The fused rollout's costs (``pilco.
    fused_rollout_costs``, wrapped as the window wraps it) keep only the kept
    particles, so the port's ``mean()`` and K6's backward give the gradient;
    on the card the loss replays the window's own CUDA graphs."""
    system = steps.system
    index = kept.nonzero()[:, 0]
    original = pilco.fused_rollout_costs

    def masked(*args, **kwargs):
        costs = original(*args, **kwargs)
        return costs[index[index < costs.shape[0]]]

    with torch.no_grad():
        for p, p0 in zip(system.params, steps.start):
            p.copy_(p0)
            p.grad = None
    system.generator.manual_seed(step_seed)
    pilco.fused_rollout_costs = masked
    try:
        system.loss().backward()
    finally:
        pilco.fused_rollout_costs = original
    return {k: p.grad.detach().to(torch.float64) for k, p in zip(system.names, system.params)}


def witness(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The first step's per-particle costs, each route against the reference."""
    from gpflowpilco_torch.models.pathwise import PathwiseSVGPTransform

    dtype, f64 = DTYPES[traffic["dtype"]], torch.float64
    inputs = make_inputs(cfg, seed, dtype, device)
    step_seed = derived_seed(seed, STEPS)
    system = build_system(cfg, traffic, inputs, step_seed, device)
    loop, spec = system.loop, system.loop.policy_spec
    horizon = loop.episode_spec.num_steps
    marks = sorted({max(1, horizon * k // 5) for k in range(1, 6)})
    with torch.no_grad():
        paths = pilco.generate_paths_svgp(system.drift, system.generator, spec.batch_size, spec.num_bases)
        x0 = loop.episode_spec.sample(system.generator, (spec.batch_size,), dtype=dtype, device=device)
        drift_fn = PathwiseSVGPTransform(model=system.drift, paths=paths, fused=False)
        chain = loop.policy_chain(system.policy)
        gen = torch.Generator(device=device).manual_seed(step_seed)
        dr, po, jitter = ref.cast(inputs["drift"], f64), ref.cast(inputs["policy"], f64), cfg["jitter"][traffic["dtype"]]
        rpaths, x0r = ref.step_operands(gen, cfg, dr, dtype, f64, jitter, f64)
        routes = dict(
            k6=lambda t: pilco.fused_rollout_costs(system.policy, system.drift, paths, x0, loop.encoder,
                                                   loop.objective, spec.action_scale, t),
            k6_ulp=lambda t: pilco.fused_rollout_costs(system.policy, system.drift, paths, ref.twin(x0),
                                                       loop.encoder, loop.objective, spec.action_scale, t),
            plain=lambda t: pilco.particle_rollout_costs(chain, drift_fn, x0, loop.encoder, loop.objective, t),
            ref_ulp=lambda t: ref.rollout_costs(po, dr, rpaths, ref.twin(x0r), cfg, jitter, f64, t),
        )
        out = dict(x0_gap=float((x0.to(f64) - x0r).abs().max()), marks=marks)
        for t in marks:
            truth = ref.rollout_costs(po, dr, rpaths, x0r, cfg, jitter, f64, t)
            scale = float(truth.mean().abs())
            worst = int((routes["k6"](t).to(f64) - truth).abs().argmax())  # K6's worst particle
            row = dict(loss=-scale, worst=worst, worst_cost=float(truth[worst]),
                       median_cost=float(truth.median()))
            for name, route in routes.items():
                costs = route(t).to(f64)
                gap = (costs - truth).abs()
                row[name] = dict(loss_gap=float((costs.mean() - truth.mean()).abs()) / scale,
                                 worst=float(gap.max()), at_worst=float(gap[worst]),
                                 median=float(gap.median()), over_1e9=int((gap > 1e-9).sum()))
            out[f"T{t}"] = row
    return out
