"""The PyTorch port's PSD guard and Euler moment update (ops/mm_glue_cuda.py,
the counterparts of the Pallas kernels in ops/mm_glue_pallas.py) held
against the JAX package in float64: the kernels in TPU interpret mode and
the eigvalsh-based psd_project and solver step they replace, values and
gradients. On the CPU the ops run their plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpflowpilco_tpu.moments import GaussianMoments as JaxMoments
from gpflowpilco_tpu.moments import psd_project as jax_psd_project
from gpflowpilco_tpu.ops import mm_glue_pallas as jglue
from gpflowpilco_torch.moments import GaussianMoments, psd_project
from gpflowpilco_torch.ops import mm_glue_cuda as gc

from ._torch_export import t

torch.set_num_threads(1)


def _mats(seed, d, n=4):
    """n symmetric positive-definite and n indefinite (some negative
    eigenvalues) d x d matrices."""
    a = np.random.default_rng(seed).normal(size=(n, d, d))
    spd = 0.2 * a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d)
    return spd, spd - 0.5 * np.eye(d)


@pytest.mark.parametrize("d", [4, 6, 10])
def test_torch_jacobi_min_eig_matches_eigvalsh(d):
    """Five cyclic Jacobi sweeps give lambda_min to rtol 1e-9 at D <= 10, the
    accuracy the boost's value rests on."""
    _, indef = _mats(d, d)
    got = gc.jacobi_min_eig(t(indef))
    want = np.linalg.eigvalsh(indef).min(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)


def test_torch_fused_psd_boost_matches_jax():
    """fused_psd_boost against the Pallas kernel (interpret mode) to rtol
    1e-12 and against psd_project of both packages to rtol 1e-8, on healthy
    and indefinite matrices; its gradient (the symmetrization passthrough)
    against the JAX kernel's and psd_project's."""
    d = 6
    for mats in _mats(11, d):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jglue.fused_psd_boost(jnp.asarray(mats)))
        got = gc.fused_psd_boost(t(mats)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
        ref = psd_project(GaussianMoments(t(np.zeros((4, d))), t(mats))).cov.numpy()
        jref = np.asarray(jax_psd_project(JaxMoments(mean=jnp.zeros((4, d)), cov=jnp.asarray(mats))).cov)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(got, jref, rtol=1e-8, atol=1e-12)

    _, indef = _mats(12, d)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda s: jnp.sum(jnp.cos(jglue.fused_psd_boost(s))))(jnp.asarray(indef))
    s = t(indef).requires_grad_(True)
    torch.sum(torch.cos(gc.fused_psd_boost(s))).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-8, atol=1e-12)
    s2 = t(indef).requires_grad_(True)
    torch.sum(torch.cos(psd_project(GaussianMoments(t(np.zeros((4, d))), s2)).cov)).backward()
    np.testing.assert_allclose(s.grad.numpy(), s2.grad.numpy(), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("jitter", [0.0, 1e-6])
def test_torch_fused_euler_update_matches_jax(jitter):
    """fused_euler_update against the Pallas kernel (interpret mode) and the
    solver step it replaces (update, symmetrize and, when jitter != 0, the
    stop-gradient eigvalsh boost): values and gradients in all five inputs,
    rtol 1e-8. ``jitter == 0`` symmetrizes only."""
    d = 4
    rng = np.random.default_rng(int(jitter * 1e6) + 13)
    spd, indef = _mats(14, d)
    args = (rng.normal(size=(4, d)), indef, rng.normal(size=(4, d)), 0.3 * spd,
            0.1 * rng.normal(size=(4, d, d)))
    dt = 0.7

    def ref_step(m, s, f, sf, sx):
        nm = m + dt * f
        nc = s + dt * (sx + sx.mT) + dt**2 * sf
        nc = 0.5 * (nc + nc.mT)
        if jitter:
            lam = torch.linalg.eigvalsh(nc.detach()).amin(-1)
            nc = nc + (torch.clamp(-lam, min=0.0) + jitter)[:, None, None] * torch.eye(d, dtype=nc.dtype)
        return nm, nc

    def loss(lib, nm, nc):
        return lib.sum(lib.sin(nm)) + lib.sum(lib.cos(nc))

    with pltpu.force_tpu_interpret_mode():
        (jnm, jnc), jvjp = jax.vjp(
            lambda *a: jglue.fused_euler_update(*a, dt, jitter), *(jnp.asarray(a) for a in args)
        )
        jgrads = jvjp((jnp.cos(jnm), -jnp.sin(jnc)))
    results = []
    for step in (lambda *a: gc.fused_euler_update(*a, dt, jitter), ref_step):
        ins = [t(a).requires_grad_(True) for a in args]
        nm, nc = step(*ins)
        loss(torch, nm, nc).backward()
        results.append(([nm.detach(), nc.detach()], [x.grad for x in ins]))
    (got_vals, got_grads), (ref_vals, ref_grads) = results
    for g, w, r in zip(got_vals, (jnm, jnc), ref_vals):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-8, atol=1e-12)
    for g, w, r in zip(got_grads, jgrads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-8, atol=1e-12)
    if not jitter:
        assert torch.equal(got_vals[1], got_vals[1].mT)


def test_torch_mm_glue_checks_operands():
    """A D beyond the kernels' registers, mixed dtypes and mismatched shapes
    raise, on the CPU too."""
    wide = torch.zeros((1, 17, 17), dtype=torch.float64)
    with pytest.raises(ValueError, match="D <= 16"):
        gc.fused_psd_boost(wide)
    s = t(_mats(21, 4)[0])
    m = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        gc.fused_euler_update(m, s, m.float(), s, s, 1.0, 1e-6)
    with pytest.raises(ValueError):
        gc._euler(m, s, m[:, :3], s, s, 1.0, 1e-6)


def _round_robin_min_eig(sym):
    """lambda_min as csrc/mm_glue.cu's kernels take it for D <= 8, in torch:
    five sweeps of gc.jacobi_rounds(D); in each round every pair's angle
    from the matrix as the round found it (the pairs are disjoint), then
    the rotations one after the other in the round's order."""
    d = sym.shape[-1]
    a = [[sym[:, i, j] for j in range(d)] for i in range(d)]
    for _ in range(5):
        for rnd in gc.jacobi_rounds(d):
            angles = []
            for p, q in rnd:
                apq, app, aqq = a[p][q], a[p][p], a[q][q]
                h = aqq - app
                t = 2.0 * apq * torch.where(h < 0, -1.0, 1.0) / (h.abs() + torch.sqrt(h * h + 4.0 * apq * apq) + 1e-37)
                c = torch.rsqrt(1.0 + t * t)
                angles.append((c, t * c))
            for (p, q), (c, s) in zip(rnd, angles):
                apq, app, aqq = a[p][q], a[p][p], a[q][q]
                a[p][p] = c * c * app - 2.0 * s * c * apq + s * s * aqq
                a[q][q] = s * s * app + 2.0 * s * c * apq + c * c * aqq
                a[p][q] = a[q][p] = torch.zeros_like(apq)
                for r in range(d):
                    if r not in (p, q):
                        arp, arq = a[r][p], a[r][q]
                        a[r][p] = a[p][r] = c * arp - s * arq
                        a[r][q] = a[q][r] = s * arp + c * arq
    return torch.stack([a[i][i] for i in range(d)], -1).amin(-1)


@pytest.mark.parametrize("d", [2, 3, 4, 5, 6, 8])
def test_torch_jacobi_round_robin_matches_cyclic(d):
    """The kernels' round-robin sweep order (gc.jacobi_rounds): each round's
    pairs are disjoint and a sweep takes every pair p < q once; five sweeps
    in that order give lambda_min to 1e-12 of the matrix's scale against
    eigvalsh, and against the cyclic order of the JAX kernel
    (gc.jacobi_min_eig) wherever five cyclic sweeps have converged (within
    half that bar of eigvalsh), in float64, on indefinite matrices and on
    matrices with a repeated eigenvalue (the smallest, and one in the
    middle). At D = 8 five cyclic sweeps leave one of these indefinite
    matrices 1.3e-12 of its scale from eigvalsh, where the round-robin
    order is within 2e-16."""
    rounds = gc.jacobi_rounds(d)
    assert len(rounds) == d - 1 + d % 2
    for rnd in rounds:
        assert len({i for pair in rnd for i in pair}) == 2 * len(rnd)
    assert sorted(pair for rnd in rounds for pair in rnd) == [(p, q) for p in range(d) for q in range(p + 1, d)]

    rng = np.random.default_rng(40 + d)
    basis = np.linalg.qr(rng.normal(size=(8, d, d)))[0]
    eigs = rng.normal(size=(8, d))
    eigs[:4, 1] = eigs[:4, 0]  # a repeated eigenvalue; the smallest one where it is the minimum
    eigs[4:, -1] = eigs[4:, d // 2]
    repeated = basis @ (eigs[..., None] * np.swapaxes(basis, -1, -2))
    for mats in (_mats(30 + d, d, n=8)[1], 0.5 * (repeated + np.swapaxes(repeated, -1, -2))):
        sym = t(mats)
        got = _round_robin_min_eig(sym)
        scale = 1.0 + sym.abs().amax(dim=(-2, -1))
        truth, cyclic = torch.linalg.eigvalsh(sym)[:, 0], gc.jacobi_min_eig(sym)
        converged = (cyclic - truth).abs() / scale <= 0.5e-12
        assert float(((got - truth).abs() / scale).max()) <= 1e-12
        assert float(((got - cyclic).abs() / scale)[converged].max()) <= 1e-12


def _euler_warp(m, s, f1, sff, sxf, dt, jitter):
    """csrc/mm_glue.cu's K5b for D <= 8 (a warp per batch entry) restated
    in torch: lane e's entry (i, j) = divmod(e, D) of sym from its loads at
    (i, j) and (j, i); the matrix every lane gathers (the upper triangle,
    mirrored); its round-robin lambda_min; the boost on the diagonal
    entries. Returns (new mean, new cov, sym)."""
    n, d = m.shape
    sym = torch.empty_like(s)
    for e in range(d * d):
        i, j = divmod(e, d)
        full_ij = s[:, i, j] + (dt * (sxf[:, i, j] + sxf[:, j, i]) + (dt * dt) * sff[:, i, j])
        full_ji = s[:, j, i] + (dt * (sxf[:, j, i] + sxf[:, i, j]) + (dt * dt) * sff[:, j, i])
        sym[:, i, j] = 0.5 * (full_ij + full_ji)
    gathered = torch.triu(sym) + torch.triu(sym, 1).mT
    out = sym.clone()
    if jitter:
        boost = torch.clamp(-_round_robin_min_eig(gathered), min=0.0) + jitter
        out = out + boost[:, None, None] * torch.eye(d, dtype=s.dtype)
    return m + dt * f1, out, sym


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8])
def test_torch_euler_warp_entries_match_reference(d):
    """K5b's warp restated (gathered matrix, round-robin lambda_min, one
    entry a lane): sym exactly symmetric and bit for bit the plain
    version's; with and without the boost, within 1e-12 of the scale of
    euler_update_reference (gc.boosted_reference's lambda_min), in float64,
    on indefinite covariances."""
    rng = np.random.default_rng(70 + d)
    spd, indef = _mats(71 + d, d, n=6)
    args = (t(rng.normal(size=(6, d))), t(indef), t(rng.normal(size=(6, d))), t(0.3 * spd),
            t(0.1 * rng.normal(size=(6, d, d))))
    for jitter in (0.0, 1e-6):
        nm, nc, sym = _euler_warp(*args, 0.7, jitter)
        want = gc.euler_update_reference(*args, 0.7, 0.0)
        assert torch.equal(sym, sym.mT) and torch.equal(sym, want[1])
        assert torch.equal(nm, want[0])
        ref = gc.boosted_reference(want[1], jitter, 1e-12) if jitter else want[1]
        assert float((nc - ref).abs().max()) <= 1e-12 * (1.0 + float(ref.abs().max()))


def test_torch_boosted_reference_takes_eigvalsh_where_cyclic_lags():
    """gc.boosted_reference, the card checks' reference for the kernels:
    psd_boost_reference's result exactly where five cyclic sweeps have
    converged (within half the bar of eigvalsh), eigvalsh's lambda_min
    where they have not (one of these 8 x 8 indefinite matrices, 1.3e-12
    of its scale from eigvalsh), and the cyclic sweeps always beyond D = 8,
    which the kernels sweep in the cyclic order too."""
    s = t(_mats(38, 8, n=8)[1])
    sym = 0.5 * (s + s.mT)
    cyclic, truth = gc.jacobi_min_eig(sym), torch.linalg.eigvalsh(sym)[:, 0]
    lagging = (cyclic - truth).abs() / (1.0 + sym.abs().amax(dim=(-2, -1))) > 0.5e-12
    assert int(lagging.sum()) == 1
    got = gc.boosted_reference(sym, 1e-6, 1e-12)
    plain = gc.psd_boost_reference(sym, 1e-6)
    assert torch.equal(got[~lagging], plain[~lagging])
    eye = torch.eye(8, dtype=sym.dtype)
    assert torch.equal(got[lagging], (sym + (torch.clamp(-truth, min=0.0) + 1e-6)[:, None, None] * eye)[lagging])
    wide = t(_mats(39, 10, n=4)[1])
    wide = 0.5 * (wide + wide.mT)
    assert torch.equal(gc.boosted_reference(wide, 0.0, 1e-12), gc.psd_boost_reference(wide, 0.0))
