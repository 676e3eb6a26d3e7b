"""On-card tests of the PyTorch port's CUDA kernels (marker ``gpu``).

They skip where there is no NVIDIA GPU. This file imports neither JAX nor
the JAX package, so on a machine without JAX it runs without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q
"""
import numpy as np
import pytest
import torch

from gpflowpilco_torch.ops import path_eval_cuda as pe


@pytest.mark.gpu
@pytest.mark.parametrize("d", [6, 11])  # both register widths of the kernels (D <= 8, <= 16)
def test_torch_path_eval_kernels_match_reference_on_gpu(d):
    """K1a/K1b/K1c against the plain version at shapes ragged against the
    kernels' particle tiles and thread strides; rtol = atol = 1e-4, the bar
    chip_smoke.py sets for sums of ~100 float32 terms in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(d)
    s, num_latent, b, m = 37, 3, 70, 19
    dev = torch.device("cuda")
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)  # noqa: E731
    z = f(num_latent, m, d)
    ops = (f(s, d), 0.1 * f(s, num_latent, b), 0.1 * f(s, num_latent, m), f(num_latent, b, d),
           f(num_latent, b), z, (z * z).sum(-1), f(num_latent, d).abs() + 0.5)
    g = f(s, num_latent)
    before = dict(pe.launches)
    torch.testing.assert_close(pe._fwd(*ops), pe.path_eval_reference(*ops), rtol=1e-4, atol=1e-4)
    want = pe.path_eval_reference_bwd(*ops, g, want_wv=True)
    torch.testing.assert_close(pe._bwd_dx(*ops, g), want[0], rtol=1e-4, atol=1e-4)
    for got, wnt in zip(pe._bwd_full(*ops, g), want):
        torch.testing.assert_close(got, wnt, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    assert all(pe.launches[k] == before[k] + 1 for k in before)
    with pytest.raises(TypeError):
        pe._fwd(*(o.double() for o in ops))
    with pytest.raises(ValueError):
        pe._fwd(ops[0], *ops[1:4], ops[4][:, :1], *ops[5:])


def _path_eval_ops(rng, s, num_latent, b, m, d, dev):
    """K1's operands at the pathwise path's scales (w and v pre-scaled)."""
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)  # noqa: E731
    z = f(num_latent, m, d)
    return (f(s, d), 0.05 * f(s, num_latent, b), 0.1 * f(s, num_latent, m), f(num_latent, b, d),
            f(num_latent, b), z, (z * z).sum(-1), f(num_latent, d).abs() + 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1024, 1000, 33])
@pytest.mark.parametrize("d", [3, 6, 8, 12, 16])  # 3: mountain car's drift input
@pytest.mark.parametrize("num_latent", [1, 4])
def test_torch_path_eval_forward_matches_reference_on_gpu(s, d, num_latent):
    """K1a (a block per 32 particles and one latent, a warp per particle)
    against the plain version: at S = 1024 with the pathwise path's B =
    1024, M = 240 (16-byte weight copies), and at S = 1000 and 33 with B =
    1000, M = 239 (M not a multiple of 4: element copies, padded groups;
    a part-filled last block); every register width of the kernel (D <= 6,
    <= 8, <= 16), D = 3 mountain car's. rtol = atol = 1e-4, chip_smoke.py's bar. Two runs are
    bit-identical (no atomics)."""
    dev = _gpu_or_skip()
    b, m = (1024, 240) if s == 1024 else (1000, 239)
    ops = _path_eval_ops(np.random.default_rng(s + d + num_latent), s, num_latent, b, m, d, dev)
    got = pe._fwd(*ops)
    torch.testing.assert_close(got, pe.path_eval_reference(*ops), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, pe._fwd(*ops))


@pytest.mark.gpu
def test_torch_path_eval_forward_cos_branches_on_gpu():
    """K1a's bases take cos_fast where a group's arguments are within its
    range and cosf() where they are not: |x . omega + phase| crosses 105615
    in some groups and not in others. x, omega and phase are multiples of
    1/16 small enough that every partial sum is exact in float32, so the
    kernel and the plain version take cos of the same arguments (at 1e5 one
    rounding of the argument moves cos by ~1e-2). Then weight rows that are
    not 16-byte aligned (a view at an offset of one float) take the element
    copies. rtol = atol = 1e-4."""
    dev = _gpu_or_skip()
    rng = np.random.default_rng(5)
    s, num_latent, b, m, d = 64, 2, 256, 40, 6
    ops = _path_eval_ops(rng, s, num_latent, b, m, d, dev)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    x = f(rng.integers(-3, 4, size=(s, d)))
    omega = f(rng.integers(-2**19, 2**19, size=(num_latent, b, d)) / 16)
    phase = f(rng.integers(0, 100, size=(num_latent, b)) / 16)
    ops = (x, *ops[1:3], omega, phase, *ops[5:])
    proj = torch.einsum("sd,lbd->slb", x.double(), omega.double()) + phase.double()
    assert (proj.abs() > 105615).any() and (proj.abs() < 105615).any()
    torch.testing.assert_close(pe._fwd(*ops), pe.path_eval_reference(*ops), rtol=1e-4, atol=1e-4)
    w = torch.cat([ops[1].new_zeros(1), ops[1].flatten()])[1:].view(ops[1].shape)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    ops = (ops[0], w, *ops[2:])
    torch.testing.assert_close(pe._fwd(*ops), pe.path_eval_reference(*ops), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1024, 1000, 33])
@pytest.mark.parametrize("d", [3, 6, 8, 12, 16])  # 3: mountain car's drift input
@pytest.mark.parametrize("num_latent", [1, 4])
def test_torch_path_eval_backward_matches_reference_on_gpu(s, d, num_latent):
    """K1b (the forward's grid and staging, a warp per particle; at L = 4 the
    per-latent partials added in order by a second launch, at L = 1 written
    by the block) against the plain version, at the forward test's shapes:
    S = 1024 with B = 1024, M = 240, S = 1000 and 33 with B = 1000, M = 239,
    every register width. rtol = atol = 1e-4, chip_smoke.py's bar. Two runs
    are bit-identical (no atomics)."""
    dev = _gpu_or_skip()
    b, m = (1024, 240) if s == 1024 else (1000, 239)
    rng = np.random.default_rng(s + d + num_latent + 1)
    ops = _path_eval_ops(rng, s, num_latent, b, m, d, dev)
    g = torch.as_tensor(rng.normal(size=(s, num_latent)), dtype=torch.float32, device=dev)
    got = pe._bwd_dx(*ops, g)
    want = pe.path_eval_reference_bwd(*ops, g, want_wv=False)[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, pe._bwd_dx(*ops, g))


@pytest.mark.gpu
def test_torch_path_eval_backward_sin_branches_on_gpu():
    """K1b's bases take sin_fast where a group's arguments are within
    105615 and sinf() where they are not: the phases run to 131072, so
    some groups cross that bound and others do not. x, omega and phase are
    multiples of 1/16 small enough that every partial sum is exact in
    float32, so the kernel and the plain version take sin of the same
    arguments; omega stays within 2, so dx's terms stay of order one.
    rtol = atol = 1e-4."""
    dev = _gpu_or_skip()
    rng = np.random.default_rng(6)
    s, num_latent, b, m, d = 64, 2, 256, 40, 6
    ops = _path_eval_ops(rng, s, num_latent, b, m, d, dev)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    x = f(rng.integers(-3, 4, size=(s, d)))
    omega = f(rng.integers(-32, 33, size=(num_latent, b, d)) / 16)
    phase = f(rng.integers(0, 2**21, size=(num_latent, b)) / 16)
    ops = (x, *ops[1:3], omega, phase, *ops[5:])
    g = f(rng.normal(size=(s, num_latent)))
    proj = torch.einsum("sd,lbd->slb", x.double(), omega.double()) + phase.double()
    assert (proj.abs() > 105615).any() and (proj.abs() < 105615).any()
    torch.testing.assert_close(pe._bwd_dx(*ops, g), pe.path_eval_reference_bwd(*ops, g, want_wv=False)[0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_torch_path_eval_backward_repeats_on_gpu():
    """K1b and K1c at the pathwise path's shape: two runs bit-identical (no
    atomics). scripts/k3_bench.py --parent --only k1_ holds K1c's outputs
    against the parent commit's bit for bit, and K1b's at its bar."""
    dev = _gpu_or_skip()
    ops = _path_eval_ops(np.random.default_rng(7), 1024, 4, 1024, 240, 6, dev)
    g = torch.as_tensor(np.random.default_rng(8).normal(size=(1024, 4)), dtype=torch.float32, device=dev)
    assert torch.equal(pe._bwd_dx(*ops, g), pe._bwd_dx(*ops, g))
    assert all(torch.equal(a, b) for a, b in zip(pe._bwd_full(*ops, g), pe._bwd_full(*ops, g)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, p, d2, m, r", [(1, 10, 14, 240, 1), (3, 3, 14, 17, 1), (1, 1, 12, 30, 1),
                                           (2, 2, 20, 45, 1), (1, 2, 14, 64, 1), (1, 2, 14, 65, 1),
                                           (2, 1, 14, 129, 1), (1, 8, 14, 240, 4), (1, 10, 18, 320, 1),
                                           (1, 3, 14, 100, 1)])
def test_torch_pair_contract_kernels_match_reference_on_gpu(dtype, n, p, d2, m, r):
    """K2 forward, full and frozen backward against the plain version, at the
    cartpole drift's and policy's shapes, the double pendulum's (the drift's
    D2 = 18 takes the DM = 32 route; the policy's 3 latent pairs at M =
    100), the GPR route's (8 members on P, R = 4
    rows of alpha^T) and ragged ones (M not a multiple of the kernels'
    32-wide tiles: 17, 30, 45, 65, 100, 129; M = 64 exact tiles; a batch N > 1,
    D2 > 16). Each output is a sum of at most M
    terms taken in another order: rtol = atol = 1e-4 in float32, 1e-10 in
    float64. Repeated forward, full and frozen backward runs are
    bit-identical (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from gpflowpilco_torch.ops import kexp_cuda as kc

    tol = 1e-4 if dtype == torch.float32 else 1e-10
    rng = np.random.default_rng(m)
    dev = torch.device("cuda")
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()  # noqa: E731
    # exponents su^T sw >= 0, as in the pair grid: E = exp(-su^T sw) <= 1
    su = f(np.abs(rng.normal(size=(n, p, d2, m))) / d2)
    sw = f(np.abs(rng.normal(size=(n, p, d2, m))) / d2)
    alu, qm = f(rng.normal(size=(p, r, m))), f(rng.normal(size=(p, m, m)))
    devc, dqcol = f(rng.normal(size=(n, p, r, m))), f(rng.normal(size=(n, p, m)))
    before = dict(kc.launches)
    for got, want in zip(kc._fwd(su, sw, alu, qm), kc.pair_contract_reference(su, sw, alu, qm)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    for model in (False, True):
        got = kc._bwd(su, sw, alu, qm, devc, dqcol, model)
        want = kc.pair_contract_reference_bwd(su, sw, alu, qm, devc, dqcol, model)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    for kind in ("fwd", "bwd", "bwd_frozen"):
        name = f"pair_contract_{kind}_{sfx}"
        assert kc.launches[name] == before[name] + 1, name
    with pytest.raises(TypeError):  # a CPU operand among CUDA ones
        kc._fwd(su, sw, alu.cpu(), qm)
    with pytest.raises(TypeError):  # mixed dtypes
        kc._fwd(su, sw, alu, qm.to(torch.float32 if dtype == torch.float64 else torch.float64))
    # repeated runs are bit-identical: no atomics
    assert all(torch.equal(x, y) for x, y in zip(kc._fwd(su, sw, alu, qm), kc._fwd(su, sw, alu, qm)))
    for model in (True, False):
        a = kc._bwd(su, sw, alu, qm, devc, dqcol, model)
        b = kc._bwd(su, sw, alu, qm, devc, dqcol, model)
        assert all(x is y is None or torch.equal(x, y) for x, y in zip(a, b)), model


def _gpu_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * (1 + max |want|): a bar relative to the
    output's scale, since the outputs range over orders of magnitude."""
    err = float((got - want).abs().max())
    scale = 1.0 + float(want.abs().max())
    assert torch.isfinite(got).all() and err <= tol * scale, (what, err, scale)


def _match_grid(num_latent, d, m, dtype, dev, seed, uncertainty=True):
    """The whole-match grid of a random SVGP (inducing points by k-means on
    random data, a perturbed q_sqrt so that Q is not zero), built in float64
    and cast."""
    from gpflowpilco_torch.models.builders import build_svgp
    from gpflowpilco_torch.moment_matching.gp import svgp_match_cache
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = build_svgp(f(rng.normal(size=(2 * m, d))), f(rng.normal(size=(2 * m, num_latent))),
                       num_inducing=m, generator=gen, noise_variance=0.1)
    with torch.no_grad():
        model.q_mu.copy_(f(0.5 * rng.normal(size=tuple(model.q_mu.shape))))
        model.q_sqrt.copy_(f(0.3 * np.eye(m) + np.tril(0.05 * rng.normal(size=(num_latent, m, m)))))
        grid = svgp_match_cache(model, fused_match=True, uncertainty=uncertainty).match_grid
        return mc.FusedMatchGrid(**{k: v.to(dtype).contiguous() for k, v in zip(
            mc.GRID_FIELDS, grid.tensors())}, meta=grid.meta)


def _moments(rng, n, d, dtype, dev):
    a = rng.normal(size=(n, d, d))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    return f(0.5 * rng.normal(size=(n, d))), f(0.05 * a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d))


def _close_vs_truth(got, plain, truth, what=""):
    """float32 against the float64 evaluation of the same inputs: the kernel
    may be off the truth by 3x what the plain float32 version is, plus 1e-4
    of the output's scale. At an M=240 grid the Q o E contraction cancels
    digits (entries of Q reach 1e3-1e5), so both float32 results lose them;
    a fixed bar would test the conditioning, not the kernel."""
    err_k = float((got.double() - truth).abs().max())
    err_p = float((plain.double() - truth).abs().max())
    scale = 1.0 + float(truth.abs().max())
    assert torch.isfinite(got).all() and err_k <= 3.0 * err_p + 1e-4 * scale, (what, err_k, err_p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, num_latent, d, m", [(1, 4, 6, 240), (1, 1, 5, 30), (3, 2, 4, 37),
                                                 (2, 3, 10, 45), (1, 2, 6, 65), (2, 3, 4, 1),
                                                 (8, 4, 6, 240), (8, 1, 5, 30), (1, 4, 8, 320),
                                                 (1, 2, 6, 100)])
def test_torch_svgp_match_kernels_match_reference_on_gpu(dtype, n, num_latent, d, m):
    """K3 forward, frozen and full backward against the plain version at the
    cartpole drift's and policy's shapes, the double pendulum's (the drift's
    L = 4 over 6 features and 2 torques at M = 320, the policy's L = 2 over
    the 6 features at M = 100) and at ragged ones (M not a multiple of
    the 64-point tile: 37, 45, a tile plus one (65) and below one tile (1, 30);
    a batch N = 2, 3 and 8 on the block grid, N = 8 also at the HMC ensemble
    policy's shape, where the full backward adds its entries' slots; D = 10
    above the 8-register capacity): in float64 to 1e-9 of
    each output's scale; in float32 both are held against the float64 plain
    version of the same inputs (_close_vs_truth). Repeated runs of every
    entry are bit-identical (no atomics)."""
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    dev = _gpu_or_skip()
    g = _match_grid(num_latent, d, m, dtype, dev, seed=m)
    rng = np.random.default_rng(m + 1)
    mx, sxx = _moments(rng, n, d, dtype, dev)
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device=dev)  # noqa: E731
    cots = (f(n, num_latent), f(n, num_latent, num_latent), f(n, d, num_latent))
    g64 = mc.FusedMatchGrid(**{k: v.double() for k, v in zip(mc.GRID_FIELDS, g.tensors())},
                            meta=g.meta)
    up = lambda ts: [x.double() for x in ts]  # noqa: E731

    def check(name, got, plain, truth):
        if dtype == torch.float64:
            _close(got, plain, 1e-9, name)
        else:
            _close_vs_truth(got, plain, truth, name)

    before = dict(mc.launches)
    got = mc._fwd(g.meta, g, mx, sxx)
    plain = mc.match_reference(g.meta, g, mx, sxx)
    truth = mc.match_reference(g.meta, g64, mx.double(), sxx.double())
    for name, a, b, c in zip(("f1", "sff", "cross"), got, plain, truth):
        check(name, a, b, c)
    f1 = got[0]
    for frozen in (True, False):
        res = mc._bwd(g.meta, g, mx, sxx, f1, *cots, frozen)
        plain = mc.match_reference_bwd(g.meta, g, mx, sxx, *cots, frozen)
        truth = mc.match_reference_bwd(g.meta, g64, mx.double(), sxx.double(), *up(cots), frozen)
        check("dmx", res[0], plain[0], truth[0])
        check("dsxx", res[1], plain[1], truth[1])
        if frozen:
            assert res[2] is None
        else:
            for name, a, b, c in zip(mc.GRID_FIELDS, res[2].tensors(), plain[2].tensors(),
                                     truth[2].tensors()):
                check(name, a, b, c)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    for kind in ("fwd", "bwd_frozen", "bwd"):
        name = f"svgp_match_{kind}_{sfx}"
        assert mc.launches[name] == before[name] + 1, name
    a, b = mc._fwd(g.meta, g, mx, sxx), mc._fwd(g.meta, g, mx, sxx)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = mc._bwd(g.meta, g, mx, sxx, f1, *cots, True)
    b = mc._bwd(g.meta, g, mx, sxx, f1, *cots, True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a = mc._bwd(g.meta, g, mx, sxx, f1, *cots, False)
    b = mc._bwd(g.meta, g, mx, sxx, f1, *cots, False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2].tensors(), b[2].tensors()))


@pytest.mark.gpu
def test_torch_svgp_match_wrapper_raises_on_gpu():
    """D > 16, a wrong dtype and a non-contiguous operand raise before any
    launch."""
    from gpflowpilco_torch.ops import mm_match_cuda as mc

    dev = _gpu_or_skip()
    g = _match_grid(2, 4, 20, torch.float64, dev, seed=5)
    mx, sxx = _moments(np.random.default_rng(6), 2, 4, torch.float64, dev)
    with pytest.raises(TypeError):
        mc._fwd(g.meta, g, mx.float(), sxx.float())
    with pytest.raises(TypeError):
        mc._fwd(g.meta, g, mx, sxx.transpose(1, 2))
    wide = _match_grid(1, 17, 20, torch.float64, dev, seed=7)
    mx17, sxx17 = _moments(np.random.default_rng(8), 1, 17, torch.float64, dev)
    with pytest.raises(ValueError, match="D <= 16"):
        mc._fwd(wide.meta, wide, mx17, sxx17)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, d, active", [(1, 4, (1,)), (30, 4, (1,)), (3, 6, (4, 0)), (3, 10, (9, 2, 5)),
                                          (33, 4, (1,)), (1, 8, (1,)), (30, 8, (7, 2, 5)),
                                          (33, 8, tuple(range(8))), (30, 8, (0, 6)), (1, 4, (0, 1)),
                                          (50, 4, (0, 1))])
def test_torch_enc_match_kernels_match_reference_on_gpu(dtype, n, d, active):
    """K4 forward and backward against the plain version, at the rollout's
    N = 1 and the post-rollout cost's N = 30 (the path's exact
    instantiation, D = 4 with active (1,)), the double pendulum's two
    active angles (NA = 2) at N = 1 and its post-rollout N = 50, N = 33, and the generic one at
    D = 6, 8 and 10 with active dims out of order, with and without
    inactive dims; bars 1e-5 in float32, 1e-12 in float64 (a few dozen
    terms per output); the forward's repeated runs bit-identical. Raises on
    D > 16, a wrong dtype and a non-contiguous operand."""
    from gpflowpilco_torch.ops import enc_match_cuda as ec

    dev = _gpu_or_skip()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    meta = ec.make_enc_meta(active, d)
    rng = np.random.default_rng(n + d)
    a = rng.normal(size=(n, d, d))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    mx, sxx = f(rng.normal(size=(n, d))), f(0.3 * a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d))
    de = meta.num_out
    cots = (f(rng.normal(size=(n, de))), f(rng.normal(size=(n, de, de))), f(rng.normal(size=(n, d, de))))
    before = dict(ec.launches)
    for name, x, y in zip(("ym", "yc", "cr"), ec._fwd(meta, mx, sxx), ec.enc_match_reference(meta, mx, sxx)):
        _close(x, y, tol, name)
    for name, x, y in zip(("dmx", "dsxx"), ec._bwd(meta, mx, sxx, *cots),
                          ec.enc_match_reference_bwd(meta, mx, sxx, *cots)):
        _close(x, y, tol, name)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert ec.launches[f"enc_match_fwd_{sfx}"] == before[f"enc_match_fwd_{sfx}"] + 1
    assert ec.launches[f"enc_match_bwd_{sfx}"] == before[f"enc_match_bwd_{sfx}"] + 1
    assert all(torch.equal(x, y) for x, y in zip(ec._fwd(meta, mx, sxx), ec._fwd(meta, mx, sxx)))
    with pytest.raises(TypeError):
        ec._fwd(meta, mx, sxx.transpose(1, 2))
    with pytest.raises(TypeError):
        ec._fwd(meta, mx, sxx.to(torch.float16))
    wide = ec.make_enc_meta((1,), 17)
    with pytest.raises(ValueError, match="D <= 16"):
        ec._fwd(wide, f(np.zeros((1, 17))), f(np.eye(17)[None]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_pair_contract_full_backward_multi_tile_on_gpu(dtype):
    """K2's full backward where M = 33 spans two tiles and N = 3: the tile
    launch and the finish launch, dalu and dqm summed over the batch,
    against the plain version at rtol = atol = 1e-4 (float32), 1e-10
    (float64); one call counts one launch."""
    from gpflowpilco_torch.ops import kexp_cuda as kc

    dev = _gpu_or_skip()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    ops, cot = _pair_operands(np.random.default_rng(33), 3, 2, 14, 33, 1, dtype, dev)
    name = f"pair_contract_bwd_{'f32' if dtype == torch.float32 else 'f64'}"
    before = kc.launches[name]
    got = kc._bwd(*ops, *cot, True)
    want = kc.pair_contract_reference_bwd(*ops, *cot, True)
    torch.cuda.synchronize()
    assert kc.launches[name] == before + 1
    for what, g, w in zip(("dsu", "dsw", "dalu", "dqm"), got, want):
        assert g.shape == w.shape, what
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, n, p, d2, m, r", [(torch.float32, 1, 1, 12, 30, 1),
                                                   (torch.float64, 1, 10, 14, 240, 1),
                                                   (torch.float32, 3, 2, 14, 33, 1)])
def test_torch_pair_contract_full_backward_repeats_on_gpu(dtype, n, p, d2, m, r):
    """K2's full backward at the policy's shape (one tile, one launch), the
    drift's and a multi-tile batch: two runs bit-identical (no atomics)."""
    from gpflowpilco_torch.ops import kexp_cuda as kc

    dev = _gpu_or_skip()
    ops, cot = _pair_operands(np.random.default_rng(m + n), n, p, d2, m, r, dtype, dev)
    a, b = kc._bwd(*ops, *cot, True), kc._bwd(*ops, *cot, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _pair_operands(rng, n, p, d2, m, r, dtype, dev):
    """K2's (su, sw, alu, qm) and (devc, dqcol), with su^T sw >= 0 as in the
    pair grid."""
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()  # noqa: E731
    su = f(np.abs(rng.normal(size=(n, p, d2, m))) / d2)
    sw = f(np.abs(rng.normal(size=(n, p, d2, m))) / d2)
    ops = (su, sw, f(rng.normal(size=(p, r, m))), f(rng.normal(size=(p, m, m))))
    return ops, (f(rng.normal(size=(n, p, r, m))), f(rng.normal(size=(n, p, m))))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, d, active", [(1, 4, (1,)), (30, 4, (1,)), (3, 10, (9, 2, 5))])
def test_torch_enc_match_backward_repeats_on_gpu(dtype, n, d, active):
    """K4's backward (a warp per batch entry, each dS and dm entry written
    by one lane) at the path's shape, the post-rollout cost's N = 30 and the
    generic instantiation: two runs bit-identical."""
    from gpflowpilco_torch.ops import enc_match_cuda as ec

    dev = _gpu_or_skip()
    meta = ec.make_enc_meta(active, d)
    rng = np.random.default_rng(n + d)
    a = rng.normal(size=(n, d, d))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    mx, sxx = f(rng.normal(size=(n, d))), f(0.3 * a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d))
    de = meta.num_out
    cots = (f(rng.normal(size=(n, de))), f(rng.normal(size=(n, de, de))), f(rng.normal(size=(n, d, de))))
    x, y = ec._bwd(meta, mx, sxx, *cots), ec._bwd(meta, mx, sxx, *cots)
    assert all(torch.equal(u, w) for u, w in zip(x, y))


def _hold_glue(gc, s, m, f1, sff, sxf, tol):
    """K5a and K5b (with and without the boost) against the plain version
    at tol of the scale (gc.boosted_reference's lambda_min); K5b's repeated
    runs bit-identical."""
    _close(gc._psd(s, 0.0), gc.boosted_reference(0.5 * (s + s.mT), 0.0, tol), tol, "psd")
    for jitter in (0.0, 1e-6):
        got = gc._euler(m, s, f1, sff, sxf, 1.0, jitter)
        want = gc.euler_update_reference(m, s, f1, sff, sxf, 1.0, 0.0)
        _close(got[0], want[0], tol, "mean")
        _close(got[1], gc.boosted_reference(want[1], jitter, tol) if jitter else want[1], tol, "cov")
        assert all(torch.equal(x, y) for x, y in zip(got, gc._euler(m, s, f1, sff, sxf, 1.0, jitter)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, d", [(n, d) for d in range(1, 17) for n in (1, 8, 130, 200)] + [(3, 10)])
def test_torch_mm_glue_kernels_match_reference_on_gpu(dtype, n, d):
    """K5a and K5b (with and without the boost) against the plain version
    on indefinite matrices, at the path's shapes (N = 1, D = 6 and 4), a
    batch beyond one block (K5b: a warp an entry for D <= 8), every exact-D
    instantiation on the path's side (D <= 8, round-robin sweeps) and D in
    9..16 (one thread a matrix, the cyclic loops); bars 1e-5
    in float32, 1e-12 in float64 of the scale. Where five cyclic sweeps
    have not converged (two of the 200 8 x 8 matrices in float64, 4e-11 of
    their scale from eigvalsh), the kernels are held against eigvalsh's
    lambda_min at the same bar (gc.boosted_reference). Raises on D > 16, a wrong dtype
    and a non-contiguous operand (D > 1)."""
    from gpflowpilco_torch.ops import mm_glue_cuda as gc

    dev = _gpu_or_skip()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.default_rng(n * d)
    a = rng.normal(size=(n, d, d))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    s = f(0.2 * a @ a.transpose(0, 2, 1) - 0.3 * np.eye(d))
    m, f1 = f(rng.normal(size=(n, d))), f(rng.normal(size=(n, d)))
    sff, sxf = f(0.1 * np.abs(rng.normal(size=(n, d, d)))), f(0.1 * rng.normal(size=(n, d, d)))
    before = dict(gc.launches)
    _hold_glue(gc, s, m, f1, sff, sxf, tol)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert gc.launches[f"psd_boost_{sfx}"] == before[f"psd_boost_{sfx}"] + 1
    assert gc.launches[f"euler_update_{sfx}"] == before[f"euler_update_{sfx}"] + 4
    if d > 1:  # a 1 x 1 matrix's transpose is contiguous
        with pytest.raises(TypeError):
            gc._psd(s.transpose(1, 2), 0.0)
    with pytest.raises(TypeError):
        gc._euler(m, s, f1.to(torch.float16), sff, sxf, 1.0, 0.0)
    with pytest.raises(ValueError, match="D <= 16"):
        gc._psd(torch.zeros((1, 17, 17), dtype=dtype, device=dev), 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [4, 6, 8])
def test_torch_mm_glue_repeated_eigenvalue_on_gpu(dtype, d):
    """K5a and K5b on matrices whose smallest eigenvalue (negative) is
    repeated, and on ones with a repeated eigenvalue in the middle, at the
    bars of test_torch_mm_glue_kernels_match_reference_on_gpu."""
    from gpflowpilco_torch.ops import mm_glue_cuda as gc

    dev = _gpu_or_skip()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.default_rng(50 + d)
    n = 8
    basis = np.linalg.qr(rng.normal(size=(n, d, d)))[0]
    eigs = rng.normal(size=(n, d))
    eigs[:4, 1] = eigs[:4, 0] = -np.abs(eigs[:4, 0])
    eigs[4:, -1] = eigs[4:, d // 2]
    rep = basis @ (eigs[..., None] * basis.transpose(0, 2, 1))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    s = f(0.5 * (rep + rep.transpose(0, 2, 1)))
    m, f1 = f(rng.normal(size=(n, d))), f(rng.normal(size=(n, d)))
    _hold_glue(gc, s, m, f1, f(np.zeros((n, d, d))), f(np.zeros((n, d, d))), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_mm_glue_dp_policy_joints_on_gpu(dtype):
    """K5a and K5b at the double pendulum's D = 8 policy joint (6 features
    and 2 torques) on 200 random joints: a rank-6 covariance (the torques
    are functions of the features) minus a small shift, so some are
    indefinite by a little and some by more, held against eigvalsh's
    lambda_min (gc.boosted_reference) at the bars of
    test_torch_mm_glue_kernels_match_reference_on_gpu."""
    from gpflowpilco_torch.ops import mm_glue_cuda as gc

    dev = _gpu_or_skip()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    rng = np.random.default_rng(88)
    n, d = 200, 8
    a = rng.normal(size=(n, d, 6))
    shift = rng.choice([1e-6, 1e-3, 0.1], size=(n, 1, 1))
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    s = f(0.3 * a @ a.transpose(0, 2, 1) - shift * np.eye(d))
    m, f1 = f(rng.normal(size=(n, d))), f(rng.normal(size=(n, d)))
    sff, sxf = f(0.1 * np.abs(rng.normal(size=(n, d, d)))), f(0.1 * rng.normal(size=(n, d, d)))
    _hold_glue(gc, s, m, f1, sff, sxf, tol)


def _stacked_gpr(k, n, d, r, dev, seed, noise=0.05):
    """A float64 GPR stacked over k members on random data (lengthscales
    around 1-2, noise ``noise``), on ``dev``."""
    from gpflowpilco_torch.models.gp import GPR
    from gpflowpilco_torch.models.kernels import RBF
    from gpflowpilco_torch.utils import bijectors as bij

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, :r] + x[:, -1:]) + 0.1 * rng.normal(size=(n, r))
    return GPR(RBF.create(f(rng.uniform(0.5, 1.5, size=k)), f(rng.uniform(1.0, 2.0, size=(k, d)))),
               f(x), f(y), f(0.1 * rng.normal(size=(k, r))),
               bij.positive_inv(f(noise * rng.uniform(0.5, 2.0, size=k)))).requires_grad_(False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b, k, n, d, r", [(1, 8, 240, 6, 4), (1, 3, 37, 4, 3), (2, 3, 300, 6, 4),
                                           (1, 2, 130, 10, 2), (1, 3, 64, 6, 4), (1, 2, 1, 6, 4),
                                           (1, 3, 65, 6, 4), (1, 2, 129, 6, 4)])
def test_torch_gpr_match_kernels_match_reference_on_gpu(dtype, b, k, n, d, r):
    """K3g forward and frozen backward against the plain version: at the
    ensemble's shape, at N ragged against the 64 x 64 tiles of both (37
    below one tile; 65 and 129 a tile plus one; 130, 240, 300) and the
    forward's 256-point eKfu blocks (300), at N = 64 (exact tiles) and
    N = 1, a batch B = 2, D = 10 above the 8-register capacity;
    float64 to 1e-9 of each output's scale, float32 held with its plain
    version against float64 (_close_vs_truth). Repeated forward and backward
    runs are bit-identical."""
    from gpflowpilco_torch.moment_matching.gp import gpr_match_cache
    from gpflowpilco_torch.ops import gpr_match_cuda as gm

    dev = _gpu_or_skip()
    model = _stacked_gpr(k, n, d, r, dev, seed=n)
    with torch.no_grad():
        c = gpr_match_cache(model)
        g64 = gm.build_fused_gpr_match_grid(model, c.alpha, c.kyy_inv)
    g = gm.FusedGPRMatchGrid(**{f: v.to(dtype).contiguous() for f, v in zip(gm.GPR_GRID_FIELDS, g64.tensors())},
                             meta=g64.meta)
    rng = np.random.default_rng(n + 1)
    mx, sxx = _moments(rng, b * k, d, dtype, dev)
    mx, sxx = mx.reshape(b, k, d).contiguous(), sxx.reshape(b, k, d, d).contiguous()
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device=dev)  # noqa: E731
    cots = (f(b, k, r), f(b, k, r, r), f(b, k, d, r))
    up = lambda ts: [x.double() for x in ts]  # noqa: E731

    def check(name, got, plain, truth):
        if dtype == torch.float64:
            _close(got, plain, 1e-9, name)
        else:
            _close_vs_truth(got, plain, truth, name)

    meta = g.meta
    before = dict(gm.launches)
    got = gm._fwd(meta, g, mx, sxx)
    plain = gm.gpr_match_reference(meta, g, mx, sxx)
    truth = gm.gpr_match_reference(meta, g64, mx.double(), sxx.double())
    for name, a, p, t in zip(("f1", "sff", "cross"), got, plain, truth):
        check(name, a, p, t)
    res = gm._bwd(meta, g, mx, sxx, got[0], *cots)
    plain = gm.gpr_match_reference_bwd(meta, g, mx, sxx, *cots)
    truth = gm.gpr_match_reference_bwd(meta, g64, mx.double(), sxx.double(), *up(cots))
    for name, a, p, t in zip(("dmx", "dsxx"), res, plain, truth):
        check(name, a, p, t)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    for kind in ("fwd", "bwd_frozen"):
        assert gm.launches[f"gpr_match_{kind}_{sfx}"] == before[f"gpr_match_{kind}_{sfx}"] + 1
    again = gm._bwd(meta, g, mx, sxx, got[0], *cots)
    assert all(torch.equal(x, y) for x, y in zip(res, again))
    assert all(torch.equal(x, y) for x, y in zip(got, gm._fwd(meta, g, mx, sxx)))
    with pytest.raises(TypeError):
        gm._fwd(meta, g, mx.double() if dtype == torch.float32 else mx.float(), sxx)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_gpr_pair_grid_kernel_on_gpu(dtype):
    """K2 on the GPR route: R = 4 rows of alpha^T and 8 members on the pair
    axis P, through GPRTransform(fused=True) against the unfused rule on the
    card, values and the (mx, sxx) gradient; float64 to 1e-10 of the scale,
    float32 to 1e-4 of it (well-conditioned: noise 0.05, N = 60)."""
    from gpflowpilco_torch.moment_matching.gp import GPRTransform
    from gpflowpilco_torch.moments import GaussianMoments
    from gpflowpilco_torch.ops import kexp_cuda as kc

    dev = _gpu_or_skip()
    model = _stacked_gpr(8, 60, 6, 4, dev, seed=5).to(dtype)
    rng = np.random.default_rng(6)
    mx, sxx = _moments(rng, 8, 6, dtype, dev)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    outs = {}
    before = dict(kc.launches)
    for fused in (False, True):
        m, s = mx.clone().requires_grad_(True), sxx.clone().requires_grad_(True)
        out = GPRTransform(model, fused=fused).with_cache().moment_match(GaussianMoments(m, s))
        vals = (out.y.mean, out.y.cov, out.cross)
        sum(torch.sum(v * (1.0 + 0.1 * i)) for i, v in enumerate(vals)).backward()
        outs[fused] = (*(v.detach() for v in vals), m.grad, s.grad)
    torch.cuda.synchronize()
    for name, a, w in zip(("f1", "sff", "cross", "dmx", "dsxx"), outs[True], outs[False]):
        _close(a, w, tol, name)
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert kc.launches[f"pair_contract_fwd_{sfx}"] == before[f"pair_contract_fwd_{sfx}"] + 1
    assert kc.launches[f"pair_contract_bwd_frozen_{sfx}"] == before[f"pair_contract_bwd_frozen_{sfx}"] + 1


@pytest.mark.gpu
def test_torch_entrywise_escalation_on_gpu():
    """Per-entry jitter escalation on the card: of 3 float32 GPRs on
    duplicated inputs, only the tiny-noise one needs a raised jitter; the
    others' factors agree with their unbatched ones to float32 rounding
    (the card may factor a batch by another algorithm; the raised jitter
    would move them by ~1e-2) and all are finite."""
    from gpflowpilco_torch.models.gp import GPR, gpr_cholesky
    from gpflowpilco_torch.models.kernels import RBF
    from gpflowpilco_torch.utils import bijectors as bij

    dev = _gpu_or_skip()
    rng = np.random.default_rng(6)
    base = rng.normal(size=(200, 3))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    x = f32(np.concatenate([base, base]))
    y = torch.sin(x[:, :1])
    noises = f32([1e-2, 1e-7, 3e-2])
    var, ls = f32([1.0, 50.0, 1.0]), f32([[1.0] * 3, [5.0] * 3, [1.5] * 3])
    with torch.no_grad():
        chol = gpr_cholesky(GPR(RBF.create(var, ls), x, y, f32(np.zeros((3, 1))), bij.positive_inv(noises)))
        assert torch.isfinite(chol).all()
        for k in (0, 2):
            one = GPR(RBF.create(var[k], ls[k]), x, y, f32(np.zeros(1)), bij.positive_inv(noises[k]))
            torch.testing.assert_close(chol[k], gpr_cholesky(one), rtol=1e-5, atol=1e-5)


def _rollout_operands(k, s, d, active, u, lp, ld, b, m, mp, steps, dtype, dev, seed, action_scale=10.0,
                      hanging=False):
    """A K6 meta and operands (x0 first) from numpy at the given widths: the
    paths' weights small enough that the rollout stays in a healthy state,
    a non-symmetric precision matrix. x0 is spread around 0, or with
    ``hanging`` around pi on the active dims (the tasks' start)."""
    from gpflowpilco_torch.ops import rollout_cuda as rc

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()  # noqa: E731
    n = lambda *sh: rng.normal(size=sh)  # noqa: E731
    de = 2 * len(active) + d - len(active)
    dxu = de + u
    meta = rc.RolloutMeta(num_steps=steps, dt=1.0, squash_scale=2.0 * action_scale - 1e-5, active_dims=active,
                          state_dim=d, enc_dim=de, act_dim=u, num_latent=ld, pol_latent=lp)
    ls_p = rng.uniform(0.7, 1.5, size=(lp, de))
    zp = n(lp, mp, de)
    ls_d = rng.uniform(1.0, 2.0, size=(k, ld, dxu))
    zd = n(k, ld, m, dxu)
    a = n(de, de)
    x0 = np.pi * np.isin(np.arange(d), active) + 0.1 * n(s, d) if hanging else 0.3 * n(s, d)
    ops = (x0, zp, (zp * zp).sum(-1), 0.3 * n(lp, mp), 1.0 / ls_p, n(u, lp), 0.1 * n(u),
           n(k, ld, b, dxu) / ls_d[:, :, None, :], rng.uniform(0, 2 * np.pi, size=(k, ld, b)),
           1.0 / ls_d, zd, (zd * zd).sum(-1), 0.1 * n(s, ld, b) * np.sqrt(2.0 / b),
           0.01 * n(s, ld, m), 0.5 * n(d, ld), 0.01 * n(k, d), n(de),
           0.1 * a @ a.T + np.eye(de) + 0.02 * n(de, de))
    return meta, tuple(f(o) for o in ops)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k, s, d, active, u, lp, ld, b, m, mp, steps", [
    (1, 1024, 4, (1,), 1, 1, 4, 1024, 240, 30, 5),   # the cartpole slice's widths
    (1, 1000, 4, (1,), 1, 1, 4, 256, 240, 30, 5),    # S not a multiple of the 4-particle tile
    (3, 39, 4, (1,), 2, 2, 3, 70, 19, 12, 5),        # the LCK shape, 3 members of 13 particles
    (1, 37, 6, (4, 0), 2, 3, 6, 300, 270, 260, 5),   # Dxu = 10 (16-wide), M and Mp beyond a block
    (1, 1024, 4, (1,), 1, 1, 4, 1024, 240, 30, 1),   # one step
    (1, 1024, 4, (1,), 1, 1, 4, 1024, 240, 30, 30),  # the slice's horizon
    (1, 333, 4, (1,), 1, 1, 4, 256, 240, 30, 45),    # 14985 rows: ragged against every row tile
    (8, 1024, 4, (1,), 1, 1, 4, 1024, 240, 30, 5),   # the 8-member axis at the slice's widths
    (4, 148, 4, (1,), 1, 1, 4, 1024, 240, 30, 5),    # 37 particles a member: ragged against the 8-warp block
    (1, 1024, 4, (1,), 1, 1, 4, 1000, 236, 30, 5),   # B, M not multiples of 32 columns (a lane's last round)
    (1, 1024, 4, (1,), 1, 1, 4, 1001, 237, 30, 5),   # B, M ragged against the 16-byte groups (single loads)
    (1, 512, 4, (1,), 1, 1, 8, 1024, 240, 30, 5),    # Ld = 8: the tables outgrow shared memory (the ring)
    (1, 1024, 4, (0, 1), 2, 2, 4, 1024, 320, 100, 5),   # the double pendulum's widths: DXU = 8, resident
    (1, 1024, 4, (0, 1), 2, 2, 4, 1024, 320, 100, 50),  # with a spare 3 KB in float32, and its horizon
])
def test_torch_rollout_kernels_match_reference_on_gpu(dtype, k, s, d, active, u, lp, ld, b, m, mp, steps):
    """K6 forward (loss and trajectory) and backward (dzp, dalpha, dilp)
    against the plain version: float64 to 1e-10 of each output's scale;
    float32 over 5 steps or fewer to 1e-4 of the scale (sums of ~1000 terms
    in another order, a healthy rollout), and over more steps, where float32
    rounding grows along the rollout, kernel and plain float32 against
    float64 on the same inputs (_close_vs_truth, chip_smoke.py's 30-step
    bar). Repeated forward and backward runs are bit-identical (no
    atomics), and where the drift tables fit in shared memory the forward's
    ring route gives the resident route's results bit for bit."""
    from gpflowpilco_torch.ops import rollout_cuda as rc

    dev = _gpu_or_skip()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    # the double pendulum's cases (both angles active) take its torque box
    # and its hanging start, as its loop does
    task = dict(action_scale=2.0, hanging=True) if active == (0, 1) else {}
    meta, ops = _rollout_operands(k, s, d, active, u, lp, ld, b, m, mp, steps, dtype, dev, seed=s + d, **task)
    gl = torch.as_tensor(np.random.default_rng(s).uniform(size=s) / s, dtype=dtype, device=dev)
    before = dict(rc.launches)
    loss, traj = rc._fwd(meta, *ops)
    want_loss, want_traj = rc._rollout(meta, *ops)
    got = rc._bwd(meta, traj, gl, *ops[1:])
    want = rc.rollout_reference_bwd(meta, want_traj, gl, *ops[1:])
    outs = zip(("loss", "trajectory", "dzp", "dalpha", "dilp"), (loss, traj, *got), (want_loss, want_traj, *want))
    if dtype == torch.float32 and steps > 5:
        ops64 = tuple(o.double() for o in ops)
        truth_loss, truth_traj = rc._rollout(meta, *ops64)
        truth = (truth_loss, truth_traj, *rc.rollout_reference_bwd(meta, truth_traj, gl.double(), *ops64[1:]))
        for (name, a, w), tr in zip(outs, truth):
            _close_vs_truth(a, w, tr, name)
    else:
        for name, a, w in outs:
            _close(a, w, tol, name)
    again = rc._bwd(meta, traj, gl, *ops[1:])
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    repeats = [rc._fwd(meta, *ops)]
    if rc.fwd_plan(meta, b, m, dtype)[0] == "resident":
        repeats.append(rc._fwd(meta, *ops, route="ring"))
    for rep in repeats:
        assert torch.equal(rep[0], loss) and torch.equal(rep[1], traj)
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert rc.launches[f"rollout_fwd_{sfx}"] == before[f"rollout_fwd_{sfx}"] + 1 + len(repeats)
    assert rc.launches[f"rollout_bwd_{sfx}"] == before[f"rollout_bwd_{sfx}"] + 2
    if k > 1:
        # the member axis: member j's particles against a one-member call
        per = s // k
        for j in range(k):
            rows = slice(j * per, (j + 1) * per)
            one = tuple(o[j:j + 1] if i in (7, 8, 9, 10, 11, 15) else o[rows] if i in (0, 12, 13) else o
                        for i, o in enumerate(ops))
            torch.testing.assert_close(rc._fwd(meta, *one)[0], loss[rows], rtol=0, atol=0)


@pytest.mark.gpu
def test_torch_rollout_wrapper_raises_on_gpu():
    """A wrong dtype, a non-contiguous operand, a shape beyond the register
    capacities and a gradient asked of a frozen operand raise before any
    launch."""
    from gpflowpilco_torch.ops import rollout_cuda as rc

    dev = _gpu_or_skip()
    meta, ops = _rollout_operands(1, 8, 4, (1,), 1, 1, 4, 16, 8, 6, 3, torch.float64, dev, seed=1)
    before = dict(rc.launches)
    with pytest.raises(TypeError):
        rc._fwd(meta, ops[0].float(), *ops[1:])
    with pytest.raises(TypeError):
        rc._fwd(meta, *ops[:13], ops[13].transpose(1, 2).contiguous().transpose(1, 2), *ops[14:])
    wide, wops = _rollout_operands(1, 8, 9, (1,), 1, 1, 9, 16, 8, 6, 3, torch.float64, dev, seed=2)
    with pytest.raises(ValueError, match="D <= 8"):
        rc._fwd(wide, *wops)
    with pytest.raises(NotImplementedError, match="differentiates only the policy"):
        rc.FusedRolloutLoss.apply(meta, *ops[:7], ops[7].clone().requires_grad_(True), *ops[8:])
    assert rc.launches == before


@pytest.mark.gpu
def test_torch_multistart_through_rollout_kernel_on_gpu():
    """A K=2 x 3-step multistart policy update of a small pathwise loop on
    the card with use_fused_rollout: one K6 forward and one backward per
    candidate step (6 of each), no K1, and the winner is the argmin of the
    candidates' best-seen losses."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
    from run_torch import build_loop

    from gpflowpilco_torch.loops.pilco import DriftSpec, PolicySpec
    from gpflowpilco_torch.ops import rollout_cuda as rc

    loop = build_loop(
        0, torch.device("cuda"), torch.float32,
        drift_spec=DriftSpec(num_centers=16, max_iters=20),
        policy_spec=PolicySpec(batch_size=64, num_bases=64, num_restarts=2, step_limit=3),
    )
    loop.step()
    loop.step()
    loop.update_dynamics()
    loop.use_fused_rollout = True
    rc.reset_launches()
    pe.reset_launches()
    info = loop.update_policy()
    torch.cuda.synchronize()
    assert loop._fused_rollout_eligible(loop.drift_model, loop.policy_model)
    assert rc.launches == {"rollout_fwd_f32": 6, "rollout_fwd_f64": 0, "rollout_bwd_f32": 6, "rollout_bwd_f64": 0}
    assert not any(pe.launches.values())
    assert len(info["restart_losses"]) == 2 and info["losses"].shape == (3,)
    assert info["best_restart"] == int(np.argmin(info["restart_losses"]))
    assert np.isfinite(info["loss"])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "fused_rollout"])
def test_torch_sharded_step_world1_on_gpu(route):
    """The sharded pathwise step (gpflowpilco_torch/parallel/) at world size
    1 over NCCL on a small fitted loop: route (b) through K1 or (c) through
    K6, its loss and gradient against PathwisePILCO.policy_loss_fn on the
    same draws (loss relative 1e-6, gradient cosine >= 0.99999, float32),
    the launches of one loss+grad (K1: one forward and one dx-only
    backward per rollout step; K6: one of each), and two finite Adam
    steps. The process group is torn down at the end."""
    dev = _gpu_or_skip()
    import copy
    import pathlib
    import socket
    import sys

    import torch.distributed as dist

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples" / "cartpole_swingup"))
    from run_torch import build_loop

    from gpflowpilco_torch.loops.pilco import DriftSpec, PolicySpec
    from gpflowpilco_torch.models.builders import policy_mask
    from gpflowpilco_torch.ops import rollout_cuda as rc
    from gpflowpilco_torch.parallel.mesh import make_mesh
    from gpflowpilco_torch.parallel.pathwise import allreduce_gradients, make_pathwise_train_step

    loop = build_loop(0, dev, torch.float32, drift_spec=DriftSpec(num_centers=16, max_iters=20),
                      policy_spec=PolicySpec(batch_size=64, num_bases=64, num_restarts=1, step_limit=3))
    loop.step()
    loop.step()
    loop.update_dynamics()
    drift, policy = loop.policy_loss_drift(), loop.build_policy()
    policy_mask(policy)
    loop.use_fused_paths, loop.use_fused_rollout = route == "fused", route == "fused_rollout"
    grads = lambda m: torch.cat([p.grad.reshape(-1) for p in m.parameters() if p.grad is not None])  # noqa: E731
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        pol = copy.deepcopy(policy)
        opt = torch.optim.Adam(pol.parameters(), lr=1e-3)
        step, loss_fn = make_pathwise_train_step(
            mesh, drift, loop.policy_chain, loop.encoder, loop.objective, loop.episode_spec, batch_size=64,
            num_bases=64, optimizer=opt, dtype=torch.float32, action_scale=10.0, **{route: True})
        pe.reset_launches()
        rc.reset_launches()
        loss = loss_fn(pol, torch.Generator(device=dev).manual_seed(7))
        loss.backward()
        allreduce_gradients(pol.parameters(), mesh.get_group("dp"))
        torch.cuda.synchronize()
        t = loop.episode_spec.num_steps
        if route == "fused":
            assert pe.launches == {"path_eval_fwd": t, "path_eval_bwd_dx": t, "path_eval_bwd_full": 0}
            assert not any(rc.launches.values())
        else:
            assert rc.launches == {"rollout_fwd_f32": 1, "rollout_fwd_f64": 0, "rollout_bwd_f32": 1,
                                   "rollout_bwd_f64": 0}
            assert not any(pe.launches.values())
        ref = copy.deepcopy(policy)
        want = loop.policy_loss_fn(ref, torch.Generator(device=dev).manual_seed(7), drift=drift)
        want.backward()
        assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
        g, w = grads(pol).double(), grads(ref).double()
        assert float(g @ w / (g.norm() * w.norm())) >= 0.99999
        for i in range(2):
            assert torch.isfinite(step(pol, torch.Generator(device=dev).manual_seed(8 + i)))
    finally:
        dist.destroy_process_group()
