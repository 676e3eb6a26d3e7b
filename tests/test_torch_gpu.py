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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, p, d2, m, r", [(1, 10, 14, 240, 1), (3, 3, 14, 17, 1), (1, 1, 12, 30, 1),
                                           (2, 2, 20, 45, 1), (1, 2, 14, 64, 1), (1, 2, 14, 65, 1),
                                           (2, 1, 14, 129, 1), (1, 8, 14, 240, 4)])
def test_torch_pair_contract_kernels_match_reference_on_gpu(dtype, n, p, d2, m, r):
    """K2 forward, full and frozen backward against the plain version, at the
    drift's and the policy's shapes, the GPR route's (8 members on P, R = 4
    rows of alpha^T) and ragged ones (M not a multiple of the 32-wide passes
    or of the frozen backward's 32-wide tiles: 17, 30, 45, 65, 129; M = 64
    exact tiles; a batch N > 1, D2 > 16). Each output is a sum of at most M
    terms taken in another order: rtol = atol = 1e-4 in float32, 1e-10 in
    float64. Repeated full and frozen backward runs are bit-identical (no
    atomics)."""
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
                                                 (8, 4, 6, 240), (8, 1, 5, 30)])
def test_torch_svgp_match_kernels_match_reference_on_gpu(dtype, n, num_latent, d, m):
    """K3 forward, frozen and full backward against the plain version at the
    drift's and the policy's shapes and at ragged ones (M not a multiple of
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
@pytest.mark.parametrize("n, d, active", [(1, 4, (1,)), (30, 4, (1,)), (3, 6, (4, 0)), (3, 10, (9, 2, 5))])
def test_torch_enc_match_kernels_match_reference_on_gpu(dtype, n, d, active):
    """K4 forward and backward against the plain version, at the rollout's
    N = 1 and the post-rollout cost's N = 30, and at D = 6 and 10 with active
    dims out of order; bars 1e-5 in float32, 1e-12 in float64 (a few dozen
    terms per output). Raises on D > 16, a wrong dtype and a non-contiguous
    operand."""
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
    with pytest.raises(TypeError):
        ec._fwd(meta, mx, sxx.transpose(1, 2))
    with pytest.raises(TypeError):
        ec._fwd(meta, mx, sxx.to(torch.float16))
    wide = ec.make_enc_meta((1,), 17)
    with pytest.raises(ValueError, match="D <= 16"):
        ec._fwd(wide, f(np.zeros((1, 17))), f(np.eye(17)[None]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, d", [(1, 6), (1, 4), (3, 10), (200, 4)])
def test_torch_mm_glue_kernels_match_reference_on_gpu(dtype, n, d):
    """K5a and K5b (with and without the boost) against the plain version
    on indefinite matrices, at the path's shapes, a batch beyond one block
    and D = 10; bars 1e-5 in float32, 1e-12 in float64 (the same Jacobi
    sweeps in the same order). Raises on D > 16, a wrong dtype and a
    non-contiguous operand."""
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
    _close(gc._psd(s, 0.0), gc.psd_boost_reference(s, 0.0), tol, "psd")
    for jitter in (0.0, 1e-6):
        got = gc._euler(m, s, f1, sff, sxf, 1.0, jitter)
        want = gc.euler_update_reference(m, s, f1, sff, sxf, 1.0, jitter)
        _close(got[0], want[0], tol, "mean")
        _close(got[1], want[1], tol, "cov")
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert gc.launches[f"psd_boost_{sfx}"] == before[f"psd_boost_{sfx}"] + 1
    assert gc.launches[f"euler_update_{sfx}"] == before[f"euler_update_{sfx}"] + 2
    with pytest.raises(TypeError):
        gc._psd(s.transpose(1, 2), 0.0)
    with pytest.raises(TypeError):
        gc._euler(m, s, f1.to(torch.float16), sff, sxf, 1.0, 0.0)
    with pytest.raises(ValueError, match="D <= 16"):
        gc._psd(torch.zeros((1, 17, 17), dtype=dtype, device=dev), 0.0)


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


def _rollout_operands(k, s, d, active, u, lp, ld, b, m, mp, steps, dtype, dev, seed):
    """A K6 meta and operands (x0 first) from numpy at the given widths: the
    paths' weights small enough that the rollout stays in a healthy state,
    a non-symmetric precision matrix."""
    from gpflowpilco_torch.ops import rollout_cuda as rc

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()  # noqa: E731
    n = lambda *sh: rng.normal(size=sh)  # noqa: E731
    de = 2 * len(active) + d - len(active)
    dxu = de + u
    meta = rc.RolloutMeta(num_steps=steps, dt=1.0, squash_scale=19.99999, active_dims=active,
                          state_dim=d, enc_dim=de, act_dim=u, num_latent=ld, pol_latent=lp)
    ls_p = rng.uniform(0.7, 1.5, size=(lp, de))
    zp = n(lp, mp, de)
    ls_d = rng.uniform(1.0, 2.0, size=(k, ld, dxu))
    zd = n(k, ld, m, dxu)
    a = n(de, de)
    ops = (0.3 * n(s, d), zp, (zp * zp).sum(-1), 0.3 * n(lp, mp), 1.0 / ls_p, n(u, lp), 0.1 * n(u),
           n(k, ld, b, dxu) / ls_d[:, :, None, :], rng.uniform(0, 2 * np.pi, size=(k, ld, b)),
           1.0 / ls_d, zd, (zd * zd).sum(-1), 0.1 * n(s, ld, b) * np.sqrt(2.0 / b),
           0.01 * n(s, ld, m), 0.5 * n(d, ld), 0.01 * n(k, d), n(de),
           0.1 * a @ a.T + np.eye(de) + 0.02 * n(de, de))
    return meta, tuple(f(o) for o in ops)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k, s, d, active, u, lp, ld, b, m, mp", [
    (1, 1024, 4, (1,), 1, 1, 4, 1024, 240, 30),   # the cartpole slice's widths
    (1, 1000, 4, (1,), 1, 1, 4, 256, 240, 30),    # S not a multiple of the 4-particle tile
    (3, 39, 4, (1,), 2, 2, 3, 70, 19, 12),        # the LCK shape, 3 members of 13 particles
    (1, 37, 6, (4, 0), 2, 3, 6, 300, 270, 260),   # Dxu = 10 (16-wide), M and Mp beyond a block
])
def test_torch_rollout_kernels_match_reference_on_gpu(dtype, k, s, d, active, u, lp, ld, b, m, mp):
    """K6 forward (loss and trajectory) and backward (dzp, dalpha, dilp)
    against the plain version over 5 steps: float64 to 1e-10, float32 to
    1e-4 of each output's scale (sums of ~1000 terms in another order, 5
    steps of a healthy rollout). Repeated backward runs are bit-identical
    (no atomics)."""
    from gpflowpilco_torch.ops import rollout_cuda as rc

    dev = _gpu_or_skip()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    meta, ops = _rollout_operands(k, s, d, active, u, lp, ld, b, m, mp, 5, dtype, dev, seed=s + d)
    gl = torch.as_tensor(np.random.default_rng(s).uniform(size=s) / s, dtype=dtype, device=dev)
    before = dict(rc.launches)
    loss, traj = rc._fwd(meta, *ops)
    want_loss, want_traj = rc._rollout(meta, *ops)
    _close(loss, want_loss, tol, "loss")
    _close(traj, want_traj, tol, "trajectory")
    got = rc._bwd(meta, traj, gl, *ops[1:])
    want = rc.rollout_reference_bwd(meta, want_traj, gl, *ops[1:])
    for name, a, w in zip(("dzp", "dalpha", "dilp"), got, want):
        _close(a, w, tol, name)
    again = rc._bwd(meta, traj, gl, *ops[1:])
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    torch.cuda.synchronize()
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert rc.launches[f"rollout_fwd_{sfx}"] == before[f"rollout_fwd_{sfx}"] + 1
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
