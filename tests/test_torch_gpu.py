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
@pytest.mark.parametrize("n, p, d2, m", [(1, 10, 14, 240), (3, 3, 14, 17), (1, 1, 12, 30), (2, 2, 20, 45)])
def test_torch_pair_contract_kernels_match_reference_on_gpu(dtype, n, p, d2, m):
    """K2 forward, full and frozen backward against the plain version, at the
    drift's and the policy's shapes and at ragged ones (M not a multiple of
    the kernel's 32-wide tiles, a batch N > 1, D2 > 16). Each output is a sum
    of at most M terms taken in another order: rtol = atol = 1e-4 in float32,
    1e-10 in float64."""
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
    alu, qm = f(rng.normal(size=(p, 1, m))), f(rng.normal(size=(p, m, m)))
    devc, dqcol = f(rng.normal(size=(n, p, 1, m))), f(rng.normal(size=(n, p, m)))
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
    a = kc._bwd(su, sw, alu, qm, devc, dqcol, True)
    b = kc._bwd(su, sw, alu, qm, devc, dqcol, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
