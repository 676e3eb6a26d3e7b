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
