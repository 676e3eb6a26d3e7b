"""PyTorch/CUDA port of gpflowpilco_tpu for NVIDIA Hopper (H100).

Each module answers to the JAX module of the same path under
``gpflowpilco_tpu/``, which stays the reference. This package imports torch
and never JAX or the JAX package.

Ported so far, on cartpole swing-up with an SVGP drift: pathwise PILCO
(kernel ``ops/path_eval_cuda.py``) and moment-matching PILCO, with the
eKuffu pair grid (``ops/kexp_cuda.py``) or the whole-match path: the SVGP
match (``ops/mm_match_cuda.py``), the encoder match
(``ops/enc_match_cuda.py``), the PSD guard and the Euler update
(``ops/mm_glue_cuda.py``); and, for exact GPR drifts and their HMC
ensembles (slice B), the GPR whole match (``ops/gpr_match_cuda.py``) and
the pair grid's GPR route. Their CUDA C++ is in ``csrc/``, built at first
use into ``build/kernels/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
