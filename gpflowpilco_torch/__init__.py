"""PyTorch/CUDA port of gpflowpilco_tpu for NVIDIA Hopper (H100).

Each module answers to the JAX module of the same path under
``gpflowpilco_tpu/``, which stays the reference. This package imports torch
and never JAX or the JAX package.

The slice ported so far is pathwise PILCO on cartpole swing-up with an SVGP
drift; its one hand-written kernel is ``ops/path_eval_cuda.py`` (CUDA C++ in
``csrc/path_eval.cu``, built at first use into ``build/kernels/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
