"""Scale-out on torch.distributed (counterpart of gpflowpilco_tpu/parallel/):
particles on the mesh's ``dp`` axis, Fourier bases on ``tp``."""
