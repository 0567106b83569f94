"""elasticdeform_tpu_torch — elastic grid deformation of N-D images in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch port of :mod:`elasticdeform_tpu`, which stays the reference.
It imports neither JAX nor that package. This slice ports the forward
deformation:

numpy API (numpy in, numpy out):
    deform_grid, deform_random_grid, api.deform_batch
tensor API (torch tensors in and out):
    deform, deform_batch

Every entry point takes ``device=None``, which means ``"cuda"``; the CPU
runs only on ``device="cpu"``. On the card the input prefilter runs as
kernel K2 (``csrc/prefilter.cu``) and the resampling as kernel K1
(``csrc/resample.cu``), both built with ``nvcc`` at first use; on the CPU
their plain PyTorch versions run. Gradients are not ported yet.
"""

from elasticdeform_tpu_torch.api import deform_grid, deform_random_grid
from elasticdeform_tpu_torch.core import deform, deform_batch

__all__ = ["deform_grid", "deform_random_grid", "deform", "deform_batch"]
