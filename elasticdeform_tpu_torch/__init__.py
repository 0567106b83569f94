"""elasticdeform_tpu_torch — elastic grid deformation of N-D images in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch port of :mod:`elasticdeform_tpu`, which stays the reference.
It imports neither JAX nor that package. It ports the forward deformation
and its exact adjoint:

numpy API (numpy in, numpy out):
    deform_grid, deform_random_grid, deform_grid_gradient,
    api.deform_batch, api.deform_batch_gradient
tensor API (torch tensors in and out):
    deform, deform_batch (differentiable with respect to X and the
    displacement grid), core.deform_gradient, core.deform_batch_gradient

Every entry point takes ``device=None``, which means ``"cuda"``; the CPU
runs only on ``device="cpu"``. On the card the input prefilter runs as
kernel K2 and its transpose as K4 (``csrc/prefilter.cu``), the resampling
as K1 (``csrc/resample.cu``), its transpose, a scatter, as K3 and the
gradient with respect to the displacement as K5 (``csrc/resample_bwd.cu``),
all built with ``nvcc`` at first use; on the CPU their plain PyTorch
versions run.
"""

from elasticdeform_tpu_torch.api import (
    deform_grid, deform_grid_gradient, deform_random_grid,
)
from elasticdeform_tpu_torch.core import deform, deform_batch

__all__ = ["deform_grid", "deform_random_grid", "deform_grid_gradient",
           "deform", "deform_batch"]
