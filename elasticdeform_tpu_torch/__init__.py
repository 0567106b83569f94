"""elasticdeform_tpu_torch — elastic grid deformation of N-D images in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch port of :mod:`elasticdeform_tpu`, which stays the reference.
It imports neither JAX nor that package. It ports the forward deformation,
its exact adjoint, the general resampler family, the linear filter tier,
the morphology tier, the distance transforms and the labeling and region
measurements:

numpy API (numpy in, numpy out):
    deform_grid, deform_random_grid, deform_grid_gradient,
    api.deform_batch, api.deform_batch_gradient, api.map_coordinates,
    api.geometric_transform, api.map_coordinates_gradient
tensor API (torch tensors in and out):
    deform, deform_batch (differentiable with respect to X and the
    displacement grid), deform_gradient, deform_batch_gradient;
    map_coordinates (+ _batch, _gradient), deform_field (+ _batch),
    affine_transform, shift, zoom, rotate, geometric_transform,
    spline_filter, spline_filter1d (differentiable with respect to X and
    the coordinates, field, matrix, offset or shift);
    gaussian_filter1d, gaussian_filter, gaussian_laplace,
    gaussian_gradient_magnitude, correlate1d, convolve1d, uniform_filter1d,
    uniform_filter, sobel, prewitt, laplace, correlate, convolve,
    generic_laplace, generic_gradient_magnitude (differentiable with
    respect to X);
    minimum_filter1d, maximum_filter1d, minimum_filter, maximum_filter,
    rank_filter, median_filter, percentile_filter, grey_erosion,
    grey_dilation, grey_opening, grey_closing, morphological_gradient,
    morphological_laplace, white_tophat, black_tophat, binary_erosion,
    binary_dilation, binary_opening, binary_closing, binary_propagation,
    binary_fill_holes, binary_hit_or_miss, generic_filter, generic_filter1d,
    vectorized_filter, watershed_ift (no gradient); distance_transform_edt,
    distance_transform_cdt, distance_transform_bf; label, find_objects,
    sum_labels, sum, mean, variance, standard_deviation, minimum, maximum,
    minimum_position, maximum_position, extrema, center_of_mass, histogram;
    generate_binary_structure, iterate_structure, median,
    labeled_comprehension, value_indices (numpy)

Every entry point takes ``device=None``, which means ``"cuda"``; the CPU
runs only on ``device="cpu"``. On the card the input prefilter runs as
kernel K2 and its transpose as K4 (``csrc/prefilter.cu``), the resampling
as K1 (``csrc/resample.cu``), its transpose, a scatter, as K3 and the
gradient with respect to the displacement as K5 (``csrc/resample_bwd.cu``);
the general resampler runs K1c, K3c and K5c, the same kernels at
caller-given coordinates, and the reflect/wrap prefilter K6 and its
transpose K7 (``csrc/prefilter.cu``); the filter tier runs the 1-D
correlation K8 and its transpose K8T, the N-D correlation K9 and its
transpose K9T (``csrc/filters.cu``); the morphology tier runs the 1-D
min/max K10, the footprint min/max K11, the rank selection K12 and the
binary sweep K13 (``csrc/morphology.cu``); the distance transforms the
nearest-background scan K14, the min-plus pass K15 and the chamfer sweep
K16, the watershed its sweep K17 (``csrc/distance.cu``); the labeling the
union-find K18 and its numbering, the region measurements the segment
reductions K19 and the extremum positions K20 (``csrc/measure.cu``); all
are built with ``nvcc`` at first use. On the CPU their plain PyTorch
versions run.
"""

from elasticdeform_tpu_torch.api import (
    deform_grid, deform_grid_gradient, deform_random_grid,
)
from elasticdeform_tpu_torch.core import (
    affine_transform, binary_closing, binary_dilation, binary_erosion,
    binary_fill_holes, binary_hit_or_miss, binary_opening, binary_propagation,
    black_tophat, convolve, convolve1d, correlate, correlate1d, deform,
    deform_batch, deform_batch_gradient, deform_field, deform_field_batch,
    deform_gradient, distance_transform_bf, distance_transform_cdt,
    distance_transform_edt, gaussian_filter,
    gaussian_filter1d, gaussian_gradient_magnitude, gaussian_laplace,
    generic_filter, generic_filter1d, generic_gradient_magnitude,
    generic_laplace, geometric_transform, grey_closing, grey_dilation,
    grey_erosion, grey_opening, laplace, map_coordinates,
    map_coordinates_batch, map_coordinates_gradient, maximum_filter,
    maximum_filter1d, median_filter, minimum_filter, minimum_filter1d,
    morphological_gradient, morphological_laplace, percentile_filter,
    prewitt, rank_filter, rotate, shift, sobel, spline_filter,
    spline_filter1d, uniform_filter, uniform_filter1d, vectorized_filter,
    watershed_ift, white_tophat, zoom,
)
from elasticdeform_tpu_torch.measure import (
    center_of_mass, extrema, find_objects, histogram, label,
    labeled_comprehension, maximum, maximum_position, mean, median, minimum,
    minimum_position, standard_deviation, sum, sum_labels, value_indices,
    variance,
)
from elasticdeform_tpu_torch.ops.morphology import (
    generate_binary_structure, iterate_structure,
)

__version__ = "0.1.0"

__all__ = ["deform_grid", "deform_random_grid", "deform_grid_gradient",
           "deform", "deform_gradient", "deform_batch",
           "deform_batch_gradient", "map_coordinates",
           "map_coordinates_batch", "map_coordinates_gradient",
           "deform_field", "deform_field_batch", "affine_transform", "shift",
           "zoom", "rotate", "geometric_transform", "spline_filter",
           "spline_filter1d", "gaussian_filter1d", "gaussian_filter",
           "gaussian_laplace", "gaussian_gradient_magnitude", "correlate1d",
           "convolve1d", "uniform_filter1d", "uniform_filter", "sobel",
           "prewitt", "laplace", "correlate", "convolve", "generic_laplace",
           "generic_gradient_magnitude", "minimum_filter1d",
           "maximum_filter1d", "minimum_filter", "maximum_filter",
           "rank_filter", "median_filter", "percentile_filter",
           "grey_erosion", "grey_dilation", "grey_opening", "grey_closing",
           "morphological_gradient", "morphological_laplace", "white_tophat",
           "black_tophat", "binary_erosion", "binary_dilation",
           "binary_opening", "binary_closing", "binary_propagation",
           "binary_fill_holes", "binary_hit_or_miss", "generic_filter",
           "generic_filter1d", "vectorized_filter", "watershed_ift",
           "distance_transform_bf", "distance_transform_cdt",
           "distance_transform_edt", "label", "find_objects", "sum_labels",
           "sum", "mean", "variance", "standard_deviation", "minimum",
           "maximum", "median", "minimum_position", "maximum_position",
           "extrema", "center_of_mass", "histogram", "labeled_comprehension",
           "value_indices", "generate_binary_structure",
           "iterate_structure", "__version__"]
