"""Integer ``output=`` arrays of the morphology tier from float inputs that
hold infinities, NaN or values past int64.

A filter result goes to an integer output through ``core._finish_filter``:
truncated toward zero into int64, then wrapped into the output type, as the
JAX package casts (``jnp.trunc(r).astype(int64).astype(dtype)``). XLA's
float -> int64 conversion is defined everywhere: NaN gives 0, +inf and
values from 2^63 up the greatest int64, -inf and values below -2^63 the
least. A plain ``torch.Tensor.to(torch.int64)`` leaves those values to the
device: the CPU gives int64's least value for all of them, the card's
conversion saturates. So a maximum filter of a float32 volume holding +inf
stored 0 into an int16 array on the CPU and -1 on the card (and the JAX
package). ``_finish_filter`` now converts as XLA does on every device.

On the CPU:

* the cast of such values from float32 and float64 into every integer type
  and bool equals the JAX package's ``_finish_filter`` bit for bit;
* the grey morphology calls (minimum and maximum filters, erosion, dilation,
  opening, closing, the top-hats, gradient and Laplace; flat and non-flat)
  of a float32 input holding +inf, -inf, NaN and 1e30 into uint8, int16 and
  int32 ``output=`` arrays equal the JAX package's bit for bit.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej
from elasticdeform_tpu import core as jc

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import core as tc

EDGES = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30, 2.0 ** 63,
                  -2.0 ** 63, 9.3e18, 3e9, -3e9, 70000.5, -70000.5, 255.9,
                  -0.7, 0.0, -0.0, 1.5])
OUTPUTS = ("uint8", "int8", "uint16", "int16", "uint32", "int32", "uint64",
           "int64", "bool")


@pytest.mark.parametrize("odt", OUTPUTS)
@pytest.mark.parametrize("fdt", ["float32", "float64"])
def test_cast_is_the_jax_packages(fdt, odt):
    v = EDGES.astype(fdt)
    got = tc._finish_filter(torch.as_tensor(v), odt).numpy()
    want = np.asarray(jc._finish_filter(v, odt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _volume(seed):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((6, 9, 11)) * 300).astype(np.float32)
    for value, share in ((np.inf, 0.03), (-np.inf, 0.03), (np.nan, 0.02),
                         (1e30, 0.02)):
        x[rs.rand(*x.shape) < share] = value
    return x


BALL = np.array([[[0, 1, 0], [1, 1, 1], [0, 1, 0]]] * 3, bool)
S3 = -30.0 * (np.indices((3, 3, 3)) - 1).__pow__(2).sum(0)
CALLS = {
    "minimum_filter": dict(size=3),
    "maximum_filter": dict(footprint=BALL),
    "grey_erosion": dict(footprint=BALL),
    "grey_dilation": dict(structure=S3),
    "grey_opening": dict(footprint=BALL),
    "grey_closing": dict(size=3),
    "white_tophat": dict(footprint=BALL),
    "black_tophat": dict(structure=S3),
    "morphological_gradient": dict(footprint=BALL),
    "morphological_laplace": dict(size=3),
}


@pytest.mark.parametrize("odt", ["uint8", "int16", "int32"])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_float_inputs_into_integer_arrays_are_the_jax_packages(name, odt):
    x = _volume(sorted(CALLS).index(name))
    kw = dict(CALLS[name], mode="reflect")
    got = getattr(et, name)(x, output=np.empty(x.shape, odt), device="cpu",
                            **kw)
    with np.errstate(invalid="ignore", over="ignore"):
        want = getattr(ej, name)(x, output=np.empty(x.shape, odt), **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
