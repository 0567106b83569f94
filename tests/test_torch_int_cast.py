"""The resamplers' integer output cast converts NaN and int64's edge as XLA.

``ops/resample.py::cast_output`` rounds a resampled float to an integer
output (half away from zero, unsigned below 0 to 0), clamps and converts.
The JAX package converts with XLA's ``astype``: NaN gives 0 and a value at
or past the type's top its greatest value. PyTorch's ``.to()`` leaves both
to the device: on the CPU a NaN, and int64's clamp bound 2^63 - 1 (2^63 as
a float), became the type's least value. So ``deform_grid`` of an int32
image with ``cval=np.nan`` stored -2^31 where the JAX package stores 0, and
``map_coordinates`` of an int64 line holding 2^63 - 1 stored -2^63. The
cast now gives XLA's values on every device, elementwise (no reduction and
no sync).

On the CPU, against the JAX package (x64), bit for bit:

* ``deform_grid`` of int32 with ``cval=np.nan``, and with a NaN in the
  displacement grid (mirror mode, orders 1 and 3);
* ``map_coordinates`` of int32 and int64 with a NaN ``cval`` and one NaN
  coordinate, orders 0, 1 and 3; ``affine_transform`` and ``shift`` at
  order 1;
* int64 inputs holding 2^63 - 1 and -2^63;
* int8, int16 and uint8 as controls;
* uint64 (which the JAX package refuses) against the port's own float64
  run cast by a numpy model of XLA's conversion.

Each fault case differs from the JAX package under the parent's cast (a
copy of it, patched into the callers), so the cases catch the fault.
"""

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ej

import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch import core as tc
from elasticdeform_tpu_torch.ops import deform as td
from elasticdeform_tpu_torch.ops.resample import cast_output, torch_dtype

I64_MAX, I64_MIN = np.iinfo(np.int64).max, np.iinfo(np.int64).min


def _parent_cast(t, dtype):
    """The cast before the fix: clamp to the type's bounds and ``.to()``."""
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        return torch.trunc(t) != 0
    if dtype.kind not in "iu":
        return t.to(torch_dtype(dtype))
    info = np.iinfo(dtype)
    if dtype.kind == "u":
        r = torch.where(t > 0, t + 0.5, torch.zeros((), dtype=t.dtype))
    else:
        r = torch.where(t > 0, t + 0.5, t - 0.5)
    r = torch.clamp(r, info.min, info.max)
    return torch.trunc(r).to(torch_dtype(dtype))


def _image(dtype, shape=(20, 24), seed=0):
    rs = np.random.RandomState(seed)
    info = np.iinfo(dtype)
    lo, hi = max(int(info.min), -3000), min(int(info.max), 3000)
    return rs.randint(lo, hi + 1, shape).astype(dtype)


def _edge_line(dtype, n=20):
    """A line holding the type's greatest and least values among small
    ones."""
    info = np.iinfo(dtype)
    x = (np.arange(n) % 7).astype(dtype)
    x[2:8] = info.max
    x[11:13] = info.min
    x[17] = info.max
    return x


def _coords_line(n=20, nan_at=None):
    c = np.linspace(-1.3, n - 0.4, n)[None]
    c[0, -1] = 4.0      # on the edge line's plateau of the greatest value
    if nan_at is not None:
        c[0, nan_at] = np.nan
    return c


def _grid(nan, seed=3):
    g = np.random.RandomState(seed).standard_normal((2, 3, 3)) * 3
    if nan:
        g[0, 1, 1] = np.nan
    return g


# (name, input dtype, port call, JAX call): each takes the input array
def _cases():
    out = []
    for dt in ("int32", "int8", "int16", "uint8"):
        for order in (1, 3):
            out.append((f"deform_grid cval=nan {dt} order={order}", dt,
                        dict(fn="deform_grid", grid=_grid(False),
                             order=order, mode="constant", cval=np.nan)))
            out.append((f"deform_grid nan grid {dt} order={order}", dt,
                        dict(fn="deform_grid", grid=_grid(True),
                             order=order, mode="mirror", cval=0.0)))
    for dt in ("int32", "int64", "int8", "int16", "uint8"):
        for order in (0, 1, 3):
            out.append((f"map_coordinates cval=nan {dt} order={order}", dt,
                        dict(fn="map_coordinates", coords=_coords_line(24),
                             order=order, mode="constant", cval=np.nan,
                             line=True)))
            out.append((f"map_coordinates nan coord {dt} order={order}", dt,
                        dict(fn="map_coordinates",
                             coords=_coords_line(20, nan_at=7), order=order,
                             mode="nearest", cval=0.0, line=True)))
    for dt in ("int32", "int16"):
        out.append((f"affine_transform cval=nan {dt}", dt,
                    dict(fn="affine_transform", order=1, mode="constant",
                         cval=np.nan)))
        out.append((f"shift cval=nan {dt}", dt,
                    dict(fn="shift", order=1, mode="constant",
                         cval=np.nan)))
    # no prefilter: at order 3 it sums values of 2^63 in another order than
    # the JAX package's, and the float64 results differ by an ulp (2048)
    for dt in ("int64", "int32", "int16", "uint8"):
        for order in (0, 1, 3):
            out.append((f"map_coordinates edges {dt} order={order}", dt,
                        dict(fn="map_coordinates", coords=_coords_line(20),
                             order=order, mode="nearest", cval=0.0,
                             edges=True, prefilter=False)))
    return out


CASES = _cases()
# the cases that meet fault 7: a NaN into a signed type wider than 16 bits
# (the CPU's float -> int32 conversion of NaN gives int32's least value,
# which an int8 or int16 cast wraps to 0), or int64's top edge. At order 0
# a NaN coordinate's one weight is 1 and no NaN reaches the cast: that case
# holds the twins' first tap of a NaN coordinate, 0 as on the card and in
# XLA (``ops/resample.py::tap_geometry``; PyTorch's CPU gave int64's least
# value, which the clamp sent to the mirror pad's first row)
FAULTS = {name for name, dt, kw in CASES
          if dt in ("int32", "int64") and "edges" not in name
          and not ("nan coord" in name and kw["order"] == 0)
          or dt == "int64" and "edges" in name}


def _run(kw, dt, module, device=None):
    extra = {} if device is None else {"device": device}
    fn = kw["fn"]
    if fn == "deform_grid":
        x = _image(np.dtype(dt))
        return module.deform_grid(x, kw["grid"], order=kw["order"],
                                  mode=kw["mode"], cval=kw["cval"], **extra)
    if fn == "map_coordinates":
        x = _edge_line(np.dtype(dt), 24) if kw.get("edges") else \
            _image(np.dtype(dt), (24,), seed=4)
        return module.map_coordinates(x, kw["coords"], order=kw["order"],
                                      mode=kw["mode"], cval=kw["cval"],
                                      prefilter=kw.get("prefilter", True),
                                      **extra)
    x = _image(np.dtype(dt), (20, 24), seed=5)
    if fn == "affine_transform":
        mat = np.array([[0.95, 0.2], [-0.2, 1.05]])
        return module.affine_transform(x, mat, [2.5, -3.0], order=kw["order"],
                                       mode=kw["mode"], cval=kw["cval"],
                                       **extra)
    return module.shift(x, [2.5, -3.25], order=kw["order"], mode=kw["mode"],
                        cval=kw["cval"], **extra)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_cast_is_the_jax_packages(case):
    name, dt, kw = CASES[case]
    got = _np(_run(kw, dt, et, "cpu"))
    want = _np(_run(kw, dt, ej))
    assert got.dtype == want.dtype == np.dtype(dt)
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES.index(c) for c in CASES
                                        if c[0] in FAULTS),
                         ids=lambda i: CASES[i][0])
def test_parent_cast_misses(case, monkeypatch):
    """Under the parent's cast each fault case differs from the JAX
    package (this CPU's own conversion of NaN and 2^63 is not XLA's)."""
    if torch.tensor([float("nan"), 2.0 ** 63],
                    dtype=torch.float64).to(torch.int64).tolist() == \
            [0, I64_MAX]:
        pytest.skip("this CPU's float -> int conversion is XLA's already")
    monkeypatch.setattr(td, "cast_output", _parent_cast)
    monkeypatch.setattr(tc, "cast_output", _parent_cast)
    name, dt, kw = CASES[case]
    got = _np(_run(kw, dt, et, "cpu"))
    want = _np(_run(kw, dt, ej))
    assert not np.array_equal(got, want), name


def _xla_cast(t, dtype):
    """numpy model of the JAX package's cast: round as the reference,
    then XLA's conversion (NaN to 0, saturating)."""
    info = np.iinfo(dtype)
    t = np.asarray(t, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        r = np.where(t > 0, t + 0.5, 0.0 if info.min == 0 else t - 0.5)
        r = np.trunc(np.nan_to_num(r, nan=0.0))
        out = np.empty(t.shape, dtype=dtype)
        hi = r >= float(info.max)
        lo = r <= float(info.min)
        mid = ~(hi | lo)
        out[hi], out[lo] = info.max, info.min
        out[mid] = r[mid].astype(dtype)
    return out


@pytest.mark.parametrize("order", [0, 1, 3])
def test_uint64_is_the_float_run_cast_as_xla(order):
    """uint64 inputs, which the JAX package refuses: the port's output
    equals its own float64 result cast by :func:`_xla_cast`, with a NaN
    ``cval`` and values at 2^64 - 1 (no prefilter: an integer output's
    prefilter sums in a fixed order, a float one's not)."""
    x = _edge_line(np.dtype(np.uint64), 24)
    coords = _coords_line(24)
    kw = dict(order=order, mode="constant", cval=np.nan, prefilter=False,
              device="cpu")
    got = et.map_coordinates(x, coords, **kw).numpy()
    res = et.map_coordinates(x.astype(np.float64), coords, **kw).numpy()
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, _xla_cast(res, np.uint64))


@pytest.mark.parametrize("fdt", [torch.float32, torch.float64])
@pytest.mark.parametrize("odt", ["int8", "uint8", "int16", "uint16", "int32",
                                 "uint32", "int64", "uint64"])
def test_cast_of_edges_is_xlas(odt, fdt):
    """The cast alone on NaN, infinities and each type's edges, from
    float32 and float64: :func:`_xla_cast` of the same values."""
    info = np.iinfo(odt)
    v = np.array([np.nan, np.inf, -np.inf, float(info.max), float(info.min),
                  float(info.max) * 0.999, float(info.min) - 1.0, 0.5,
                  -0.5, 2.5, -2.5, 0.0, 1e30, -1e30], dtype=np.float64)
    t = torch.as_tensor(v, dtype=fdt)
    got = cast_output(t, odt).numpy()
    assert got.dtype == np.dtype(odt)
    np.testing.assert_array_equal(got, _xla_cast(t.double().numpy(), odt))
