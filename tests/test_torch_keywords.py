"""The port's exports and the JAX package's keywords.

* ``__all__`` equals the JAX package's, less the names still queued for
  later slices (ROADMAP.md Queue 1), and every exported name exists;
* ``strategy=``, ``batch_impl=`` and ``table_dtype=`` are accepted wherever
  the JAX package takes them, a bad value raises the same exception with
  the same message in both packages, and ``strategy`` / ``batch_impl``
  change nothing;
* ``table_dtype='bfloat16'`` (the narrow window table of fast
  augmentation) agrees with the JAX package's own bfloat16 run on the same
  numpy inputs: ``atol=4e-3*max|x|`` everywhere, and at least 99.9% of the
  voxels within ``1e-5*max|x|`` (the two packages prefilter in different
  orders, so a coefficient on a bfloat16 rounding boundary may round either
  way). Its
  gradients: to X exact (the cast passes the cotangent through), to the
  displacement reading the narrow coefficients, both as in JAX.
"""

import inspect

import numpy as np
import pytest
import torch

import elasticdeform_tpu as ed
import elasticdeform_tpu.api as ed_api
import elasticdeform_tpu_torch as et
import elasticdeform_tpu_torch.api as et_api
from elasticdeform_tpu_torch import core as et_core

# exported by the JAX package, still queued in the port (ROADMAP.md Queue
# 1: items 6, 8, 11b)
QUEUED = {
    "bending_energy", "center_of_mass", "compose_displacement_fields",
    "deform_random", "deform_random_diffeo", "displacement_field",
    "displacement_field_jacobian", "extrema",
    "find_objects", "fourier_ellipsoid", "fourier_gaussian", "fourier_shift",
    "fourier_uniform", "histogram", "integrate_velocity_field",
    "invert_displacement_field", "jacobian_determinant",
    "jacobian_determinant_field", "label", "labeled_comprehension",
    "maximum", "maximum_position", "mean", "median", "membrane_energy",
    "minimum", "minimum_position", "random_displacement",
    "refine_displacement_grid", "standard_deviation", "sum", "sum_labels",
    "value_indices", "variance",
}

CPU = {"device": "cpu"}


def test_all_matches_jax_less_queued():
    assert QUEUED <= set(ed.__all__)
    assert set(et.__all__) == set(ed.__all__) - QUEUED
    assert len(et.__all__) == len(set(et.__all__))
    for name in et.__all__:
        assert hasattr(et, name), name
    assert et.__version__ == ed.__version__ == "0.1.0"
    assert et.deform_gradient is et_core.deform_gradient
    assert et.deform_batch_gradient is et_core.deform_batch_gradient


# (JAX function, port function, keywords the JAX one takes)
_PAIRS = [
    (ed.deform, et.deform, {"strategy", "table_dtype"}),
    (ed.deform_gradient, et.deform_gradient, {"strategy"}),
    (ed.deform_batch, et.deform_batch,
     {"strategy", "batch_impl", "table_dtype"}),
    (ed.deform_batch_gradient, et.deform_batch_gradient,
     {"strategy", "batch_impl"}),
    (ed.map_coordinates, et.map_coordinates, {"strategy", "table_dtype"}),
    (ed.map_coordinates_batch, et.map_coordinates_batch,
     {"strategy", "batch_impl", "table_dtype"}),
    (ed.map_coordinates_gradient, et.map_coordinates_gradient,
     {"strategy"}),
    (ed.deform_field, et.deform_field, {"strategy", "table_dtype"}),
    (ed.deform_field_batch, et.deform_field_batch,
     {"strategy", "batch_impl", "table_dtype"}),
    (ed.affine_transform, et.affine_transform, {"strategy", "table_dtype"}),
    (ed.shift, et.shift, {"strategy"}),
    (ed.zoom, et.zoom, {"strategy"}),
    (ed.rotate, et.rotate, {"strategy"}),
    (ed.geometric_transform, et.geometric_transform,
     {"strategy", "table_dtype"}),
    (ed_api.deform_grid, et_api.deform_grid, {"strategy"}),
    (ed_api.deform_grid_gradient, et_api.deform_grid_gradient,
     {"strategy"}),
    (ed_api.deform_batch, et_api.deform_batch,
     {"strategy", "batch_impl", "table_dtype"}),
    (ed_api.deform_batch_gradient, et_api.deform_batch_gradient,
     {"strategy", "batch_impl"}),
    (ed_api.map_coordinates, et_api.map_coordinates,
     {"strategy", "table_dtype"}),
    (ed_api.geometric_transform, et_api.geometric_transform, {"strategy"}),
    (ed_api.map_coordinates_gradient, et_api.map_coordinates_gradient,
     {"strategy"}),
]


@pytest.mark.parametrize("jax_fn, port_fn, names", _PAIRS,
                         ids=lambda v: getattr(v, "__qualname__", None)
                         and f"{v.__module__.split('.')[-1]}."
                         f"{v.__qualname__}")
def test_signature_keywords(jax_fn, port_fn, names):
    """The port takes the JAX keywords with the JAX defaults and kinds."""
    js = inspect.signature(jax_fn).parameters
    ps = inspect.signature(port_fn).parameters
    for name in ("strategy", "batch_impl", "table_dtype"):
        assert (name in js) == (name in names)
        if name in names:
            assert name in ps, name
            assert ps[name].default == js[name].default
            assert ps[name].kind == js[name].kind


def _raises_same(jax_call, port_call):
    with pytest.raises(Exception) as je:
        jax_call()
    with pytest.raises(Exception) as pe:
        port_call()
    assert type(pe.value) is type(je.value)
    assert str(pe.value) == str(je.value)
    return pe.value


_RS = np.random.RandomState(7)
_X = _RS.rand(12, 14)
_D = _RS.randn(2, 3, 3) * 2
_C = _RS.uniform(-2, 14, (2, 5, 6))


def _calls(kw):
    """(JAX call, port call) of each keyword-taking entry point with the
    extra keywords ``kw``."""
    X, D, C = _X, _D, _C
    out = [
        (lambda: ed.deform(X, D, **kw), lambda: et.deform(X, D, **kw, **CPU)),
        (lambda: ed.deform_batch(X[None], D[None], **kw),
         lambda: et.deform_batch(X[None], D[None], **kw, **CPU)),
        (lambda: ed.map_coordinates(X, C, **kw),
         lambda: et.map_coordinates(X, C, **kw, **CPU)),
        (lambda: ed.map_coordinates(X, C, mode="grid-wrap", **kw),
         lambda: et.map_coordinates(X, C, mode="grid-wrap", **kw, **CPU)),
        (lambda: ed.map_coordinates_batch(X[None], C[None], **kw),
         lambda: et.map_coordinates_batch(X[None], C[None], **kw, **CPU)),
        (lambda: ed.deform_field(X, np.zeros((2, 12, 14)), **kw),
         lambda: et.deform_field(X, np.zeros((2, 12, 14)), **kw, **CPU)),
        (lambda: ed.affine_transform(X, np.eye(2), mode="reflect", **kw),
         lambda: et.affine_transform(X, np.eye(2), mode="reflect", **kw,
                                     **CPU)),
        (lambda: ed.geometric_transform(X, lambda o: o, **kw),
         lambda: et.geometric_transform(X, lambda o: o, **kw, **CPU)),
        (lambda: ed_api.deform_batch(X[None], D[None], **kw),
         lambda: et_api.deform_batch(X[None], D[None], **kw, **CPU)),
        (lambda: ed_api.map_coordinates(X, C, **kw),
         lambda: et_api.map_coordinates(X, C, **kw, **CPU)),
    ]
    if "table_dtype" not in kw:
        out += [
            (lambda: ed.deform_gradient(X, D, **kw),
             lambda: et.deform_gradient(X, D, **kw, **CPU)),
            (lambda: ed.deform_batch_gradient(X[None], D[None], **kw),
             lambda: et.deform_batch_gradient(X[None], D[None], **kw, **CPU)),
            (lambda: ed.map_coordinates_gradient(_C[0], C, X_shape=X.shape,
                                                 **kw),
             lambda: et.map_coordinates_gradient(_C[0], C, X_shape=X.shape,
                                                 **kw, **CPU)),
            (lambda: ed.shift(X, 1.5, **kw),
             lambda: et.shift(X, 1.5, **kw, **CPU)),
            (lambda: ed.zoom(X, 1.5, **kw),
             lambda: et.zoom(X, 1.5, **kw, **CPU)),
            (lambda: ed.rotate(X, 30.0, **kw),
             lambda: et.rotate(X, 30.0, **kw, **CPU)),
            (lambda: ed_api.deform_grid(X, D, **kw),
             lambda: et_api.deform_grid(X, D, **kw, **CPU)),
            (lambda: ed_api.deform_grid_gradient(X, D, **kw),
             lambda: et_api.deform_grid_gradient(X, D, **kw, **CPU)),
            (lambda: ed_api.geometric_transform(X, lambda o: o, **kw),
             lambda: et_api.geometric_transform(X, lambda o: o, **kw, **CPU)),
            (lambda: ed_api.map_coordinates_gradient(
                _C[0], C, X_shape=X.shape, **kw),
             lambda: et_api.map_coordinates_gradient(
                _C[0], C, X_shape=X.shape, **kw, **CPU)),
        ]
    return out


@pytest.mark.parametrize("strategy", ["fast", "Gather", None])
def test_bad_strategy_same_error(strategy):
    for jax_call, port_call in _calls({"strategy": strategy}):
        e = _raises_same(jax_call, port_call)
        assert isinstance(e, AssertionError)


@pytest.mark.parametrize("table_dtype", ["int32", "float16", np.uint8,
                                         "complex64"])
def test_bad_table_dtype_same_error(table_dtype):
    for jax_call, port_call in _calls({"table_dtype": table_dtype}):
        e = _raises_same(jax_call, port_call)
        assert isinstance(e, ValueError)


def test_strategy_and_batch_impl_change_nothing():
    """Every strategy and batch layout gives the port's default result,
    bit for bit; each is also accepted by the JAX package."""
    base = [port() for _, port in _calls({})]
    for kw in ({"strategy": "windows"}, {"strategy": "gather"},
               {"strategy": "auto"}):
        got = [port() for _, port in _calls(kw)]
        for a, b in zip(base, got):
            a = torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) \
                else a
            b = torch.as_tensor(np.asarray(b)) if isinstance(b, np.ndarray) \
                else b
            assert torch.equal(a, b), kw
    X, D, C = _X, _D, _C
    for impl in ("native", "vmap", "auto"):
        assert torch.equal(
            et.deform_batch(X[None], D[None], batch_impl=impl, **CPU),
            et.deform_batch(X[None], D[None], **CPU))
        assert torch.equal(
            et.deform_batch_gradient(X[None], D[None], batch_impl=impl,
                                     **CPU),
            et.deform_batch_gradient(X[None], D[None], **CPU))
        assert torch.equal(
            et.map_coordinates_batch(X[None], C[None], batch_impl=impl,
                                     **CPU),
            et.map_coordinates_batch(X[None], C[None], **CPU))
        assert torch.equal(
            et.deform_field_batch(X[None], np.zeros((1, 2, 12, 14)),
                                  batch_impl=impl, **CPU),
            et.deform_field_batch(X[None], np.zeros((1, 2, 12, 14)), **CPU))
        np.testing.assert_array_equal(
            et_api.deform_batch(X[None], D[None], batch_impl=impl, **CPU),
            et_api.deform_batch(X[None], D[None], **CPU))
        ed.deform_batch(X[None], D[None], batch_impl=impl)


def _close_bf16(port, jax_out, scale):
    port = np.asarray(port, dtype=np.float64)
    jax_out = np.asarray(jax_out, dtype=np.float64)
    assert port.shape == jax_out.shape
    diff = np.abs(port - jax_out)
    assert float(diff.max()) <= 4e-3 * scale, float(diff.max())
    assert float(np.mean(diff <= 1e-5 * scale)) >= 0.999


_RNG = np.random.default_rng(31)
_XF = _RNG.random((40, 36)).astype(np.float32)
_DF = (_RNG.standard_normal((2, 3, 3)) * 6).astype(np.float32)
_XB = _RNG.random((3, 24, 26)).astype(np.float32)
_DB = (_RNG.standard_normal((3, 2, 3, 3)) * 4).astype(np.float32)
_CF = _RNG.uniform(-4, 42, (2, 30, 20)).astype(np.float32)


@pytest.mark.parametrize("order, mode", [(3, "mirror"), (1, "constant"),
                                         (5, "reflect"), (2, "wrap"),
                                         (4, "nearest")])
def test_table_bfloat16_deform_matches_jax(order, mode):
    kw = dict(order=order, mode=mode)
    exact = et.deform(_XF, _DF, **kw, **CPU)
    fast = et.deform(_XF, _DF, table_dtype="bfloat16", **kw, **CPU)
    assert fast.dtype == torch.float32
    assert float((fast - exact).abs().max()) > 0     # the narrow path ran
    _close_bf16(fast, ed.deform(_XF, _DF, table_dtype="bfloat16", **kw), 1.0)
    # a float64 input under a float32 table
    x64 = _XF.astype(np.float64)
    _close_bf16(et.deform(x64, _DF.astype(np.float64), table_dtype="float32",
                          **kw, **CPU),
                ed.deform(x64, _DF.astype(np.float64), table_dtype="float32",
                          **kw), 1.0)
    # the gather strategy has no table: the exact result
    assert torch.equal(et.deform(_XF, _DF, table_dtype="bfloat16",
                                 strategy="gather", **kw, **CPU), exact)


def test_table_bfloat16_batch_and_api_match_jax():
    kw = dict(order=3, mode="mirror", table_dtype="bfloat16")
    _close_bf16(et.deform_batch(_XB, _DB, **kw, **CPU),
                ed.deform_batch(_XB, _DB, **kw), 1.0)
    _close_bf16(et_api.deform_batch(_XB, _DB, **kw, **CPU),
                ed_api.deform_batch(_XB, _DB, **kw), 1.0)


@pytest.mark.parametrize("mode", ["constant", "mirror", "grid-wrap",
                                  "grid-constant"])
def test_table_bfloat16_map_coordinates_matches_jax(mode):
    kw = dict(order=3, mode=mode, table_dtype="bfloat16")
    _close_bf16(et.map_coordinates(_XF, _CF, **kw, **CPU),
                ed.map_coordinates(_XF, _CF, **kw), 1.0)
    _close_bf16(et.map_coordinates_batch(_XF[None], _CF[None], **kw, **CPU),
                ed.map_coordinates_batch(_XF[None], _CF[None], **kw), 1.0)
    if not mode.startswith("grid-"):     # the numpy API's classic modes
        _close_bf16(et_api.map_coordinates(_XF, _CF, **kw, **CPU),
                    ed_api.map_coordinates(_XF, _CF, **kw), 1.0)


def test_table_bfloat16_scipy_resamplers_match_jax():
    kw = dict(order=3, table_dtype="bfloat16")
    M = np.array([[0.9, 0.2], [-0.15, 1.05]])
    for mode in ("reflect", "constant", "nearest"):
        _close_bf16(et.affine_transform(_XF, M, 1.5, mode=mode, **kw, **CPU),
                    ed.affine_transform(_XF, M, 1.5, mode=mode, **kw), 1.0)
    field = (_RNG.standard_normal((2, 40, 36)) * 2).astype(np.float32)
    _close_bf16(et.deform_field(_XF, field, **kw, **CPU),
                ed.deform_field(_XF, field, **kw), 1.0)
    _close_bf16(et.deform_field_batch(_XF[None], field[None], **kw, **CPU),
                ed.deform_field_batch(_XF[None], field[None], **kw), 1.0)

    def mapping(c):
        return (c[0] * 0.9 + 1.0, c[1] - 2.5)
    _close_bf16(et.geometric_transform(_XF, mapping, **kw, **CPU),
                ed.geometric_transform(_XF, mapping, **kw), 1.0)


def test_table_bfloat16_gradients_match_jax():
    """Autograd through the narrow table: to X the scatter of the exact
    path (the cast passes the cotangent through), to the displacement the
    coordinate gradient on the narrow coefficients, as jax.grad of the
    JAX package's bfloat16 run gives them."""
    import jax
    import jax.numpy as jnp

    def jax_loss(x, d):
        return jnp.sum(ed.deform(x, d, order=3, mode="mirror",
                                 table_dtype="bfloat16") ** 2)
    gx_j, gd_j = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(_XF),
                                                    jnp.asarray(_DF))
    x = torch.as_tensor(_XF).requires_grad_(True)
    d = torch.as_tensor(_DF).requires_grad_(True)
    y = et.deform(x, d, order=3, mode="mirror", table_dtype="bfloat16",
                  **CPU)
    (y ** 2).sum().backward()
    _close_bf16(x.grad, gx_j, float(np.abs(np.asarray(gx_j)).max()))
    gd_j = np.asarray(gd_j, dtype=np.float64)
    np.testing.assert_allclose(d.grad.double().numpy(), gd_j, rtol=1e-3,
                               atol=1e-3 * float(np.abs(gd_j).max()))

    def jax_map_loss(c):
        return jnp.sum(ed.map_coordinates(jnp.asarray(_XF), c, order=3,
                                          mode="mirror",
                                          table_dtype="bfloat16") ** 2)
    gc_j = np.asarray(jax.grad(jax_map_loss)(jnp.asarray(_CF)),
                      dtype=np.float64)
    c = torch.as_tensor(_CF).requires_grad_(True)
    (et.map_coordinates(_XF, c, order=3, mode="mirror",
                        table_dtype="bfloat16", **CPU) ** 2).sum().backward()
    np.testing.assert_allclose(c.grad.double().numpy(), gc_j, rtol=1e-3,
                               atol=1e-3 * float(np.abs(gc_j).max()))
