"""elasticdeform_tpu_torch stands alone: no JAX, no elasticdeform_tpu.

* a subprocess that cannot import ``jax`` or ``elasticdeform_tpu`` imports
  the port, its probes included, and runs a deformation and the probes on
  the CPU;
* no module of the port and not ``chip_smoke.py`` imports either;
* the entry points, the probes' too, default to the card: with no CUDA
  device, a call without ``device`` raises instead of computing on the
  CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "elasticdeform_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "elasticdeform_tpu")


def _run(code: str, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, env=env, cwd=str(ROOT))


_BLOCKER = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split('.')[0]
        if top in ('jax', 'jaxlib', 'elasticdeform_tpu'):
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, _Block())
"""


def test_port_runs_with_jax_and_reference_blocked():
    code = _BLOCKER + """
import numpy as np
import elasticdeform_tpu_torch as et
import elasticdeform_tpu_torch.api, elasticdeform_tpu_torch.core
import elasticdeform_tpu_torch.ops.filters
import elasticdeform_tpu_torch.ops.morphology
import elasticdeform_tpu_torch.ops.probes
from elasticdeform_tpu_torch.probes import (
    probe_dyngather2, probe_gather, probe_gather2, probe_pallas)
X = np.random.RandomState(0).rand(12, 14)
d = np.random.RandomState(1).randn(2, 3, 3) * 3
Y = et.deform_grid([X, (X * 100).astype(np.uint8)], d, order=[3, 0],
                   device='cpu')
assert Y[0].shape == X.shape and Y[1].dtype == np.uint8
assert np.isfinite(Y[0]).all()
c = np.random.RandomState(2).uniform(-3, 15, (2, 5, 6))
assert et.map_coordinates(X, c, mode='grid-wrap', device='cpu').shape == (5, 6)
assert et.affine_transform(X, np.eye(2) * 1.1, mode='reflect',
                           device='cpu').shape == X.shape
assert et.spline_filter(X, mode='nearest', device='cpu').shape == X.shape
assert et.gaussian_filter(X, 1.5, device='cpu').shape == X.shape
assert et.gaussian_laplace(X, 1.0, output=np.int16, device='cpu').dtype \
    == elasticdeform_tpu_torch.core.torch.int16
assert et.correlate(X, np.ones((3, 2)), mode='grid-wrap',
                    device='cpu').shape == X.shape
assert et.sobel(X, device='cpu').shape == X.shape
assert et.median_filter(X, size=3, device='cpu').shape == X.shape
assert et.grey_opening((X * 100).astype(np.int16), size=(3, 2),
                       device='cpu').dtype == elasticdeform_tpu_torch.core.torch.int16
assert et.binary_fill_holes(X > 0.5, device='cpu').dtype \
    == elasticdeform_tpu_torch.core.torch.bool
labels, n = et.label(X > 0.5, device='cpu')
assert n >= 1 and et.find_objects(labels, device='cpu')[0] is not None
assert et.mean(X, labels, np.arange(1, n + 1), device='cpu').shape == (n,)
assert probe_pallas.dynload('cpu').shape == (8, 128)
assert probe_gather.pl_dg(256, 1024, 256, 'cpu').shape == (256, 128)
assert probe_gather2.pl_loop_scatter(256, 1024, 256, 'cpu').sum() \
    == 1024 * 128
assert probe_dyngather2.gather('fancy', 64, 32, '2d', 'cpu').shape \
    == (32, 128)
assert not any(m.split('.')[0] in ('jax', 'elasticdeform_tpu')
               for m in sys.modules)
print('ok')
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_default_device_is_the_card():
    code = """
import numpy as np, torch
import elasticdeform_tpu_torch as et
from elasticdeform_tpu_torch.probes import (
    probe_dyngather2, probe_gather, probe_gather2, probe_pallas)
assert not torch.cuda.is_available()
X = np.random.RandomState(0).rand(10, 11)
d = np.zeros((2, 3, 3))
c = np.zeros((2, 4, 5))
for call in (lambda: et.deform_grid(X, d),
             lambda: et.deform_random_grid(X),
             lambda: et.deform(torch.as_tensor(X), torch.as_tensor(d)),
             lambda: et.deform_batch(torch.as_tensor(X[None]),
                                     torch.as_tensor(d[None])),
             lambda: et.map_coordinates(X, c),
             lambda: et.map_coordinates(X, c, mode='grid-wrap'),
             lambda: et.map_coordinates_batch(X[None], c[None]),
             lambda: et.map_coordinates_gradient(c[0], c, X_shape=X.shape),
             lambda: et.deform_field(X, np.zeros((2, 10, 11))),
             lambda: et.deform_field_batch(X[None], np.zeros((1, 2, 10, 11))),
             lambda: et.affine_transform(X, np.eye(2)),
             lambda: et.shift(X, 1.5),
             lambda: et.zoom(X, 1.5),
             lambda: et.rotate(X, 30.0),
             lambda: et.geometric_transform(X, lambda o: o),
             lambda: et.spline_filter(X),
             lambda: et.spline_filter1d(X),
             lambda: et.api.map_coordinates(X, c),
             lambda: et.api.geometric_transform(X, lambda o: o),
             lambda: et.api.map_coordinates_gradient(c[0], c,
                                                     X_shape=X.shape),
             lambda: et.gaussian_filter1d(X, 1.0),
             lambda: et.gaussian_filter(X, 1.0),
             lambda: et.gaussian_laplace(X, 1.0),
             lambda: et.gaussian_gradient_magnitude(X, 1.0),
             lambda: et.correlate1d(X, [1.0, 2.0]),
             lambda: et.convolve1d(X, [1.0, 2.0]),
             lambda: et.uniform_filter1d(X, 3),
             lambda: et.uniform_filter(X, 3),
             lambda: et.sobel(X),
             lambda: et.prewitt(X),
             lambda: et.laplace(X),
             lambda: et.correlate(X, np.ones((2, 2))),
             lambda: et.convolve(X, np.ones((2, 2))),
             lambda: et.generic_laplace(X, lambda *a: a[0]),
             lambda: et.generic_gradient_magnitude(X, lambda *a: a[0]),
             lambda: et.minimum_filter1d(X, 3),
             lambda: et.maximum_filter1d(X, 3),
             lambda: et.minimum_filter(X, 3),
             lambda: et.maximum_filter(X, footprint=np.eye(3)),
             lambda: et.rank_filter(X, 1, 3),
             lambda: et.median_filter(X, 3),
             lambda: et.percentile_filter(X, 20, 3),
             lambda: et.grey_erosion(X, 3),
             lambda: et.grey_dilation(X, 3),
             lambda: et.grey_opening(X, 3),
             lambda: et.grey_closing(X, 3),
             lambda: et.morphological_gradient(X, 3),
             lambda: et.morphological_laplace(X, 3),
             lambda: et.white_tophat(X, 3),
             lambda: et.black_tophat(X, 3),
             lambda: et.binary_erosion(X),
             lambda: et.binary_dilation(X),
             lambda: et.binary_opening(X),
             lambda: et.binary_closing(X),
             lambda: et.binary_propagation(X),
             lambda: et.binary_fill_holes(X),
             lambda: et.binary_hit_or_miss(X),
             lambda: et.generic_filter(X, lambda v: v.max(), 3),
             lambda: et.generic_filter1d(X, lambda v: v[:11], 3),
             lambda: et.vectorized_filter(X, torch.amax, size=3),
             lambda: et.label(X > 0.5),
             lambda: et.sum_labels(X, X > 0.5),
             lambda: et.minimum_position(X),
             lambda: et.histogram(X, 0, 1, 4),
             lambda: et.find_objects((X > 0.5).astype(int)),
             lambda: probe_pallas.vmem(48),
             lambda: probe_pallas.dynload(),
             lambda: probe_pallas.dynstore(),
             lambda: probe_pallas.dyngather(),
             lambda: probe_pallas.scatrate(256, 1024, 256),
             lambda: probe_pallas.probe_dyngather(),
             lambda: probe_gather.pl_vmem(256, 1024, 256),
             lambda: probe_gather.pl_dg(256, 1024, 256),
             lambda: probe_gather.pl_dma(4096, 1024, 256),
             lambda: probe_gather.xla(256, 1024),
             lambda: probe_gather.onehot(256, 1024, 256),
             lambda: probe_gather2.pl_loop_gather(256, 1024, 256),
             lambda: probe_gather2.pl_loop_scatter(256, 1024, 256),
             lambda: probe_gather2.xla_map_sample(2, 64, 32),
             lambda: probe_dyngather2.gather('take', 64, 32)):
    try:
        call()
    except (RuntimeError, AssertionError):
        continue
    raise SystemExit('a call without device ran without a card')
assert et.deform_grid(X, d, device='cpu').shape == X.shape
print('ok')
"""
    r = _run(code, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr + r.stdout
    assert r.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_card():
    r = _run("import runpy, sys; sys.argv = ['chip_smoke.py'];"
             "runpy.run_path('chip_smoke.py', run_name='__main__')",
             {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("module, args", [
    ("probe_pallas", ["dyngather", "smem48"]),
    ("probe_gather", ["pl_vmem"]),
    ("probe_gather2", ["pl_loop_scatter"]),
    ("probe_dyngather2", [])])
def test_probe_cli_fails_without_card(module, args):
    """``python -m elasticdeform_tpu_torch.probes.<file>`` measures the
    card: without one every probe fails and the exit code says so."""
    r = subprocess.run(
        [sys.executable, "-m", f"elasticdeform_tpu_torch.probes.{module}",
         *args], capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "CUDA_VISIBLE_DEVICES": ""}, cwd=str(ROOT))
    assert r.returncode == 1, r.stderr
    assert "FAIL" in r.stdout
