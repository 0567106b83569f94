"""The card's counterpart of ``tools/probe_pallas.py``: how much shared
memory a block may take, and the per-row dynamic gather, store and
scatter-accumulate rates.

  smem{N}     copy an (8, 128) tile through N KiB of a block's dynamic
              shared memory (P1); the TPU probe's ``vmem{N}`` asked for
              16-120 MiB of VMEM, which has no meaning on the card. A block
              of an H100 may take 227 KiB, so ``smem228`` must fail with the
              CUDA error: that failure is the expected answer
  dynload     sum of the 8-row windows at 65536 random starts (P2, sum
              mode); the TPU probe reads past the table for starts above
              8184, the port clamps them (reference note R8)
  dynstore    out[idx[k]] += vals[k], 65536 rows into (8192, 128) (P3)
  dyngather   table[idx], (1024, 128) (P2, copy mode)
  scatrate    the chunked scatter-accumulate, 1M rows into (40960, 128) (P3)

For each probe the function named like it returns its output (``data``
takes inputs made once, from its ``*_data``), and ``probe_<name>`` times
it on the card and returns the JAX file's message.

Run:  python -m elasticdeform_tpu_torch.probes.probe_pallas [names...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import probes as _p
from elasticdeform_tpu_torch.probes._common import (
    LANES, device_of, make_data, run_cli, timeit,
)

SMEM_KIB = (48, 100, 164, 227, 228)


def vmem(kib, device=None):
    """An (8, 128) tile of ones copied through ``kib`` KiB of shared
    memory; raises on the card past its limit."""
    x = torch.ones((8, LANES), dtype=torch.float32, device=device_of(device))
    return _p.smem_probe(x, kib * 1024)


def probe_vmem(kib, device=None):
    out = vmem(kib, device)
    if not bool((out == 1).all()):
        raise AssertionError(f"smem{kib}: the tile came back changed")
    return f"ok ({kib * 1024} bytes)"


def _vals_idx(n_vals, hi, device):
    """The scatter probes' draw: values first, then indices in [0, hi)."""
    rng = np.random.default_rng(0)
    vals = rng.random((n_vals, LANES), dtype=np.float32)
    idx = rng.integers(0, hi, n_vals).astype(np.int32)
    dev = device_of(device)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev)


DYN_ROWS, DYN_IDX, WINDOW = 8192, 65536, 8


def dynload_data(device=None):
    return make_data(DYN_ROWS, DYN_IDX, device=device)


def dynload(device=None, data=None):
    """``(8, 128)``: row r is the sum over k of ``table[s_k + r]``, s_k the
    window start ``idx[k]`` clamped to ``[0, 8192 - 8]``."""
    table, idx = data or dynload_data(device)
    return _p.row_gather_sum(table, idx, DYN_IDX, WINDOW)


def probe_dynload(device=None):
    data = dynload_data(device)
    dt = timeit(dynload, device, data)
    return f"{DYN_IDX / dt / 1e6:.1f} M rows/s"


def dynstore_data(device=None):
    return _vals_idx(DYN_IDX, DYN_ROWS - 1, device)


def dynstore(device=None, data=None):
    """``(8192, 128)``: zeros, then ``out[idx[k]] += vals[k]``."""
    idx, vals = data or dynstore_data(device)
    return _p.row_scatter_add(idx, vals, DYN_ROWS)


def probe_dynstore(device=None):
    data = dynstore_data(device)
    dt = timeit(dynstore, device, data)
    return f"{DYN_IDX / dt / 1e6:.1f} M rows/s"


GATHER_ROWS = 1024


def dyngather_data(device=None):
    return make_data(GATHER_ROWS, GATHER_ROWS, device=device)


def dyngather(device=None, data=None):
    """``table[idx]``, ``(1024, 128)``."""
    table, idx = data or dyngather_data(device)
    return _p.row_gather(table, idx)


def probe_dyngather(device=None):
    data = dyngather_data(device)
    dt = timeit(dyngather, device, data)
    return f"{GATHER_ROWS / dt / 1e6:.1f} M rows/s"


def scatrate_data(n_rows=40960, n_idx=1 << 20, device=None):
    return _vals_idx(n_idx, n_rows, device)


def scatrate(n_rows=40960, n_idx=1 << 20, chunk=1 << 16, device=None,
             data=None):
    """``(n_rows, 128)``: the scatter-accumulate of the whole chunks of
    ``n_idx`` rows (the TPU probe's grid covers ``n_idx // chunk`` of
    them)."""
    idx, vals = data or scatrate_data(n_rows, n_idx, device)
    n = n_idx // chunk * chunk
    return _p.row_scatter_add(idx[:n], vals[:n], n_rows)


def probe_scatrate(n_rows=40960, n_idx=1 << 20, chunk=1 << 16, device=None):
    data = scatrate_data(n_rows, n_idx, device)
    dt = timeit(scatrate, n_rows, n_idx, chunk, device, data)
    return f"{n_idx / dt / 1e6:.1f} M rows/s"


PROBES = {
    **{f"smem{kib}": (lambda kib=kib: probe_vmem(kib)) for kib in SMEM_KIB},
    "dynload": probe_dynload,
    "dynstore": probe_dynstore,
    "dyngather": probe_dyngather,
    "scatrate": probe_scatrate,
}


if __name__ == "__main__":
    sys.exit(run_cli(PROBES, 10, str, expected_failures=("smem228",)))
