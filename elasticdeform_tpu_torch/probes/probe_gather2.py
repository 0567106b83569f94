"""The card's counterpart of ``tools/probe_gather2.py``: row gather and
scatter rates, in M rows/s.

  pl_loop_gather   table[idx], (8192, 128) -> (512K, 128) (P2, copy mode)
  pl_dg            take_along_axis with the index broadcast over the lanes,
                   which is table[idx], (8192, 128) -> (1M, 128) (P2, copy
                   mode)
  pl_loop_scatter  out[idx[k]] += 1 on every lane, 512K rows into
                   (8192, 128): integer counts (P3)
  xla_map_sample   per sample, table[idx] from its own 65536-row slice of a
                   4M-row (2 GiB) table: a library yardstick
                   (``index_select``)

For each probe the function named like it returns its output (``data``
takes inputs made once), and ``probe_<name>`` times it on the card and
returns the rate.

Run:  python -m elasticdeform_tpu_torch.probes.probe_gather2 [names...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from elasticdeform_tpu_torch.ops import probes as _p
from elasticdeform_tpu_torch.probes._common import (
    LANES, device_of, make_data, run_cli, timeit,
)


def pl_loop_gather(n_rows=8192, n_idx=1 << 19, chunk=4096, device=None,
                   data=None):
    """``table[idx]`` over the whole chunks, ``(n_idx // chunk * chunk,
    128)`` (the TPU probe returns the sum of its first 8 rows)."""
    table, idx = data or make_data(n_rows, n_idx, device=device)
    return _p.row_gather(table, idx[:n_idx // chunk * chunk])


def probe_pl_loop_gather(n_rows=8192, n_idx=1 << 19, chunk=4096,
                         device=None):
    data = make_data(n_rows, n_idx, device=device)
    dt = timeit(lambda: pl_loop_gather(n_rows, n_idx, chunk, device,
                                       data)[:8].sum())
    return n_idx / dt / 1e6


def pl_dg(n_rows=8192, n_idx=1 << 20, chunk=8192, device=None, data=None):
    """``take_along_axis(table, idx broadcast over the lanes, 0)``, which is
    ``table[idx]`` over the whole chunks."""
    return pl_loop_gather(n_rows, n_idx, chunk, device, data)


def probe_pl_dg(n_rows=8192, n_idx=1 << 20, chunk=8192, device=None):
    return probe_pl_loop_gather(n_rows, n_idx, chunk, device)


def pl_loop_scatter(n_rows=8192, n_idx=1 << 19, chunk=4096, device=None,
                    data=None):
    """``(n_rows, 128)`` float32: how often each row of ``idx`` (over the
    whole chunks) occurs, on every lane: the scatter-add of rows of
    ones."""
    _, idx = data or make_data(n_rows, n_idx, device=device)
    idx = idx[:n_idx // chunk * chunk]
    vals = torch.ones((idx.numel(), LANES), dtype=torch.float32,
                      device=idx.device)
    return _p.row_scatter_add(idx, vals, n_rows)


def probe_pl_loop_scatter(n_rows=8192, n_idx=1 << 19, chunk=4096,
                          device=None):
    data = make_data(n_rows, n_idx, device=device)
    dt = timeit(lambda: pl_loop_scatter(n_rows, n_idx, chunk, device,
                                        data)[:8].sum())
    return n_idx / dt / 1e6


def xla_map_sample_data(nb=64, rps=65536, n_s=262144, device=None):
    """``(table (nb * rps, 128), idx (nb, n_s))``, drawn as the TPU probe
    draws them; the table is :func:`make_data`'s for ``nb * rps`` rows."""
    rng = np.random.default_rng(0)
    table = rng.random((nb * rps, LANES), dtype=np.float32)
    idx = rng.integers(0, rps, size=(nb, n_s)).astype(np.int32)
    dev = device_of(device)
    return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)


def xla_map_sample(nb=64, rps=65536, n_s=262144, device=None, data=None):
    """The total over samples ``b`` of ``table[b * rps + idx[b]]`` (0-dim
    float32)."""
    table, idx = data or xla_map_sample_data(nb, rps, n_s, device)
    total = torch.zeros((), dtype=torch.float32, device=table.device)
    for b in range(nb):
        sub = table[b * rps:(b + 1) * rps]
        total = total + torch.index_select(sub, 0, idx[b]).sum()
    return total


def probe_xla_map_sample(nb=64, rps=65536, n_s=262144, device=None):
    data = xla_map_sample_data(nb, rps, n_s, device)
    dt = timeit(xla_map_sample, nb, rps, n_s, device, data, n=5)
    return nb * n_s / dt / 1e6


PROBES = {
    "pl_loop_gather": probe_pl_loop_gather,
    "pl_dg": probe_pl_dg,
    "pl_loop_scatter": probe_pl_loop_scatter,
    "xla_map_sample": probe_xla_map_sample,
}


if __name__ == "__main__":
    sys.exit(run_cli(PROBES, 16, lambda rate: f"{rate:10.1f} M rows/s"))
