"""The card's counterpart of ``tools/probe_gather.py``: random row-gather
rates, in M rows/s.

  xla        table[idx] from a 4M-row (2 GiB) table, then the sum: the
             library yardstick (``index_select``)
  xla_small  the same from an 8192-row table, which the L2 holds
  pl_vmem    per-chunk sums of the gathered rows, 8192-row table (P2, sum
             mode)
  pl_dg      the gather of every chunk into one output block, so the last
             chunk's rows stay (P2, copy mode; the TPU probe's
             ``jnp.take`` in the kernel)
  pl_dma     per-chunk sums of rows brought from a 2 GiB table by bulk
             copies, 16 in flight per warp (P4): the random-row rate from
             HBM
  onehot     a bfloat16 one-hot ``torch.matmul`` gather from a 2048-row
             table: a library yardstick

For each probe the function named like it returns its output (``data``
takes a ``(table, idx)`` made once by :func:`make_data`), and
``probe_<name>`` times it on the card and returns the rate.

Run:  python -m elasticdeform_tpu_torch.probes.probe_gather [names...]
"""

from __future__ import annotations

import sys

import torch

from elasticdeform_tpu_torch.ops import probes as _p
from elasticdeform_tpu_torch.probes._common import make_data, run_cli, timeit


def xla(n_rows=4 * 1024 * 1024, n_idx=1 << 20, device=None, data=None):
    """The sum of ``table[idx]`` (0-dim float32), by ``index_select``."""
    table, idx = data or make_data(n_rows, n_idx, device=device)
    return torch.index_select(table, 0, idx).sum()


def probe_xla(n_rows=4 * 1024 * 1024, n_idx=1 << 20, device=None):
    data = make_data(n_rows, n_idx, device=device)
    return n_idx / timeit(xla, n_rows, n_idx, device, data) / 1e6


def xla_small(n_rows=8192, n_idx=1 << 20, device=None, data=None):
    return xla(n_rows, n_idx, device, data)


def probe_xla_small(n_rows=8192, n_idx=1 << 20, device=None):
    return probe_xla(n_rows, n_idx, device)


def pl_vmem(n_rows=8192, n_idx=1 << 20, chunk=8192, device=None, data=None):
    """``(n_idx // chunk, 128)``: each chunk's sum of its gathered rows (the
    TPU probe returns the total of these)."""
    table, idx = data or make_data(n_rows, n_idx, device=device)
    return _p.row_gather_sum(table, idx, chunk)


def probe_pl_vmem(n_rows=8192, n_idx=1 << 20, chunk=8192, device=None):
    data = make_data(n_rows, n_idx, device=device)
    dt = timeit(lambda: pl_vmem(n_rows, n_idx, chunk, device, data).sum())
    return n_idx / dt / 1e6


def pl_dg(n_rows=8192, n_idx=1 << 20, chunk=8192, device=None, data=None):
    """``(chunk, 128)``: ``table[idx[-chunk:]]``. Every grid step of the TPU
    probe writes output block (0, 0), so the last chunk's rows are what
    stays; the card reads all ``n_idx`` rows and keeps the last chunk's."""
    table, idx = data or make_data(n_rows, n_idx, device=device)
    n = n_idx // chunk * chunk
    return _p.row_gather(table, idx[:n], keep_from=n - chunk)


def probe_pl_dg(n_rows=8192, n_idx=1 << 20, chunk=8192, device=None):
    data = make_data(n_rows, n_idx, device=device)
    dt = timeit(lambda: pl_dg(n_rows, n_idx, chunk, device, data).sum())
    return n_idx / dt / 1e6


def pl_dma(n_rows=1 << 22, n_idx=1 << 18, chunk=4096, nsem=16, device=None,
           data=None):
    """``(n_idx // chunk, 128)``: each chunk's sum of its rows, each row
    copied to shared memory by a bulk copy with ``nsem`` = 16 in flight per
    warp (the kernel's fixed ring)."""
    if nsem != _p.ASYNC_RING:
        raise ValueError(f"pl_dma: the kernel keeps {_p.ASYNC_RING} copies "
                         f"in flight, got nsem={nsem}")
    table, idx = data or make_data(n_rows, n_idx, device=device)
    return _p.row_gather_async(table, idx, chunk)


def probe_pl_dma(n_rows=1 << 22, n_idx=1 << 18, chunk=4096, nsem=16,
                 device=None):
    data = make_data(n_rows, n_idx, device=device)
    dt = timeit(lambda: pl_dma(n_rows, n_idx, chunk, nsem, device,
                               data).sum())
    return n_idx / dt / 1e6


def onehot(n_rows=2048, n_idx=1 << 20, chunk=2048, device=None, data=None,
           group=64):
    """The total of the rows gathered by a bfloat16 one-hot matrix product
    per chunk, ``group`` chunks per ``torch.matmul`` (0-dim float32)."""
    table, idx = data or make_data(n_rows, n_idx, device=device)
    tb = table.to(torch.bfloat16)
    ids = torch.arange(n_rows, dtype=torch.int32, device=table.device)
    idx = idx[:n_idx // chunk * chunk].view(-1, chunk)
    total = torch.zeros((), dtype=torch.float32, device=table.device)
    for g in range(0, idx.shape[0], group):
        oh = (idx[g:g + group, :, None] == ids).to(torch.bfloat16)
        total = total + torch.matmul(oh, tb).float().sum()
    return total


def probe_onehot(n_rows=2048, n_idx=1 << 20, chunk=2048, device=None):
    data = make_data(n_rows, n_idx, device=device)
    return n_idx / timeit(onehot, n_rows, n_idx, chunk, device, data) / 1e6


PROBES = {
    "xla": probe_xla,
    "xla_small": probe_xla_small,
    "pl_vmem": probe_pl_vmem,
    "pl_dg": probe_pl_dg,
    "pl_dma": probe_pl_dma,
    "onehot": probe_onehot,
}


if __name__ == "__main__":
    sys.exit(run_cli(PROBES, 10, lambda rate: f"{rate:10.1f} M rows/s"))
