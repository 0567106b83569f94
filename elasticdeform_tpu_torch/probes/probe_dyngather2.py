"""The card's counterpart of ``tools/probe_dyngather2.py``: the in-kernel
gather under three index contracts.

  take        ``table[idx]`` with a 1-D index (P2, copy mode)
  take_along  ``take_along_axis(table, idx2d, 0)``, a 2-D index (P2,
              element mode)
  fancy       ``table[idx2d, iota]``, which is ``take_along`` (P2, element
              mode)

The TPU probe gives the 2-D contracts a 1-D index broadcast over the
lanes; the element mode reads each lane's own index whatever it holds.
:func:`gather` returns the output, :func:`run` checks it against
``table[idx]``, times it on the card and prints the JAX file's line.

Run:  python -m elasticdeform_tpu_torch.probes.probe_dyngather2
"""

from __future__ import annotations

import sys

import torch

from elasticdeform_tpu_torch.ops import probes as _p
from elasticdeform_tpu_torch.probes._common import (
    LANES, make_data, timeit,
)

CONTRACTS = ("take", "take_along", "fancy")


def gather_data(n_rows=1024, chunk=1024, idx_shape=None, device=None):
    """``(table, idx, idx_1d)``: the TPU probe's draw, ``idx`` 1-D or, with
    ``idx_shape='2d'``, broadcast to ``(chunk, 128)``."""
    table, idx_1d = make_data(n_rows, chunk, device=device)
    idx = idx_1d[:, None].expand(chunk, LANES).contiguous() \
        if idx_shape == "2d" else idx_1d
    return table, idx, idx_1d


def gather(contract, n_rows=1024, chunk=1024, idx_shape=None, device=None,
           data=None):
    """``(chunk, 128)``: the gather under ``contract`` (one of
    :data:`CONTRACTS`; the 2-D ones need ``idx_shape='2d'``)."""
    table, idx, _ = data or gather_data(n_rows, chunk, idx_shape, device)
    if contract not in CONTRACTS:
        raise ValueError(f"contract must be one of {CONTRACTS}")
    if contract == "take":
        if idx.dim() != 1:
            raise ValueError("take gathers with a 1-D index")
        return _p.row_gather(table, idx)
    return _p.row_gather_element(table, idx)


def run(name, contract, n_rows=1024, chunk=1024, idx_shape=None,
        device=None):
    """Check one contract against ``table[idx]`` and time it; prints the
    JAX file's line and returns whether it passed."""
    try:
        data = gather_data(n_rows, chunk, idx_shape, device)
        table, _, idx_1d = data
        got = gather(contract, n_rows, chunk, idx_shape, device, data)
        want = torch.index_select(table, 0, idx_1d)
        err = float((got - want).abs().max())
        if err != 0.0:
            raise AssertionError(f"err={err:.1e}")
        dt = timeit(gather, contract, n_rows, chunk, idx_shape, device, data)
        print(f"{name:28s} ok  err={err:.1e} "
              f"{chunk / dt / 1e6:.1f} M rows/s", flush=True)
        return True
    except Exception as e:
        print(f"{name:28s} FAIL {type(e).__name__}: {str(e)[:110]}",
              flush=True)
        return False


def main(device=None):
    """The TPU probe's four lines; True if all passed."""
    if device is None and torch.cuda.is_available():
        print(torch.cuda.get_device_name(0), flush=True)
    return all([
        run("take axis=0, idx 1-D", "take", device=device),
        run("take_along_axis, idx 2-D", "take_along", idx_shape="2d",
            device=device),
        run("fancy [idx2d, iota]", "fancy", idx_shape="2d", device=device),
        run("take_along big (64K rows)", "take_along", n_rows=65536,
            chunk=32768, idx_shape="2d", device=device)])


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
