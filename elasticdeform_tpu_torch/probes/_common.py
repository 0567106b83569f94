"""What the probe modules share: ``LANES``, the seeded data, a timer on the
card and the command line.

``make_data`` draws exactly as the JAX package's
``tools/probe_gather.py:40-44`` does, so both packages see the same table
and indices for a seed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

LANES = 128


def device_of(device) -> torch.device:
    """``None`` means the card, ``"cuda"``; the CPU only when asked."""
    return torch.device("cuda" if device is None else device)


def make_data(n_rows, n_idx, seed=0, device=None):
    """``(table, idx)``: an ``(n_rows, 128)`` float32 table of uniform
    values in [0, 1) and ``n_idx`` int32 indices in ``[0, n_rows)``, drawn
    from ``np.random.default_rng(seed)`` in that order, on ``device``."""
    rng = np.random.default_rng(seed)
    table = rng.random((n_rows, LANES), dtype=np.float32)
    idx = rng.integers(0, n_rows, size=n_idx).astype(np.int32)
    dev = device_of(device)
    return torch.from_numpy(table).to(dev), torch.from_numpy(idx).to(dev)


def timeit(fn, *args, n=10):
    """Seconds per call of ``fn(*args)`` on the card: one warm-up call,
    then ``n`` calls between two CUDA events. There is no host fallback:
    without a CUDA device it raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time the card: no CUDA device")
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n


def run_cli(probes, width, fmt, expected_failures=()):
    """Run the probes named on the command line (all by default) and print
    one line each, as the JAX file does: ``fmt(result)`` or ``FAILED: ...``.
    Returns 1 if a probe failed that is not in ``expected_failures`` (whose
    failure is the answer, such as a shared-memory size past the card's
    limit), else 0."""
    names = sys.argv[1:] or list(probes)
    failed = False
    for name in names:
        try:
            print(f"{name:{width}s} {fmt(probes[name]())}", flush=True)
        except Exception as e:
            msg = str(e).replace("\n", " ")[:200]
            print(f"{name:{width}s} FAILED: {type(e).__name__}: {msg}",
                  flush=True)
            failed = failed or name not in expected_failures
    return 1 if failed else 0
