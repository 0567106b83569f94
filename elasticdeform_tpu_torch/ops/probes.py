"""Wrappers of the probe kernels P1-P4 (``csrc/probes.cu``) and their plain
versions.

The kernels measure the card's own ceilings for the memory patterns of the
resampling kernels, and replace the JAX package's twelve Pallas probes in
``tools/`` (see :mod:`elasticdeform_tpu_torch.probes`):

* :func:`smem_probe` (P1): an (8, 128) float32 tile copied through
  ``nbytes`` of a block's dynamic shared memory; a size past the card's
  limit raises the CUDA error;
* :func:`row_gather` (P2, copy mode): ``table[idx[keep_from:]]``, reading
  every row of ``idx``; :func:`row_gather_element` (P2, element mode):
  ``out[k, l] = table[idx2d[k, l], l]``; :func:`row_gather_sum` (P2, sum
  mode): per chunk of ``chunk`` indices the sum of the gathered rows, or of
  ``window`` consecutive rows from each (clamped) index;
* :func:`row_scatter_add` (P3): ``out[idx[k]] += vals[k]`` into zeros;
* :func:`row_gather_async` (P4): the per-chunk row sums with each row
  brought to shared memory by a bulk copy, 16 in flight per warp.

Rows are ``LANES`` = 128 float32 (512 bytes); tables are contiguous
``(n_rows, 128)`` float32 and indices contiguous int32 in ``[0, n_rows)``.
On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises, and adds one to its ``.launches`` counter.
The sums of P2 and P4 combine a chunk's partial sums in a fixed order, so
a run repeats bit for bit; P3's atomics add in a run-dependent order.
"""

from __future__ import annotations

import ctypes

import torch

from elasticdeform_tpu_torch.ops import _build

LANES = 128
MAX_WINDOW = 8          # rows per window of the sum mode (csrc kMaxWindow)
ASYNC_RING = 16         # P4's row slots in flight per warp (csrc kRing)
# the H100's 132 SMs times the blocks of P2's sum mode (8 of 256 threads
# fill an SM) and of P4 (its 35 KB of shared memory fit 6): the blocks a
# chunked sum is split into
_SUM_BLOCKS = 132 * 8
_ASYNC_BLOCKS = 132 * 6


def _lib():
    lib = _build.library("probes")
    if lib.ed_smem_probe.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name, args in (
                ("ed_smem_probe", [vp, vp, ll, vp]),
                ("ed_smem_limit", [ctypes.POINTER(i)]),
                ("ed_row_gather_copy", [vp, vp, vp, ll, ll, vp]),
                ("ed_row_gather_element", [vp, vp, vp, ll, vp]),
                ("ed_row_gather_sum", [vp, vp, vp, vp, ll, ll, ll, i, i, i,
                                       vp]),
                ("ed_row_scatter_add", [vp, vp, vp, ll, vp]),
                ("ed_row_gather_async", [vp, vp, vp, vp, ll, ll, i, vp])):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = args
    return lib


def _launch(name: str, what: str, *args) -> None:
    lib = _lib()
    _build.check(getattr(lib, name)(*args), lib, "ed_probes_error_string",
                 what)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_table(table: torch.Tensor, what: str) -> None:
    if table.dim() != 2 or table.shape[1] != LANES or \
            table.dtype != torch.float32:
        raise ValueError(f"{what}: the table must be (n_rows, {LANES}) "
                         f"float32, got {tuple(table.shape)} {table.dtype}")


def _check_index(idx: torch.Tensor, table: torch.Tensor, what: str) -> None:
    if idx.dtype != torch.int32:
        raise ValueError(f"{what}: indices must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{what}: indices and table must share a device")


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernel takes contiguous tensors")


# ---------------------------------------------------------------------------
# P1


def smem_probe(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``x`` ``(8, 128)`` float32 copied through ``nbytes`` of a block's
    dynamic shared memory (a multiple of 16, at least 4096). On the card a
    size past its limit raises RuntimeError with the CUDA error; the plain
    version, on the CPU, has no shared memory and returns the copy."""
    if tuple(x.shape) != (8, LANES) or x.dtype != torch.float32:
        raise ValueError(f"smem_probe: x must be (8, {LANES}) float32")
    if nbytes < 4096 or nbytes % 16:
        raise ValueError("smem_probe: nbytes must be a multiple of 16 and at "
                         f"least 4096, got {nbytes}")
    if x.device.type == "cpu":
        return x.clone()
    _check_cuda("smem_probe", x)
    out = torch.empty_like(x)
    _launch("ed_smem_probe", "smem_probe", x.data_ptr(), out.data_ptr(),
            nbytes, _stream(x))
    smem_probe.launches += 1
    return out


smem_probe.launches = 0


def smem_limit() -> int:
    """The most dynamic shared memory a block of the current CUDA device may
    ask for, in bytes (232,448 on an H100)."""
    out = ctypes.c_int(0)
    _launch("ed_smem_limit", "smem_limit", ctypes.byref(out))
    return int(out.value)


# ---------------------------------------------------------------------------
# P2


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                     keep_from: int = 0) -> torch.Tensor:
    """Plain version of :func:`row_gather`."""
    return torch.index_select(table, 0, idx[keep_from:])


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               keep_from: int = 0) -> torch.Tensor:
    """``table[idx[keep_from:]]``, ``(len(idx) - keep_from, 128)``. The card
    reads every row of ``idx``, also those it does not keep (the JAX
    probe's grid steps that its last chunk overwrites). Kernel P2, copy
    mode."""
    _check_table(table, "row_gather")
    _check_index(idx, table, "row_gather")
    n_idx = idx.numel()
    if not 0 <= keep_from <= n_idx:
        raise ValueError(f"row_gather: keep_from must lie in [0, {n_idx}]")
    if table.device.type == "cpu":
        return row_gather_plain(table, idx, keep_from)
    _check_cuda("row_gather", table, idx)
    out = torch.empty((n_idx - keep_from, LANES), dtype=table.dtype,
                      device=table.device)
    _launch("ed_row_gather_copy", "row_gather", table.data_ptr(),
            idx.data_ptr(), out.data_ptr(), n_idx, keep_from, _stream(table))
    row_gather.launches += 1
    return out


row_gather.launches = 0


def row_gather_element_plain(table: torch.Tensor,
                             idx2d: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather_element`."""
    return torch.gather(table, 0, idx2d.long())


def row_gather_element(table: torch.Tensor,
                       idx2d: torch.Tensor) -> torch.Tensor:
    """``out[k, l] = table[idx2d[k, l], l]`` (``take_along_axis`` on axis
    0), ``idx2d`` ``(n, 128)`` int32. Kernel P2, element mode."""
    _check_table(table, "row_gather_element")
    _check_index(idx2d, table, "row_gather_element")
    if idx2d.dim() != 2 or idx2d.shape[1] != LANES:
        raise ValueError(f"row_gather_element: idx2d must be (n, {LANES})")
    if table.device.type == "cpu":
        return row_gather_element_plain(table, idx2d)
    _check_cuda("row_gather_element", table, idx2d)
    out = torch.empty(tuple(idx2d.shape), dtype=table.dtype,
                      device=table.device)
    _launch("ed_row_gather_element", "row_gather_element", table.data_ptr(),
            idx2d.data_ptr(), out.data_ptr(), idx2d.shape[0], _stream(table))
    row_gather_element.launches += 1
    return out


row_gather_element.launches = 0


def window_starts(idx: torch.Tensor, n_rows: int, window: int):
    """The first row of each window: ``idx`` clamped to ``[0, n_rows -
    window]`` as ``jax.lax.dynamic_slice`` clamps its start (reference note
    R8: the JAX probe reads past the table instead); a window of one row
    takes ``idx`` as it is."""
    if window == 1:
        return idx
    return torch.clamp(idx, 0, n_rows - window)


def _chunks(idx: torch.Tensor, chunk: int):
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    n_chunks = idx.numel() // chunk
    return n_chunks, idx[:n_chunks * chunk]


def row_gather_sum_plain(table: torch.Tensor, idx: torch.Tensor, chunk: int,
                         window: int = 1) -> torch.Tensor:
    """Plain version of :func:`row_gather_sum` (and of
    :func:`row_gather_async`, ``window`` 1)."""
    n_chunks, idx = _chunks(idx, chunk)
    starts = window_starts(idx, table.shape[0], window)
    parts = [torch.index_select(table, 0, starts + r).view(
        n_chunks, chunk, LANES).sum(1) for r in range(window)]
    return torch.stack(parts, 1).reshape(n_chunks * window, LANES)


def _parts(n_chunks: int, chunk: int, blocks: int, per_block: int) -> int:
    """Blocks per chunk: enough for ``blocks`` in all, at least
    ``per_block`` rows each."""
    want = -(-blocks // max(n_chunks, 1))
    return max(1, min(want, -(-chunk // per_block)))


def row_gather_sum(table: torch.Tensor, idx: torch.Tensor, chunk: int,
                   window: int = 1) -> torch.Tensor:
    """Per chunk of ``chunk`` indices (the whole chunks of ``idx``), the sum
    of the gathered rows, or, for ``window`` > 1, row ``r`` of the sum of
    the ``window``-row windows that start at the indices (clamped, see
    :func:`window_starts`): ``(n_chunks * window, 128)``, row ``c * window
    + r``. Kernel P2, sum mode, ``window`` <= 8."""
    _check_table(table, "row_gather_sum")
    _check_index(idx, table, "row_gather_sum")
    if not 1 <= window <= min(MAX_WINDOW, table.shape[0]):
        raise ValueError(f"row_gather_sum: window must lie in [1, "
                         f"{MAX_WINDOW}] and fit the table, got {window}")
    if table.device.type == "cpu":
        return row_gather_sum_plain(table, idx, chunk, window)
    n_chunks, idx = _chunks(idx, chunk)
    _check_cuda("row_gather_sum", table, idx)
    parts = _parts(n_chunks, chunk, _SUM_BLOCKS, 8)
    partial = torch.empty((n_chunks * parts * window, LANES),
                          dtype=table.dtype, device=table.device)
    out = torch.empty((n_chunks * window, LANES), dtype=table.dtype,
                      device=table.device)
    _launch("ed_row_gather_sum", "row_gather_sum", table.data_ptr(),
            idx.data_ptr(), partial.data_ptr(), out.data_ptr(),
            table.shape[0], n_chunks, chunk, parts, window,
            int(window > 1), _stream(table))
    row_gather_sum.launches += 1
    return out


row_gather_sum.launches = 0


# ---------------------------------------------------------------------------
# P3


def row_scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    """Plain version of :func:`row_scatter_add`."""
    out = torch.zeros((n_rows, LANES), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def row_scatter_add(idx: torch.Tensor, vals: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """``out[idx[k]] += vals[k]`` into a zeroed ``(n_rows, 128)`` float32
    table; ``vals`` ``(len(idx), 128)`` float32. Kernel P3 (float32
    atomics: the sums land in a run-dependent order)."""
    _check_table(vals, "row_scatter_add")
    _check_index(idx, vals, "row_scatter_add")
    if idx.shape != (vals.shape[0],):
        raise ValueError("row_scatter_add: one index per row of vals")
    if vals.device.type == "cpu":
        return row_scatter_add_plain(idx, vals, n_rows)
    _check_cuda("row_scatter_add", idx, vals)
    out = torch.zeros((n_rows, LANES), dtype=vals.dtype, device=vals.device)
    _launch("ed_row_scatter_add", "row_scatter_add", idx.data_ptr(),
            vals.data_ptr(), out.data_ptr(), idx.numel(), _stream(vals))
    row_scatter_add.launches += 1
    return out


row_scatter_add.launches = 0


# ---------------------------------------------------------------------------
# P4


def row_gather_async(table: torch.Tensor, idx: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Per chunk of ``chunk`` indices the sum of the gathered rows,
    ``(n_chunks, 128)``, each row brought to shared memory by a bulk copy
    with 16 in flight per warp. Kernel P4; its plain version is
    :func:`row_gather_sum_plain`."""
    _check_table(table, "row_gather_async")
    _check_index(idx, table, "row_gather_async")
    if table.device.type == "cpu":
        return row_gather_sum_plain(table, idx, chunk)
    n_chunks, idx = _chunks(idx, chunk)
    _check_cuda("row_gather_async", table, idx)
    if table.data_ptr() % 16:
        raise ValueError("row_gather_async: the bulk copy needs a table "
                         "aligned to 16 bytes")
    parts = _parts(n_chunks, chunk, _ASYNC_BLOCKS, 4 * ASYNC_RING)
    partial = torch.empty((n_chunks * parts, LANES), dtype=table.dtype,
                          device=table.device)
    out = torch.empty((n_chunks, LANES), dtype=table.dtype,
                      device=table.device)
    _launch("ed_row_gather_async", "row_gather_async", table.data_ptr(),
            idx.data_ptr(), partial.data_ptr(), out.data_ptr(), n_chunks,
            chunk, parts, _stream(table))
    row_gather_async.launches += 1
    return out


row_gather_async.launches = 0


# each kernel's wrappers, which hold its launch counters
KERNEL_WRAPPERS = {
    "smem_probe": (smem_probe,),
    "row_gather": (row_gather, row_gather_element, row_gather_sum),
    "row_scatter_add": (row_scatter_add,),
    "row_gather_async": (row_gather_async,)}
