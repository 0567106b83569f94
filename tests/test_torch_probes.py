"""The probes of ``elasticdeform_tpu_torch.probes`` against the JAX
package's Pallas probes in ``tools/``, on the CPU.

Each Pallas probe that takes sizes runs its own kernel in TPU interpret
mode (``pltpu.force_tpu_interpret_mode``) at a small size; its output is
captured without editing the probe: ``pl.pallas_call`` is wrapped so that
a debug callback keeps the kernel's result, and the module's ``timeit``
calls the jitted function once. The port runs the same seeded numpy data
with ``device="cpu"`` (the kernels' plain versions). Gathers agree bit for
bit; sums to 1e-6 of the sum of the absolute terms ``S`` per element; the
scatter of ones (integer counts) exactly.

``probe_dynload`` and ``probe_dynstore`` have fixed sizes, and in
interpret mode ``dynload`` reads past its table and ``dynstore`` loops
65536 times, so both are held against numpy instead, with the window
starts clamped as reference note R8 says.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from elasticdeform_tpu_torch.ops import probes as op
from elasticdeform_tpu_torch.probes import _common
from elasticdeform_tpu_torch.probes import probe_dyngather2 as t_dg2
from elasticdeform_tpu_torch.probes import probe_gather as t_gather
from elasticdeform_tpu_torch.probes import probe_gather2 as t_gather2
from elasticdeform_tpu_torch.probes import probe_pallas as t_pallas

TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU = "cpu"


def _tools_module(name):
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    return __import__(name)


@pytest.fixture
def pallas_outputs(monkeypatch):
    """Run a JAX probe in TPU interpret mode and return the outputs of its
    ``pallas_call`` kernels, in call order."""
    captured = []
    orig = pl.pallas_call

    def spy(*args, **kwargs):
        call = orig(*args, **kwargs)

        def run(*operands):
            out = call(*operands)
            jax.debug.callback(lambda v: captured.append(np.asarray(v)), out)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", spy)
    mods = {name: _tools_module(name) for name in (
        "probe_pallas", "probe_gather", "probe_gather2", "probe_dyngather2")}

    def call_args(fn, *args, n=10):
        jax.block_until_ready(fn(*args))
        return 1.0

    def call_sync(fn, sync, iters=20):
        jax.block_until_ready(fn())
        return 1.0

    for name in ("probe_pallas", "probe_dyngather2"):
        monkeypatch.setattr(mods[name], "timeit", call_args)
    for name in ("probe_gather", "probe_gather2"):
        monkeypatch.setattr(mods[name], "timeit", call_sync)

    def run(name, probe, *args, **kwargs):
        captured.clear()
        with pltpu.force_tpu_interpret_mode():
            getattr(mods[name], probe)(*args, **kwargs)
        jax.effects_barrier()
        return list(captured)
    run.modules = mods
    return run


def _np(t):
    return t.detach().cpu().numpy()


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _close_to_sum(got, want, scale):
    """Per element within 1e-6 of ``scale``, the sum of the absolute terms
    that land there."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    bad = np.abs(got - want) > 1e-6 * np.asarray(scale) + 1e-30
    assert not bad.any(), (np.abs(got - want).max(), int(bad.sum()))


def _chunk_sums64(table, idx, chunk):
    n = len(idx) // chunk
    rows = table.astype(np.float64)[idx[:n * chunk]]
    return rows.reshape(n, chunk, -1).sum(1)


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode


@pytest.mark.parametrize("kib", t_pallas.SMEM_KIB)
def test_vmem_matches_pallas(pallas_outputs, kib):
    (want,) = pallas_outputs("probe_pallas", "probe_vmem", 1)
    _same_bits(_np(t_pallas.vmem(kib, CPU)), want)


def test_dyngather_matches_pallas(pallas_outputs):
    (want,) = pallas_outputs("probe_pallas", "probe_dyngather")
    _same_bits(_np(t_pallas.dyngather(CPU)), want)


def test_scatrate_matches_pallas(pallas_outputs):
    sizes = (256, 1024, 256)
    (want,) = pallas_outputs("probe_pallas", "probe_scatrate", *sizes)
    got = _np(t_pallas.scatrate(*sizes, device=CPU))
    idx, vals = (_np(t) for t in t_pallas.scatrate_data(256, 1024, CPU))
    scale = np.zeros((256, 128))
    np.add.at(scale, idx, np.abs(vals.astype(np.float64)))
    _close_to_sum(got, want, scale)


def test_pl_vmem_matches_pallas(pallas_outputs):
    sizes = (256, 1024, 256)
    (want,) = pallas_outputs("probe_gather", "probe_pl_vmem", *sizes)
    got = _np(t_gather.pl_vmem(*sizes, device=CPU))
    table, idx = (_np(t) for t in _common.make_data(256, 1024, device=CPU))
    assert want.shape == got.shape == (4, 128)
    _close_to_sum(got, want, _chunk_sums64(table, idx, 256))


def test_pl_dg_keeps_the_last_chunk_like_pallas(pallas_outputs):
    sizes = (256, 2048, 512)
    (want,) = pallas_outputs("probe_gather", "probe_pl_dg", *sizes)
    got = _np(t_gather.pl_dg(*sizes, device=CPU))
    _same_bits(got, want)
    table, idx = (_np(t) for t in _common.make_data(256, 2048, device=CPU))
    _same_bits(got, table[idx[-512:]])


def test_pl_dma_matches_pallas(pallas_outputs):
    sizes = (4096, 1024, 256)
    (want,) = pallas_outputs("probe_gather", "probe_pl_dma", *sizes)
    got = _np(t_gather.pl_dma(*sizes, device=CPU))
    table, idx = (_np(t) for t in _common.make_data(4096, 1024, device=CPU))
    assert want.shape == got.shape == (4, 128)
    _close_to_sum(got, want, _chunk_sums64(table, idx, 256))
    with pytest.raises(ValueError, match="16 copies"):
        t_gather.pl_dma(*sizes, nsem=8, device=CPU)


def test_pl_loop_gather_matches_pallas(pallas_outputs):
    sizes = (256, 1024, 256)
    (want,) = pallas_outputs("probe_gather2", "probe_pl_loop_gather", *sizes)
    _same_bits(_np(t_gather2.pl_loop_gather(*sizes, device=CPU)), want)


def test_gather2_pl_dg_matches_pallas(pallas_outputs):
    sizes = (256, 2048, 512)
    (want,) = pallas_outputs("probe_gather2", "probe_pl_dg", *sizes)
    _same_bits(_np(t_gather2.pl_dg(*sizes, device=CPU)), want)


def test_pl_loop_scatter_counts_match_pallas(pallas_outputs):
    sizes = (256, 1024, 256)
    (want,) = pallas_outputs("probe_gather2", "probe_pl_loop_scatter",
                             *sizes)
    got = _np(t_gather2.pl_loop_scatter(*sizes, device=CPU))
    _same_bits(got, want)
    _, idx = (_np(t) for t in _common.make_data(256, 1024, device=CPU))
    np.testing.assert_array_equal(got[:, 0], np.bincount(idx, minlength=256))


def test_dyngather2_contracts_match_pallas(pallas_outputs, monkeypatch):
    """The JAX probe's own three kernels (its main() at a small size)
    against the port's contracts."""
    mod = pallas_outputs.modules["probe_dyngather2"]
    orig = mod.run
    seen = []

    def small_run(name, kernel, n_rows=1024, chunk=1024, idx_shape=None):
        ok = orig(name, kernel, 256, 512, idx_shape)
        seen.append((name, idx_shape, ok))
        return ok
    monkeypatch.setattr(mod, "run", small_run)
    outs = pallas_outputs("probe_dyngather2", "main")
    contracts = ["take", "take_along", "fancy", "take_along"]
    assert [ok for *_, ok in seen] == [True] * 4
    # each run calls its kernel twice: the check and the timing
    assert len(outs) == 8
    for i, ((_, idx_shape, _), contract) in enumerate(zip(seen, contracts)):
        got = _np(t_dg2.gather(contract, 256, 512, idx_shape, CPU))
        _same_bits(got, outs[2 * i])
        _same_bits(got, outs[2 * i + 1])


# ---------------------------------------------------------------------------
# the fixed-size probes against numpy


def test_dynload_matches_numpy_with_clamped_windows():
    """R8: a window that would run past the table starts at n_rows - 8, as
    ``jax.lax.dynamic_slice`` clamps it (the TPU probe reads past the
    buffer instead)."""
    table, idx = (_np(t) for t in t_pallas.dynload_data(CPU))
    assert (idx > 8192 - 8).any()          # the seed does reach the end
    starts = np.minimum(idx, 8192 - 8)
    rows = table.astype(np.float64)
    want = np.stack([rows[starts + r].sum(0) for r in range(8)])
    scale = want                          # the terms are positive
    got = _np(t_pallas.dynload(CPU))
    assert got.shape == (8, 128)
    _close_to_sum(got, want, scale)
    # without the clamp the sums would differ (the last rows count more)
    unclamped = np.zeros((8, 128))
    for r in range(8):
        ok = idx + r < 8192
        unclamped[r] = rows[idx[ok] + r].sum(0)
    assert np.abs(unclamped - want).max() > 1e-3


def test_window_starts_clamp():
    idx = torch.tensor([-3, 0, 5, 8184, 8185, 8191], dtype=torch.int32)
    assert op.window_starts(idx, 8192, 8).tolist() == [0, 0, 5, 8184, 8184,
                                                       8184]
    assert op.window_starts(idx, 8192, 1) is idx


def test_dynstore_matches_numpy():
    idx, vals = (_np(t) for t in t_pallas.dynstore_data(CPU))
    assert idx.max() <= 8190
    want = np.zeros((8192, 128))
    np.add.at(want, idx, vals.astype(np.float64))
    _close_to_sum(_np(t_pallas.dynstore(CPU)), want, want)


# ---------------------------------------------------------------------------
# the library yardsticks and the wrappers' rules


def test_library_yardsticks_match_numpy():
    table, idx = (_np(t) for t in _common.make_data(256, 2048, device=CPU))
    total = table.astype(np.float64)[idx].sum()
    for got in (t_gather.xla(256, 2048, CPU), t_gather.xla_small(256, 2048,
                                                                 CPU)):
        assert abs(float(got) - total) <= 1e-6 * total
    # one-hot: the bfloat16 table's rows
    tb = torch.from_numpy(table).to(torch.bfloat16).double().numpy()
    total_b = tb[idx].sum()
    got = t_gather.onehot(256, 2048, 512, CPU, group=3)
    assert abs(float(got) - total_b) <= 1e-6 * total_b
    # per-sample sub-tables
    tab, ix = (_np(t) for t in t_gather2.xla_map_sample_data(4, 256, 128,
                                                             CPU))
    want = sum(tab[b * 256 + ix[b]].astype(np.float64).sum()
               for b in range(4))
    got = t_gather2.xla_map_sample(4, 256, 128, CPU)
    assert abs(float(got) - want) <= 1e-6 * want
    # the same draw as make_data's table
    assert np.array_equal(tab, _np(_common.make_data(1024, 1, device=CPU)[0]))


def test_make_data_is_the_jax_probes_draw():
    tools_gather = _tools_module("probe_gather")
    jt, ji = tools_gather.make_data(300, 77, seed=3)
    pt, pi = _common.make_data(300, 77, seed=3, device=CPU)
    _same_bits(_np(pt), np.asarray(jt))
    np.testing.assert_array_equal(_np(pi), np.asarray(ji))
    assert pi.dtype == torch.int32


def test_wrappers_check_their_arguments():
    table, idx = _common.make_data(64, 32, device=CPU)
    with pytest.raises(ValueError, match="int32"):
        op.row_gather(table, idx.long())
    with pytest.raises(ValueError, match="float32"):
        op.row_gather(table.double(), idx)
    with pytest.raises(ValueError, match="keep_from"):
        op.row_gather(table, idx, keep_from=33)
    with pytest.raises(ValueError, match="window"):
        op.row_gather_sum(table, idx, 8, window=9)
    with pytest.raises(ValueError, match="nbytes"):
        op.smem_probe(torch.ones(8, 128), 100)
    with pytest.raises(ValueError, match="one index per row"):
        op.row_scatter_add(idx[:5], table, 64)
    with pytest.raises(ValueError, match="contract"):
        t_dg2.gather("nope", 64, 32, device=CPU)


def test_element_mode_reads_each_lanes_index():
    """The element contract does not assume a broadcast index."""
    rs = np.random.RandomState(4)
    table = torch.from_numpy(rs.rand(50, 128).astype(np.float32))
    idx2d = torch.from_numpy(rs.randint(0, 50, (20, 128)).astype(np.int32))
    got = _np(op.row_gather_element(table, idx2d))
    want = np.take_along_axis(_np(table), _np(idx2d).astype(np.int64), 0)
    _same_bits(got, want)


def test_cli_exit_codes(monkeypatch, capsys):
    def fail():
        raise RuntimeError("too much")
    probes = {"ok": lambda: 1.5, "smem228": fail, "bad": fail}
    monkeypatch.setattr(sys, "argv", ["x", "ok", "smem228"])
    assert _common.run_cli(probes, 8, str, ("smem228",)) == 0
    monkeypatch.setattr(sys, "argv", ["x"])
    assert _common.run_cli(probes, 8, str, ("smem228",)) == 1
    out = capsys.readouterr().out
    assert "ok       1.5" in out and "bad      FAILED: RuntimeError" in out


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(cuda_device):
    table, idx = _common.make_data(8192, 1 << 16, device=cuda_device)
    assert torch.equal(op.row_gather(table, idx, 1000),
                       op.row_gather_plain(table, idx, 1000))
    idx2d = idx[:512, None].expand(512, 128).contiguous()
    assert torch.equal(op.row_gather_element(table, idx2d),
                       op.row_gather_element_plain(table, idx2d))
    for window, chunk in ((1, 4096), (8, 1 << 16)):
        got = op.row_gather_sum(table, idx, chunk, window)
        assert torch.equal(got, op.row_gather_sum(table, idx, chunk, window))
        want = op.row_gather_sum_plain(table, idx, chunk, window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    got = op.row_gather_async(table, idx, 4096)
    torch.testing.assert_close(got, op.row_gather_sum_plain(table, idx,
                                                            4096),
                               rtol=1e-5, atol=0)
    ones = torch.ones((idx.numel(), 128), device=cuda_device)
    assert torch.equal(op.row_scatter_add(idx, ones, 8192),
                       op.row_scatter_add_plain(idx, ones, 8192))
    x = torch.rand((8, 128), device=cuda_device)
    assert torch.equal(op.smem_probe(x, 227 * 1024), x)
    assert op.smem_limit() == 232448
    with pytest.raises(RuntimeError, match="CUDA error"):
        op.smem_probe(x, 228 * 1024)
