"""CPU checks of the probes P1a (scalar gather), P1b (vector gather), P1f
(scatter-add), P1g (one-hot table gradient), P1e (sublane gather) and P2
a / b / c (chunked row sums) of
``instant_nsr_pl_tpu_torch/tools/microbench_gather.py``: their wrappers on
CPU tensors (the plain versions, which the card tests and ``chip_smoke.py``
hold the kernels against) against the JAX package's Pallas probes of
``scripts/microbench_pallas.py`` and ``scripts/microbench_pallas_gather.py``
in interpret mode, on the same numpy inputs; and the P2 kernel's summation
order, emulated in numpy, against the JAX P2 kernels.

Tolerances: P1f, P1g and P2a / P2b sum f32 values in another order than
the TPU kernels (P1f's sequential adds, P1g's one-hot products: f32
accumulation of bf16-rounded updates; P2's running sums against whole-chunk
sums), so they agree within 1e-6 x the largest summed magnitude; P1a, P1b,
P1e and P2c move values and equal the JAX result to the bit, as does the
emulated P2b order."""

import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "microbench_pallas.py"


@pytest.fixture
def probes(monkeypatch):
    """scripts/microbench_pallas.py as a module, its pallas_call in interpret
    mode (the module sets JAX's compilation cache directory when it loads:
    put it back)."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("microbench_pallas_probe", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    orig = module.pl.pallas_call
    monkeypatch.setattr(module.pl, "pallas_call", functools.partial(orig, interpret=True))
    module.orig_pallas_call = orig
    return module


def _onehot_indices(rs, m, rows, kind):
    if kind == "uniform":
        return rs.randint(0, rows, m)
    if kind == "quarter_on_one_row":
        idx = rs.randint(0, rows, m)
        idx[rs.permutation(m)[: m // 4]] = rows // 3
        return idx
    assert kind == "ends"
    return np.where(rs.rand(m) < 0.5, 0, rows - 1)


@pytest.mark.parametrize("m,unroll", [(2048, 1), (2048, 8), (4096, 1), (4096, 8)])
def test_scalar_gather_matches_jax_probe(probes, m, unroll):
    """P1a: out[j] = table[idx[j]] of the (2^19, 2) f32 table against
    pallas_scalar_gather at both unrolls of its bench (M a multiple of its
    2,048-index chunk), equal to the bit; the port's wrapper at the same
    unroll."""
    rs = np.random.RandomState(m + unroll)
    assert probes.T == mb.T and probes.F == mb.F
    table = rs.randn(mb.T, mb.F).astype(np.float32)
    idx = rs.randint(0, mb.T, m).astype(np.int32)
    idx[:2] = [0, mb.T - 1]
    ref = np.asarray(probes.pallas_scalar_gather(idx, table, unroll=unroll))
    got = mb.scalar_gather(torch.from_numpy(idx), torch.from_numpy(table), unroll).numpy()
    assert got.shape == ref.shape == (m, mb.F)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, table[idx])


@pytest.mark.parametrize("m,unroll,kind", [
    (2048, 1, "uniform"), (2048, 8, "uniform"), (4096, 1, "uniform"), (4096, 8, "uniform"),
    (4096, 1, "quarter_on_one_row"), (4096, 8, "quarter_on_one_row")])
def test_scatter_add_matches_jax_probe(probes, m, unroll, kind):
    """P1f: a zeroed (2^19, 2) f32 table with every update row added at its
    index, against pallas_scatter_add (its sums sequential, the port's
    index_add_ on the CPU) at both unrolls, M a multiple of its 2,048-index
    chunk, within 1e-6 x the largest summed magnitude; rows no index touches
    stay 0."""
    rs = np.random.RandomState(3 * m + unroll + len(kind))
    rows = probes.T
    idx = _onehot_indices(rs, m, rows, kind).astype(np.int32)
    upd = (rs.randn(m, mb.F) * 3.0).astype(np.float32)
    ref = np.asarray(probes.pallas_scatter_add(idx, upd, unroll=unroll))
    got = mb.scatter_add(torch.from_numpy(idx), torch.from_numpy(upd)).numpy()
    assert got.shape == ref.shape == (rows, mb.F)
    assert got.dtype == ref.dtype == np.float32
    mag = mb.plain_scatter_add(torch.from_numpy(idx), torch.from_numpy(np.abs(upd))).numpy()
    tol = 1e-6 * float(mag.max())
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= tol, (err, tol)
    touched = np.zeros(rows, bool)
    touched[idx] = True
    assert not got[~touched].any() and not ref[~touched].any()


@pytest.mark.parametrize("m,kind", [(1024, "uniform"), (4096, "uniform"),
                                    (4096, "quarter_on_one_row"), (1024, "ends")])
def test_onehot_grad_matches_jax_probe(probes, m, kind):
    """P1g: the port's (T / 512, 2 * 512) gradient of bf16-rounded updates,
    summed in f32, against pallas_onehot_grad (a multiple of its 1,024-index
    chunk), within 1e-6 x the summed magnitude of each entry's updates."""
    rs = np.random.RandomState(m + len(kind))
    rows = probes.T
    assert rows == mb.T and probes.F == mb.F
    idx = _onehot_indices(rs, m, rows, kind).astype(np.int32)
    wg = (rs.randn(m, mb.F) * 3.0).astype(np.float32)
    ref = np.asarray(probes.pallas_onehot_grad(idx, wg))
    got = mb.onehot_grad(torch.from_numpy(idx), torch.from_numpy(wg)).numpy()
    assert got.shape == ref.shape == (rows // mb.ONEHOT_B, mb.F * mb.ONEHOT_B)
    assert got.dtype == np.float32
    mag = mb.plain_onehot_grad(torch.from_numpy(idx), torch.from_numpy(np.abs(wg))).numpy()
    tol = 1e-6 * float(mag.max())
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= tol, (err, tol)
    # every update landed: the entries the indices touch, and no other
    touched = np.zeros(rows, bool)
    touched[idx] = True
    a, b = np.divmod(np.arange(rows), mb.ONEHOT_B)
    for f in range(mb.F):
        assert not got[a[~touched], f * mb.ONEHOT_B + b[~touched]].any()


def test_sublane_gather_matches_jax_probe(probes, monkeypatch):
    """P1e: out[r, c] = table[idx[r, c], c] of bench_pallas_sublane_gather's
    (512, 128) table at M = 128 x 64, its kernel's inputs and output captured
    from the bench (run eagerly, its timing and report switched off), the
    port's wrapper on the same inputs equal to the bit."""
    seen = []

    def recording(*args, **kwargs):
        call = probes.orig_pallas_call(*args, **{**kwargs, "interpret": True})

        def run(*operands):
            out = call(*operands)
            seen.append(([np.array(o) for o in operands], np.array(out)))
            return out

        return run

    monkeypatch.setattr(probes.pl, "pallas_call", recording)
    monkeypatch.setattr(probes, "timeit_rep", lambda *args, **kwargs: 1.0)
    monkeypatch.setattr(probes, "report", lambda *args, **kwargs: None)
    with jax.disable_jit():
        probes.bench_pallas_sublane_gather(128 * 64)
    assert len(seen) == 1, "the sublane-gather bench did not reach its pallas_call"
    (idx, table), ref = seen[0]
    assert idx.shape == (64, 128) and table.shape == (mb.SUB_ROWS, 128)
    got = mb.sublane_gather(torch.from_numpy(idx), torch.from_numpy(table)).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, table[idx, np.arange(128)[None, :]])


GATHER_SCRIPT = SCRIPT.parent / "microbench_pallas_gather.py"


@pytest.fixture
def gather_probes(monkeypatch):
    """scripts/microbench_pallas_gather.py as a module, its pallas_call in
    interpret mode and its M cut to 2 x 4,096 (the module sets JAX's
    compilation cache directory when it loads: put it back)."""
    cache_dir = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("microbench_pallas_gather_probe",
                                                  GATHER_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    monkeypatch.setattr(module.pl, "pallas_call",
                        functools.partial(module.pl.pallas_call, interpret=True))
    monkeypatch.setattr(module, "M", 2 * module.CHUNK)
    return module


def _p2_inputs(rs, m, kind="uniform"):
    table = rs.randn(mb.P2_T, 128).astype(np.float32)
    if kind == "uniform":
        idx = rs.randint(0, mb.P2_T, m)
        idx[:2] = [0, mb.P2_T - 1]
    else:  # "ends": rows 0 and 8,191 only
        idx = np.where(rs.rand(m) < 0.5, 0, mb.P2_T - 1)
    return idx.astype(np.int32), table


def _p2_tol(idx, table, variant, kind="uniform"):
    """1e-6 x the largest summed magnitude of the variant's sums; on the
    first and last rows only (``ends``: two values repeated, whose rounding
    errors do not cancel) the first-order bound of the TPU kernel's own f32
    running sum instead, 4,096 (P2a) or 512 (P2b) adds x 2^-24."""
    mag = mb.plain_chunk_row_sum(torch.from_numpy(idx), torch.from_numpy(np.abs(table)),
                                 variant).numpy()
    rel = 1e-6 if kind == "uniform" else (mb.P2_CHUNK >> (3 * variant)) * 2.0 ** -24
    return rel * float(mag.max())


@pytest.mark.parametrize("kind", ["uniform", "ends"])
def test_chunk_row_sum_matches_jax_probe(gather_probes, kind):
    """P2 a / b / c: the port's wrapper on CPU tensors (the plain versions)
    against make_pallas(kernel_a | kernel_b | kernel_c) of
    scripts/microbench_pallas_gather.py at M = 2 x 4,096 on the same numpy
    inputs: P2c (the chunk's last 8 rows) equal to the bit, P2a / P2b (f32
    sums in another order than the TPU kernels' running sums) within 1e-6 x
    the largest summed magnitude on random rows (on the first and last rows
    only, within the TPU kernels' own running-sum bound: ``_p2_tol``)."""
    rs = np.random.RandomState(21 + len(kind))
    assert (gather_probes.T, gather_probes.CHUNK) == (mb.P2_T, mb.P2_CHUNK)
    idx, table = _p2_inputs(rs, gather_probes.M, kind)
    for variant, kernel in enumerate((gather_probes.kernel_a, gather_probes.kernel_b,
                                      gather_probes.kernel_c)):
        ref = np.asarray(gather_probes.make_pallas(kernel)(idx, table))
        got = mb.chunk_row_sum(torch.from_numpy(idx), torch.from_numpy(table), variant).numpy()
        assert got.shape == ref.shape == (2 * 8, 128) and got.dtype == np.float32
        if variant == 2:
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, table[idx.reshape(2, -1)[:, -8:].reshape(-1)])
        else:
            err = float(np.abs(got.astype(np.float64) - ref).max())
            assert err <= _p2_tol(idx, table, variant, kind), (variant, err)


@pytest.mark.parametrize("chunks", [1, 2])
def test_chunk_row_sum_emulated_order_matches_jax_probe(gather_probes, monkeypatch, chunks):
    """The summation order of csrc/gather_probes.cu chunk_slab_sum, emulated
    in numpy (tools/microbench_gather.py chunk_row_sum_emulated: 4-column
    slabs, lane groups (i mod 8, column), the xor fold of P2a), against the
    JAX kernels in interpret mode at one and two chunks: P2b's eight running
    sums are the TPU kernel's own, equal to kernel_b to the bit; P2a folds
    them, within 1e-6 x the summed magnitude of kernel_a's single running
    sum, and equals the fold of kernel_b's rows to the bit."""
    monkeypatch.setattr(gather_probes, "M", chunks * gather_probes.CHUNK)
    idx, table = _p2_inputs(np.random.RandomState(30 + chunks), gather_probes.M)
    ref_b = np.asarray(gather_probes.make_pallas(gather_probes.kernel_b)(idx, table))
    ref_a = np.asarray(gather_probes.make_pallas(gather_probes.kernel_a)(idx, table))
    emu_b = mb.chunk_row_sum_emulated(idx, table, 1)
    emu_a = mb.chunk_row_sum_emulated(idx, table, 0)
    assert emu_b.shape == emu_a.shape == ref_b.shape == (chunks * 8, 128)
    np.testing.assert_array_equal(emu_b, ref_b)
    err = float(np.abs(emu_a.astype(np.float64) - ref_a).max())
    assert 0 < err <= _p2_tol(idx, table, 0), err  # another order than kernel_a's
    r = ref_b.reshape(chunks, 8, 128)
    h = r[:, :4] + r[:, 4:]
    folded = (h[:, 0] + h[:, 2]) + (h[:, 1] + h[:, 3])
    np.testing.assert_array_equal(emu_a.reshape(chunks, 8, 128),
                                  np.broadcast_to(folded[:, None], (chunks, 8, 128)))


def test_vector_gather_matches_jax_probe(probes, monkeypatch):
    """P1b: out[j] = table[idx[j]] of bench_pallas_vector_gather's (2^19, 2)
    table at M = 8,192 (one of its chunks), its kernel's inputs and output
    captured from the bench (run eagerly in interpret mode, its timing and
    report switched off), the port's wrapper on the same inputs equal to the
    bit."""
    seen = []

    def recording(*args, **kwargs):
        call = probes.orig_pallas_call(*args, **{**kwargs, "interpret": True})

        def run(*operands):
            out = call(*operands)
            seen.append(([np.array(o) for o in operands], np.array(out)))
            return out

        return run

    monkeypatch.setattr(probes.pl, "pallas_call", recording)
    monkeypatch.setattr(probes, "timeit_rep", lambda *args, **kwargs: 1.0)
    monkeypatch.setattr(probes, "report", lambda *args, **kwargs: None)
    with jax.disable_jit():
        probes.bench_pallas_vector_gather(8192)
    assert seen, "the vector-gather bench did not reach its pallas_call"
    (idx, table), ref = seen[0]
    assert idx.shape == (8192,) and table.shape == (mb.T, mb.F)
    got = mb.vector_gather(torch.from_numpy(idx), torch.from_numpy(table)).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, table[idx])
