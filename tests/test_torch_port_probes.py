"""CPU checks of the probes P1a (scalar gather), P1f (scatter-add), P1g
(one-hot table gradient) and P1e (sublane gather) of
``instant_nsr_pl_tpu_torch/tools/microbench_gather.py``: their wrappers on
CPU tensors (the plain versions, which the card tests and ``chip_smoke.py``
hold the kernels against) against the JAX package's Pallas probes of
``scripts/microbench_pallas.py`` in interpret mode, on the same numpy inputs.

Tolerances: P1f and P1g sum f32 values in another order than the TPU
kernels (P1f's sequential adds, P1g's one-hot products: f32 accumulation of
bf16-rounded updates), so they agree within 1e-6 x the largest summed
magnitude; P1a and P1e move values and equal the JAX result to the bit."""

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
