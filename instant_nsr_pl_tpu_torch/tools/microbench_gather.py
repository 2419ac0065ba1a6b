"""Gather and scatter probes of the hash grid's memory patterns on the card:
P1a-P1g and P2, the CUDA counterparts of the JAX package's Pallas probes
(``scripts/microbench_pallas.py``, ``scripts/microbench_pallas_gather.py``).

    python -m instant_nsr_pl_tpu_torch.tools.microbench_gather [--quick] [--only A,B]
        [--experiments] [--parent DIR] [--out result.json]

Each probe is a kernel of ``csrc/gather_probes.cu`` behind a wrapper here
(launch count on the wrapper, the plain PyTorch version on CPU tensors). The
script builds them, checks each against the numpy result the JAX script
checks, then times each beside its plain version and the one PyTorch call
that computes the same function: warm, ``ms`` (CUDA-event median of 20
batches of 10 back-to-back launches on the same inputs, part of which stay
in L2), and for kernel and library call also cold, ``ms_cold`` (median of
50 single launches, each after a flush of the L2), at the JAX scripts'
sizes: M = 2^22 indices for P1 (2^20 with ``--quick``) into a (2^19, 2)
table, 2^20 row reads of an (8192, 128) table for P2. It prints ms and ns
per index for each, the least time the card could take for the data it
moved (``bound_ms``), and one JSON line ``{"probes": [...], "card": ...}``
(also written to ``--out``). ``--only`` runs the named probes alone (names
as in that line); ``--experiments`` adds the cost of P2's bank conflicts
and P1b beside P1a unroll 8 (:func:`experiments`). It needs a CUDA card.

``--parent DIR`` compares with another commit's designs: unpack its ``git
archive`` into DIR (e.g. the git-ignored ``_parent/``); the module is then
run from DIR and from this checkout in turns, parent, change, change,
parent (:func:`turns`), and the JSON line is ``{"turns": {...}, "card":
...}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops import cuda_build

T = 1 << 19  # hash table rows per level (scripts/microbench_pallas.py:28)
F = 2
SUB_ROWS = 512
ONEHOT_B = 512
P2_T = 8192  # scripts/microbench_pallas_gather.py:30-32
P2_M = 1 << 20
P2_CHUNK = 4096
P2_SLAB_COLS = 4  # columns of a block's table slab (csrc/gather_probes.cu kP2SlabCols)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SOURCE = "instant_nsr_pl_tpu_torch/csrc/gather_probes.cu"
P1 = "scripts/microbench_pallas.py"
P2 = "scripts/microbench_pallas_gather.py"


def _launch(name, argtypes, *args):
    """Call entry point ``name`` with ``args`` and the current stream."""
    fn = cuda_build.entry("gather_probes", name, [*argtypes, ctypes.c_void_p])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, name, "the shapes of tools/microbench_gather.py, operands "
                     "16-byte aligned")


_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _check_index(idx, *tensors):
    """Contiguous int32 indices; float32 operands, contiguous, on the
    indices' device. The indices' range is the caller's to keep (a min/max
    reduction per launch would be timed with the kernel): make_inputs draws
    them in range."""
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("probe indices must be contiguous int32")
    for t in tensors:
        if t.device != idx.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"probe operand {tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"contiguous float32 on {idx.device} expected")


# ---------------------------------------------------------------------------
# the probes: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------


def plain_gather(idx, table):
    return table[idx.long()]


def plain_lane_gather(idx, table):
    return table[0][idx.long()]


def plain_sublane_gather(idx, table):
    return torch.gather(table, 0, idx.long())


def plain_scatter_add(idx, upd, rows=T):
    out = torch.zeros((rows, upd.shape[1]), dtype=torch.float32, device=idx.device)
    return out.index_add_(0, idx.long(), upd)


def plain_onehot_grad(idx, wg, rows=T):
    a_dim = rows // ONEHOT_B
    flat = plain_scatter_add(idx, wg.to(torch.bfloat16).float(), rows)
    return flat.reshape(a_dim, ONEHOT_B, F).permute(0, 2, 1).reshape(a_dim, F * ONEHOT_B)


def plain_chunk_row_sum(idx, table, variant):
    if variant == 2:  # only the chunk's last 8 rows survive its store walk
        return table[idx.view(-1, P2_CHUNK)[:, -8:].reshape(-1).long()]
    rows = table[idx.long()].view(-1, P2_CHUNK, 128)
    if variant == 0:
        return rows.sum(1, keepdim=True).expand(-1, 8, -1).reshape(-1, 128)
    return rows.view(rows.shape[0], P2_CHUNK // 8, 8, 128).sum(1).reshape(-1, 128)


def chunk_row_sum_emulated(idx: np.ndarray, table: np.ndarray, variant: int) -> np.ndarray:
    """P2a / P2b in the order of ``csrc/gather_probes.cu`` chunk_slab_sum,
    in numpy float32: each 4-column slab s of the table (32 of them, a block
    each) and, for each chunk, the lane groups (j, c) = (i mod 8, column): the
    group j accumulator starts at 0 and adds row idx[i], i = j, j + 8, ...,
    in the order of i (the TPU kernel's P2b order), one float32 add at a
    time; P2a then folds the eight as the warp's xor 16, 8, 4 shuffles do,
    ((a0 + a4) + (a2 + a6)) + ((a1 + a5) + (a3 + a7)), into each of the
    chunk's 8 output rows. Columns do not mix, so the slabs are computed
    side by side."""
    table = np.asarray(table, np.float32)
    steps = np.asarray(idx).reshape(-1, P2_CHUNK // 8, 8)  # (chunk, step, j)
    out = np.empty((steps.shape[0], 8, table.shape[1]), np.float32)
    for s in range(0, table.shape[1], P2_SLAB_COLS):
        slab = table[:, s:s + P2_SLAB_COLS]
        acc = np.zeros((steps.shape[0], 8, P2_SLAB_COLS), np.float32)
        for k in range(steps.shape[1]):
            acc += slab[steps[:, k]]
        if variant == 0:
            half = acc[:, :4] + acc[:, 4:]  # xor 16: j and j ^ 4
            quarter = half[:, :2] + half[:, 2:]  # xor 8: j and j ^ 2
            acc = np.broadcast_to(quarter[:, :1] + quarter[:, 1:], acc.shape)  # xor 4
        out[:, :, s:s + P2_SLAB_COLS] = acc
    return out.reshape(-1, table.shape[1])


def p2_row_wavefronts(idx: np.ndarray) -> float:
    """Shared-memory wavefronts of chunk_slab_sum's row reads per warp step,
    on average over ``idx``: a step reads 8 rows (i mod 8 = 0..7) x 4
    columns, a row's 4 words on the 4-bank group row mod 8, so a step takes
    as many wavefronts as the most distinct rows that share a group (equal
    rows are one broadcast)."""
    steps = np.asarray(idx).reshape(-1, 8)
    srt = np.sort(steps, axis=1)
    first = np.ones(srt.shape, bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]  # each distinct row once
    group = np.where(first, srt % 8, 8)  # 8: a repeated row, no group
    counts = np.zeros((len(steps), 9), np.int64)
    np.add.at(counts, (np.arange(len(steps))[:, None], group), 1)
    return float(counts[:, :8].max(1).mean())


def scalar_gather(idx, table, unroll=1):
    """P1a: out[j] = table[idx[j]], (M,) int32 into a (T, 2) float32 table."""
    if idx.device.type == "cpu":
        return plain_gather(idx, table)
    _check_index(idx, table)
    out = torch.empty((idx.numel(), table.shape[1]), dtype=table.dtype, device=idx.device)
    _launch("probe_scalar_gather", [_P, _L, _P, _P, _I], idx.data_ptr(), idx.numel(),
            table.data_ptr(), out.data_ptr(), unroll)
    scalar_gather.launches[unroll] += 1
    return out


scalar_gather.launches = {1: 0, 8: 0}


def vector_gather(idx, table):
    """P1b: the same gather, one block per 8,192-index chunk."""
    if idx.device.type == "cpu":
        return plain_gather(idx, table)
    _check_index(idx, table)
    out = torch.empty((idx.numel(), table.shape[1]), dtype=table.dtype, device=idx.device)
    _launch("probe_vector_gather", [_P, _L, _P, _P], idx.data_ptr(), idx.numel(),
            table.data_ptr(), out.data_ptr())
    vector_gather.launches += 1
    return out


vector_gather.launches = 0


def row_gather(idx, table):
    """P1c: whole 128-wide rows, out[j] = table[idx[j]] of a (T, 128) table."""
    if idx.device.type == "cpu":
        return plain_gather(idx, table)
    _check_index(idx, table)
    if table.shape[1] != 128:
        raise ValueError("row_gather: the table is (T, 128)")
    out = torch.empty((idx.numel(), 128), dtype=table.dtype, device=idx.device)
    _launch("probe_row_gather", [_P, _L, _P, _P], idx.data_ptr(), idx.numel(),
            table.data_ptr(), out.data_ptr())
    row_gather.launches += 1
    return out


row_gather.launches = 0


def lane_gather(idx, table):
    """P1d: out = table[0][idx] for (rows, 128) indices into 128 entries."""
    if idx.device.type == "cpu":
        return plain_lane_gather(idx, table)
    _check_index(idx, table)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _launch("probe_lane_gather", [_P, _L, _P, _P], idx.data_ptr(), idx.numel(),
            table.data_ptr(), out.data_ptr())
    lane_gather.launches += 1
    return out


lane_gather.launches = 0


def sublane_gather(idx, table):
    """P1e: out[r, c] = table[idx[r, c], c] of a (512, 128) table."""
    if idx.device.type == "cpu":
        return plain_sublane_gather(idx, table)
    _check_index(idx, table)
    if tuple(table.shape) != (SUB_ROWS, 128) or idx.shape[1] != 128:
        raise ValueError("sublane_gather: a (512, 128) table and (rows, 128) indices")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.shape[0] == 0:
        return out
    _launch("probe_sublane_gather", [_P, _L, _P, _P], idx.data_ptr(), idx.shape[0],
            table.data_ptr(), out.data_ptr())
    sublane_gather.launches += 1
    return out


sublane_gather.launches = 0


def scatter_add(idx, upd, rows=T):
    """P1f: a zeroed (rows, 2) table with every update row added at idx."""
    if idx.device.type == "cpu":
        return plain_scatter_add(idx, upd, rows)
    _check_index(idx, upd)
    if tuple(upd.shape) != (idx.numel(), F):
        raise ValueError(f"scatter_add: ({idx.numel()}, {F}) updates expected, got "
                         f"{tuple(upd.shape)}")
    # zeroed here, inside the timed call, as the index_add_ yardstick's table is
    out = torch.zeros((rows, F), dtype=torch.float32, device=idx.device)
    _launch("probe_scatter_add", [_P, _L, _P, _P], idx.data_ptr(), idx.numel(),
            upd.data_ptr(), out.data_ptr())
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


def onehot_grad(idx, wg, rows=T):
    """P1g: the (rows / 512, 512 * 2) one-hot gradient U^T (W * g): update j
    adds bf16(wg[j, f]) at [idx // 512, f * 512 + idx % 512], sums in f32."""
    a_dim = rows // ONEHOT_B
    if idx.device.type == "cpu":
        return plain_onehot_grad(idx, wg, rows)
    _check_index(idx, wg)
    if rows % ONEHOT_B or tuple(wg.shape) != (idx.numel(), F):
        raise ValueError(f"onehot_grad: rows a multiple of {ONEHOT_B} and ({idx.numel()}, {F}) "
                         f"updates expected, got rows={rows}, {tuple(wg.shape)}")
    out = torch.empty((a_dim, F * ONEHOT_B), dtype=torch.float32, device=idx.device)
    scratch = torch.zeros((rows, F), dtype=torch.float32, device=idx.device)
    _launch("probe_onehot_grad", [_P, _L, _P, _I, _P, _P], idx.data_ptr(), idx.numel(),
            wg.data_ptr(), rows, out.data_ptr(), scratch.data_ptr())
    onehot_grad.launches += 1
    return out


onehot_grad.launches = 0


def chunk_row_sum(idx, table, variant):
    """P2: (M / 4096 * 8, 128) from M row reads of a (T, 128) table (T <=
    8,192) in 4,096-index chunks: variant 0 the chunk's sum in each of its 8
    rows, 1 row j the sum over indices i = j mod 8, 2 the chunk's last 8
    rows."""
    m = idx.numel()
    if idx.device.type == "cpu":
        return plain_chunk_row_sum(idx, table, variant)
    _check_index(idx, table)
    if table.shape[1] != 128 or m % P2_CHUNK:
        raise ValueError(f"chunk_row_sum: a (T, 128) table and a multiple of {P2_CHUNK} "
                         f"indices, got {tuple(table.shape)} and {m}")
    out = torch.empty((m // P2_CHUNK * 8, 128), dtype=torch.float32, device=idx.device)
    _launch("probe_chunk_row_sum", [_P, _L, _P, _I, _P, _I], idx.data_ptr(), m,
            table.data_ptr(), table.shape[0], out.data_ptr(), variant)
    chunk_row_sum.launches[variant] += 1
    return out


chunk_row_sum.launches = {0: 0, 1: 0, 2: 0}


P2_NAMES = ("P2a_one_accumulator", "P2b_eight_accumulators", "P2c_rows_to_scratch")


def reset_launches():
    scalar_gather.launches = {1: 0, 8: 0}
    chunk_row_sum.launches = {0: 0, 1: 0, 2: 0}
    for fn in (vector_gather, row_gather, lane_gather, sublane_gather, scatter_add,
               onehot_grad):
        fn.launches = 0


def launch_counts() -> dict:
    """Launches per probe name, as the ``probes`` entries name them."""
    return {"P1a_scalar_gather_unroll1": scalar_gather.launches[1],
            "P1a_scalar_gather_unroll8": scalar_gather.launches[8],
            "P1b_vector_gather": vector_gather.launches,
            "P1c_row_gather": row_gather.launches,
            "P1d_lane_gather": lane_gather.launches,
            "P1e_sublane_gather": sublane_gather.launches,
            "P1f_scatter_add": scatter_add.launches,
            "P1g_onehot_grad": onehot_grad.launches,
            "P2a_one_accumulator": chunk_row_sum.launches[0],
            "P2b_eight_accumulators": chunk_row_sum.launches[1],
            "P2c_rows_to_scratch": chunk_row_sum.launches[2]}


# ---------------------------------------------------------------------------
# inputs, numpy references, timing
# ---------------------------------------------------------------------------


def make_inputs(m_p1: int, m_p2: int, seed: int = 0) -> dict:
    """Seeded numpy inputs of every probe (the JAX scripts' shapes)."""
    rs = np.random.RandomState(seed)
    return {
        "table": rs.randn(T, F).astype(np.float32),
        "idx": rs.randint(0, T, m_p1).astype(np.int32),
        "upd": rs.randn(m_p1, F).astype(np.float32),
        "table128": rs.randn(T, 128).astype(np.float32),
        "lut": rs.randn(8, 128).astype(np.float32),
        "lane_idx": rs.randint(0, 128, (m_p1 // 128, 128)).astype(np.int32),
        "sub_table": rs.randn(SUB_ROWS, 128).astype(np.float32),
        "sub_idx": rs.randint(0, SUB_ROWS, (m_p1 // 128, 128)).astype(np.int32),
        "p2_table": rs.randn(P2_T, 128).astype(np.float32),
        "p2_idx": rs.randint(0, P2_T, m_p2).astype(np.int32),
    }


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def numpy_reference(name: str, x: dict) -> np.ndarray:
    """The result the JAX script checks each probe against, in numpy."""
    if name in ("P1a_scalar_gather_unroll1", "P1a_scalar_gather_unroll8", "P1b_vector_gather"):
        return x["table"][x["idx"]]
    if name == "P1c_row_gather":
        return x["table128"][x["idx"]]
    if name == "P1d_lane_gather":
        return x["lut"][0][x["lane_idx"]]
    if name == "P1e_sublane_gather":
        return x["sub_table"][x["sub_idx"], np.arange(128)[None, :]]
    if name in ("P1f_scatter_add", "P1g_onehot_grad"):
        upd = x["upd"] if name == "P1f_scatter_add" else _bf16(x["upd"])
        out = np.zeros((T, F), np.float64)
        np.add.at(out, x["idx"], upd.astype(np.float64))
        if name == "P1f_scatter_add":
            return out
        a = T // ONEHOT_B
        return out.reshape(a, ONEHOT_B, F).transpose(0, 2, 1).reshape(a, F * ONEHOT_B)
    rows = x["p2_table"][x["p2_idx"]].astype(np.float64)
    rows = rows.reshape(-1, P2_CHUNK, 128)
    if name == "P2a_one_accumulator":
        return np.repeat(rows.sum(1, keepdims=True), 8, axis=1).reshape(-1, 128)
    if name == "P2b_eight_accumulators":
        return rows.reshape(rows.shape[0], P2_CHUNK // 8, 8, 128).sum(1).reshape(-1, 128)
    return rows[:, -8:].reshape(-1, 128)


# per probe: (replaces, kernel call, library call, the data it must move in
# bytes, its tolerance against numpy: 0 = exact, else relative to the summed
# magnitudes of a sum)
def probe_specs(d: dict) -> dict:
    """The probes on device tensors ``d`` (from :func:`make_inputs`)."""
    m = d["idx"].numel()
    uniq = int(torch.unique(d["idx"]).numel())
    p2_uniq = int(torch.unique(d["p2_idx"]).numel())
    m2 = d["p2_idx"].numel()
    idx_l = d["idx"].long()
    p2_l = d["p2_idx"].long()
    p2_last = d["p2_idx"].view(-1, P2_CHUNK)[:, -8:].reshape(-1)  # what P2c reads
    last_uniq = int(torch.unique(p2_last).numel())
    p2_out = m2 // P2_CHUNK * 8 * 512
    return {
        "P1a_scalar_gather_unroll1": (
            f"{P1}:156", lambda: scalar_gather(d["idx"], d["table"], 1),
            lambda: d["table"][idx_l], "table[idx]", m * 4 + uniq * 8 + m * 8, m, 0.0),
        "P1a_scalar_gather_unroll8": (
            f"{P1}:156", lambda: scalar_gather(d["idx"], d["table"], 8),
            lambda: d["table"][idx_l], "table[idx]", m * 4 + uniq * 8 + m * 8, m, 0.0),
        "P1b_vector_gather": (
            f"{P1}:201", lambda: vector_gather(d["idx"], d["table"]),
            lambda: torch.index_select(d["table"], 0, d["idx"]), "torch.index_select",
            m * 4 + uniq * 8 + m * 8, m, 0.0),
        "P1c_row_gather": (
            f"{P1}:237", lambda: row_gather(d["idx"], d["table128"]),
            lambda: torch.index_select(d["table128"], 0, d["idx"]),
            "torch.index_select(dim=0)", m * 4 + uniq * 512 + m * 512, m, 0.0),
        "P1d_lane_gather": (
            f"{P1}:273", lambda: lane_gather(d["lane_idx"], d["lut"]),
            lambda: d["lut"][0][d["lane_idx"].long()], "lut[idx]",
            d["lane_idx"].numel() * 8 + 512, d["lane_idx"].numel(), 0.0),
        "P1e_sublane_gather": (
            f"{P1}:311", lambda: sublane_gather(d["sub_idx"], d["sub_table"]),
            lambda: torch.gather(d["sub_table"], 0, d["sub_idx"].long()),
            "torch.gather(dim=0)", d["sub_idx"].numel() * 8 + SUB_ROWS * 128 * 4,
            d["sub_idx"].numel(), 0.0),
        "P1f_scatter_add": (
            f"{P1}:359", lambda: scatter_add(d["idx"], d["upd"]),
            lambda: torch.zeros((T, F), device=d["idx"].device).index_add_(0, idx_l, d["upd"]),
            "index_add_", m * 4 + m * 8 + T * 8, m, 1e-6),
        "P1g_onehot_grad": (
            f"{P1}:419", lambda: onehot_grad(d["idx"], d["upd"]),
            lambda: torch.zeros((T, F), device=d["idx"].device).index_add_(0, idx_l, d["upd"]),
            "index_add_", m * 4 + m * 8 + T * 8, m, 1e-6),
        "P2a_one_accumulator": (
            f"{P2}:85", lambda: chunk_row_sum(d["p2_idx"], d["p2_table"], 0),
            lambda: torch.index_select(d["p2_table"], 0, p2_l).view(-1, P2_CHUNK, 128).sum(1),
            "index_select(...).view(256, 4096, 128).sum(1)",
            m2 * 4 + p2_uniq * 512 + p2_out, m2, 1e-6),
        "P2b_eight_accumulators": (
            f"{P2}:85", lambda: chunk_row_sum(d["p2_idx"], d["p2_table"], 1),
            lambda: torch.index_select(d["p2_table"], 0, p2_l).view(
                -1, P2_CHUNK // 8, 8, 128).sum(1),
            "index_select(...).view(256, 512, 8, 128).sum(1)",
            m2 * 4 + p2_uniq * 512 + p2_out, m2, 1e-6),
        # the bytes of what the output depends on: each chunk's last 8 indices
        # and their distinct rows, and the output
        "P2c_rows_to_scratch": (
            f"{P2}:85", lambda: chunk_row_sum(d["p2_idx"], d["p2_table"], 2),
            lambda: torch.index_select(d["p2_table"], 0, p2_last),
            "index_select(table, 0, last 8 indices of each chunk)",
            p2_last.numel() * 4 + last_uniq * 512 + p2_out, m2, 0.0),
    }


def plain_of(name: str, d: dict):
    """Probe ``name``'s plain PyTorch version on the inputs ``d`` (on any
    device: on the CPU it is what the wrapper runs)."""
    return {
        "P1b_vector_gather": lambda: plain_gather(d["idx"], d["table"]),
        "P1c_row_gather": lambda: plain_gather(d["idx"], d["table128"]),
        "P1d_lane_gather": lambda: plain_lane_gather(d["lane_idx"], d["lut"]),
        "P1e_sublane_gather": lambda: plain_sublane_gather(d["sub_idx"], d["sub_table"]),
        "P1f_scatter_add": lambda: plain_scatter_add(d["idx"], d["upd"]),
        "P1g_onehot_grad": lambda: plain_onehot_grad(d["idx"], d["upd"]),
        "P2a_one_accumulator": lambda: plain_chunk_row_sum(d["p2_idx"], d["p2_table"], 0),
        "P2b_eight_accumulators": lambda: plain_chunk_row_sum(d["p2_idx"], d["p2_table"], 1),
        "P2c_rows_to_scratch": lambda: plain_chunk_row_sum(d["p2_idx"], d["p2_table"], 2),
    }.get(name, lambda: plain_gather(d["idx"], d["table"]))()


def check(name: str, got: np.ndarray, x: dict, rel: float, ref=None) -> float:
    """max |got - ref| for probe ``name`` (ref: the numpy result by default);
    raises beyond its tolerance: exact for gathers, ``rel`` x the largest
    summed magnitude for the sums (their order differs: atomics, or one
    running sum)."""
    ref = numpy_reference(name, x) if ref is None else ref
    if not rel:  # a gather: equal to the bit (compared in its own type)
        err = float(np.abs(got - ref.astype(got.dtype)).max()) if got.size else 0.0
        if not err == 0.0:
            raise AssertionError(f"{name}: max|kernel - reference| = {err:.3e}, not 0")
        return err
    err = float(np.abs(got.astype(np.float64) - ref).max())
    tol = 0.0
    if rel:
        mag = numpy_reference(name, {**x, **{k: np.abs(x[k]) for k in ("upd", "p2_table")
                                             if k in x}})
        tol = rel * float(np.abs(mag).max()) + 1e-6
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"{name}: max|kernel - reference| = {err:.3e} beyond {tol:.3e}")
    return err


QUEUE_CYCLES = 4_000_000  # ~2 ms of the card's clock: longer than queuing a batch


def time_ms(fn, reps=20, inner=10, warmup=3):
    """CUDA-event median over ``reps`` batches of ``inner`` calls, per call.
    Each batch is queued behind a spin kernel, so the events time the
    card's work and not the host's launch cost (which is of the order of a
    short probe's time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


FLUSH_BYTES = 128 << 20  # more than twice the card's 50 MB L2


def time_cold_ms(fn, reps=50, batch=10, warmup=3):
    """CUDA-event median over ``reps`` single calls, each with nothing of its
    operands left in L2: before each call, outside its events, a write of
    FLUSH_BYTES to a scratch buffer and then a read of it (the read writes
    the flush's dirty lines back, so that the timed call does not). Batches
    of ``batch`` calls are queued behind a spin kernel, as in
    :func:`time_ms`."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for start in range(0, reps, batch):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(min(batch, reps - start))]
        torch.cuda._sleep(QUEUE_CYCLES)
        for a, b in events:
            flush.fill_(1.0)
            flush.sum()
            a.record()
            fn()
            b.record()
        events[-1][1].synchronize()
        times += [a.elapsed_time(b) for a, b in events]
    return statistics.median(times)


def to_device(x: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def check_all(m_p1: int, m_p2: int, device, seed: int = 0) -> dict:
    """Every probe once on the card at these sizes, against numpy and
    against its plain version on the CPU; returns the max abs error against
    numpy per probe."""
    x = make_inputs(m_p1, m_p2, seed)
    d = to_device(x, device)
    c = to_device(x, "cpu")
    errs = {}
    for name, spec in probe_specs(d).items():
        got = spec[1]()
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        errs[name] = check(name, got, x, spec[-1])
        check(name, got, x, spec[-1], ref=plain_of(name, c).double().numpy())
    return errs


def _check_sum(label, got, ref, mag):
    """max |got - ref| of a scatter's sums; raises beyond 1e-6 x the largest
    summed magnitude (+1e-6)."""
    err = float((got.cpu().double() - ref.double()).abs().max())
    tol = 1e-6 * float(mag.max()) + 1e-6
    if not err <= tol:
        raise AssertionError(f"{label}: max|kernel - plain| = {err:.3e} beyond {tol:.3e}")
    return err


def check_edges(device, seed: int = 0) -> dict:
    """The scatters P1f and P1g with every index on one row (their atomics
    all on one address) into a (1536, 2) table, P1a unroll 8 on a ragged
    2,053 indices (not a multiple of 4, 8 or 256) and P1e on a ragged 37
    rows, each against its plain version on the CPU (the scatters within 1e-6
    x the summed magnitude, the gathers to the bit); returns the max abs
    error of each."""
    rs = np.random.RandomState(seed)
    rows, m = 3 * ONEHOT_B, 5003
    idx = torch.from_numpy(np.full(m, rows - 5, np.int32))
    upd = torch.from_numpy((rs.randn(m, F) * 3.0).astype(np.float32))
    errs = {}
    for name, fn, plain in (("P1f_scatter_add", scatter_add, plain_scatter_add),
                            ("P1g_onehot_grad", onehot_grad, plain_onehot_grad)):
        got = fn(idx.to(device), upd.to(device), rows)
        errs[name] = _check_sum(f"{name}, all indices equal", got, plain(idx, upd, rows),
                                plain(idx, upd.abs(), rows))
    sidx = rs.randint(0, SUB_ROWS, (37, 128)).astype(np.int32)
    table = rs.randn(SUB_ROWS, 128).astype(np.float32)
    got = sublane_gather(torch.from_numpy(sidx).to(device), torch.from_numpy(table).to(device))
    errs["P1e_sublane_gather"] = float((got.cpu() - plain_sublane_gather(
        torch.from_numpy(sidx), torch.from_numpy(table))).abs().max())
    gidx = torch.from_numpy(rs.randint(0, T, 2053).astype(np.int32))
    table = torch.from_numpy(rs.randn(T, F).astype(np.float32))
    got = scalar_gather(gidx.to(device), table.to(device), 8)
    errs["P1a_scalar_gather_unroll8"] = float((got.cpu() - plain_gather(gidx, table)).abs().max())
    vidx = torch.from_numpy(rs.randint(0, T, 3 * 8192 + 1001).astype(np.int32))
    got = vector_gather(vidx.to(device), table.to(device))
    errs["P1b_vector_gather"] = float((got.cpu() - plain_gather(vidx, table)).abs().max())
    for name in ("P1a_scalar_gather_unroll8", "P1e_sublane_gather", "P1b_vector_gather"):
        if not errs[name] == 0.0:
            raise AssertionError(f"{name}, ragged: max|kernel - plain| = {errs[name]:.3e}, not 0")
    for name, err in check_p2_edges(device, seed).items():
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def p2_edge_indices(kind: str, rs) -> np.ndarray:
    """Indices of a P2 edge case: ``one_chunk`` (4,096 random), ``one_row``
    (every index on one row: one broadcast a step), ``ends`` (rows 0 and
    8,191 only), ``one_bank_group`` (rows of one 4-bank group, row mod 8 =
    3: 8 wavefronts a step, the most) and ``five_chunks`` (random; ranges
    that do not split evenly over the warps)."""
    if kind == "one_chunk":
        return rs.randint(0, P2_T, P2_CHUNK).astype(np.int32)
    n = 5 * P2_CHUNK if kind == "five_chunks" else 2 * P2_CHUNK
    if kind == "one_row":
        return np.full(n, 4321, np.int32)
    if kind == "ends":
        return np.where(rs.rand(n) < 0.5, 0, P2_T - 1).astype(np.int32)
    if kind == "one_bank_group":
        return (rs.randint(0, P2_T // 8, n) * 8 + 3).astype(np.int32)
    if kind != "five_chunks":
        raise ValueError(f"unknown P2 edge case {kind!r}; known: {P2_EDGES}")
    return rs.randint(0, P2_T, n).astype(np.int32)


P2_EDGES = ("one_chunk", "one_row", "ends", "one_bank_group", "five_chunks")


# the first-order error bound of a float32 sum along chunk_slab_sum's
# longest chain (512 sequential adds of a lane group, 3 of the fold),
# relative to the summed magnitude: what the kernel's order (and the TPU
# kernel's) may differ from the float64 sum by where rounding errors do not
# cancel, as on one row repeated 4,096 times (5.7e-6 there)
P2_F32_SUM_BOUND = (P2_CHUNK // 8 + 3) * 2.0 ** -24


def check_p2(idx: np.ndarray, table: np.ndarray, device, label="") -> dict:
    """P2a / P2b / P2c on the card: P2a / P2b to the bit against
    :func:`chunk_row_sum_emulated` (the kernel's order) and within
    P2_F32_SUM_BOUND x the summed magnitude of the float64 sum, P2c to the
    bit against numpy; returns the max abs error against numpy of each."""
    x = {"p2_idx": idx, "p2_table": table}
    di, dt = torch.from_numpy(idx).to(device), torch.from_numpy(table).to(device)
    errs = {}
    for variant, name in enumerate(P2_NAMES):
        got = chunk_row_sum(di, dt, variant).cpu().numpy()
        errs[name] = check(name, got, x, 0.0 if variant == 2 else P2_F32_SUM_BOUND)
        if variant < 2:
            want = chunk_row_sum_emulated(idx, table, variant)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{name}{label}: differs from the emulated order by "
                    f"{np.abs(got.astype(np.float64) - want).max():.3e}")
    return errs


def check_p2_edges(device, seed: int = 0) -> dict:
    """P2a / P2b / P2c on every case of :data:`P2_EDGES` (:func:`check_p2`);
    returns the max abs error of each against numpy."""
    rs = np.random.RandomState(seed)
    table = rs.randn(P2_T, 128).astype(np.float32)
    errs = dict.fromkeys(P2_NAMES, 0.0)
    for kind in P2_EDGES:
        for name, err in check_p2(p2_edge_indices(kind, rs), table, device,
                                  f" ({kind})").items():
            errs[name] = max(errs[name], err)
    return errs


def run(m_p1: int, m_p2: int, device, seed: int = 0, log=print, only=None) -> list[dict]:
    """Check and time every probe (or those named in ``only``) at these
    sizes; returns one entry per probe with ms, ns per index, the plain
    version's and the library call's times and the bytes bound of this run's
    data."""
    x = make_inputs(m_p1, m_p2, seed)
    d = to_device(x, device)
    specs = probe_specs(d)
    unknown = sorted(set(only or ()) - set(specs))
    if unknown:
        raise ValueError(f"unknown probes {unknown}; known: {sorted(specs)}")
    entries = []
    for name, (replaces, kernel, library, lib_name, n_bytes, n_idx, rel) in specs.items():
        if only and name not in only:
            continue
        got = kernel()
        torch.cuda.synchronize()
        err = check(name, got.cpu().numpy(), x, rel)
        ms = time_ms(kernel)
        lib_ms = time_ms(library)
        ms_cold = time_cold_ms(kernel)
        lib_ms_cold = time_cold_ms(library)
        plain_ms = time_ms(lambda: plain_of(name, d))
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[probe] {name}: {ms:.4f} ms, cold L2 {ms_cold:.4f} ms, {ms * 1e6 / n_idx:.3f} "
            f"ns/index (library {lib_name}: {lib_ms:.4f} ms, cold L2 {lib_ms_cold:.4f} ms, "
            f"{lib_ms * 1e6 / n_idx:.3f} ns/index; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms by bytes; max|kernel - numpy| {err:.3e}) at M={n_idx}")
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "ms_cold": ms_cold,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "library_ms_cold": lib_ms_cold,
            "library_call": lib_name, "ns_per_index": ms * 1e6 / n_idx,
            "library_ns_per_index": lib_ms * 1e6 / n_idx, "m": n_idx,
        })
        if name in P2_NAMES[:2]:
            entries[-1]["smem_wavefronts_per_step"] = p2_row_wavefronts(x["p2_idx"])
    return entries


def experiments(device, seed: int = 0, log=print) -> dict:
    """The cost of P2's bank conflicts, timed warm at the JAX script's size
    (ms): P2b on indices without conflicts (row mod 8 = i mod 8: one
    wavefront a row read) and on the random ones, with the wavefronts a
    step of each (each result to the bit against the emulated order); and
    P1b beside P1a unroll 8 (each against table[idx])."""
    x = make_inputs(1 << 22, P2_M, seed)
    d = to_device(x, device)
    rs = np.random.RandomState(seed + 1)
    free = ((rs.randint(0, P2_T // 8, P2_M) * 8) + np.arange(P2_M) % 8).astype(np.int32)
    check_p2(free, x["p2_table"], device, " (no bank conflicts)")
    check_p2(x["p2_idx"], x["p2_table"], device, " (random)")
    dfree = torch.from_numpy(free).to(device)
    out = {
        "P2b_eight_accumulators@no_bank_conflicts": time_ms(
            lambda: chunk_row_sum(dfree, d["p2_table"], 1)),
        "P2b_eight_accumulators@random": time_ms(
            lambda: chunk_row_sum(d["p2_idx"], d["p2_table"], 1)),
        "wavefronts_per_step@no_bank_conflicts": p2_row_wavefronts(free),
        "wavefronts_per_step@random": p2_row_wavefronts(x["p2_idx"]),
    }
    ref = x["table"][x["idx"]]
    for label, fn in (("P1b_vector_gather", lambda: vector_gather(d["idx"], d["table"])),
                      ("P1a_scalar_gather_unroll8",
                       lambda: scalar_gather(d["idx"], d["table"], 8))):
        if not np.array_equal(fn().cpu().numpy(), ref):
            raise AssertionError(f"{label}: differs from table[idx]")
        out[label] = time_ms(fn)
    for k, v in out.items():
        log(f"[experiment] {k}: {v}")
    return out


def turns(parent, only=(), quick=False, log=print) -> dict:
    """This checkout's probes against those of ``parent`` (the root of
    another checkout) in turns on one card: parent, change, change, parent,
    each a run of this module from that checkout (its own kernels, built
    into its own ``_build/``, timed by its own copy of this script) with
    the same ``--only`` / ``--quick``. Returns, for each probe, its
    ``ms`` / ``ms_cold`` / ``library_ms`` / ``plain_ms`` / ``bound_ms`` of
    each turn, as ``{name: {"parent_ms": [t1, t4], "change_ms": [t2, t3],
    ...}}``."""
    here = Path(__file__).resolve().parents[2]
    cmd = [sys.executable, "-m", "instant_nsr_pl_tpu_torch.tools.microbench_gather"]
    cmd += ["--only", ",".join(only)] if only else []
    cmd += ["--quick"] if quick else []
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}  # each its own package
    out = {}
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"probes"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"the {label} run from {root} exited {proc.returncode}:\n"
                               f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        probes = json.loads(lines[-1])["probes"]
        for e in probes:
            t = out.setdefault(e["name"], {})
            for key in ("ms", "ms_cold", "library_ms", "plain_ms", "bound_ms"):
                t.setdefault(f"{label}_{key}", []).append(e.get(key))
        log(f"[turns] {label} from {root}: "
            + ", ".join(f"{e['name']} {e['ms']:.4f} ms" for e in probes))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="M = 2^20 for P1 (else 2^22)")
    ap.add_argument("--only", default="",
                    help="comma-separated probe names to run (default: all), e.g. "
                         "P1e_sublane_gather,P1g_onehot_grad")
    ap.add_argument("--experiments", action="store_true",
                    help="also time P2's bank conflicts and P1b beside P1a unroll 8")
    ap.add_argument("--parent", default=None,
                    help="the root of another checkout: time its probes and these in turns")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    only = [n for n in args.only.split(",") if n]
    if not torch.cuda.is_available():
        print("microbench_gather: needs a CUDA card", file=sys.stderr)
        return 2
    m_p1 = 1 << 20 if args.quick else 1 << 22
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.parent:
        result = {"turns": turns(args.parent, only, args.quick, log=log), "card": smi}
    else:
        cuda_build.build_all()
        print(f"[probe] {torch.cuda.get_device_name(0)}; P1 M={m_p1} into ({T}, {F}) f32; "
              f"P2 M={P2_M} rows of ({P2_T}, 128) f32", flush=True)
        reset_launches()
        entries = run(m_p1, P2_M, device, log=log, only=only)
        counts = launch_counts()
        for e in entries:
            e["launches"] = counts[e["name"]]
        result = {"probes": entries, "card": smi}
        if args.experiments:
            result["experiments"] = experiments(device, log=log)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
