"""Gather and scatter probes of the hash grid's memory patterns on the card:
P1a-P1g and P2, the CUDA counterparts of the JAX package's Pallas probes
(``scripts/microbench_pallas.py``, ``scripts/microbench_pallas_gather.py``).

    python -m instant_nsr_pl_tpu_torch.tools.microbench_gather [--quick] [--only A,B]

Each probe is a kernel of ``csrc/gather_probes.cu`` behind a wrapper here
(launch count on the wrapper, the plain PyTorch version on CPU tensors). The
script builds them, checks each against the numpy result the JAX script
checks, then times each (CUDA-event median of 20 batches of 10 launches)
beside its plain version and the one PyTorch call that computes the same
function, at the JAX scripts' sizes: M = 2^22 indices for P1 (2^20 with
``--quick``) into a (2^19, 2) table, 2^20 row reads of an (8192, 128) table
for P2. It prints ms and ns per index for each, the least time the card
could take for the data it moved (``bound_ms``), and one JSON line
``{"probes": [...]}``. ``--only`` runs the named probes alone (names as in
that line). It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys

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
    rows = table[idx.long()].view(-1, P2_CHUNK, 128)
    if variant == 0:
        return rows.sum(1, keepdim=True).expand(-1, 8, -1).reshape(-1, 128)
    if variant == 1:
        return rows.view(rows.shape[0], P2_CHUNK // 8, 8, 128).sum(1).reshape(-1, 128)
    return rows[:, -8:].reshape(-1, 128)


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
    out = torch.zeros((rows, upd.shape[1]), dtype=torch.float32, device=idx.device)
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
    """P2: (M / 4096 * 8, 128) from M row reads of a (T, 128) table in
    4,096-index chunks: variant 0 the chunk's sum in each of its 8 rows,
    1 row j the sum over indices i = j mod 8, 2 the chunk's last 8 rows."""
    m = idx.numel()
    if idx.device.type == "cpu":
        return plain_chunk_row_sum(idx, table, variant)
    _check_index(idx, table)
    out = torch.empty((m // P2_CHUNK * 8, 128), dtype=torch.float32, device=idx.device)
    _launch("probe_chunk_row_sum", [_P, _L, _P, _P, _I], idx.data_ptr(), m,
            table.data_ptr(), out.data_ptr(), variant)
    chunk_row_sum.launches[variant] += 1
    return out


chunk_row_sum.launches = {0: 0, 1: 0, 2: 0}


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
            m2 * 4 + p2_uniq * 512 + m2 // P2_CHUNK * 8 * 512, m2, 1e-6),
        "P2b_eight_accumulators": (
            f"{P2}:85", lambda: chunk_row_sum(d["p2_idx"], d["p2_table"], 1),
            lambda: torch.index_select(d["p2_table"], 0, p2_l).view(-1, P2_CHUNK, 128).sum(1),
            "index_select(...).view(256, 4096, 128).sum(1)",
            m2 * 4 + p2_uniq * 512 + m2 // P2_CHUNK * 8 * 512, m2, 1e-6),
        "P2c_rows_to_scratch": (
            f"{P2}:85", lambda: chunk_row_sum(d["p2_idx"], d["p2_table"], 2),
            lambda: torch.index_select(d["p2_table"], 0, p2_l).view(-1, P2_CHUNK, 128).sum(1),
            "index_select(...).view(256, 4096, 128).sum(1)",
            m2 * 4 + p2_uniq * 512 + m2 // P2_CHUNK * 8 * 512, m2, 0.0),
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
        mag = numpy_reference(name, {**x, "upd": np.abs(x["upd"]),
                                     "p2_table": np.abs(x["p2_table"])})
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


def check_edges(device, seed: int = 0) -> dict:
    """P1g with every index on one row (its atomics all on one address) into
    a (1536, 2) table, and P1e on a ragged 37 rows, each against its plain
    version on the CPU (P1g within 1e-6 x the summed magnitude, P1e to the
    bit); returns the max abs error of each."""
    rs = np.random.RandomState(seed)
    rows, m = 3 * ONEHOT_B, 5003
    idx = np.full(m, rows - 5, np.int32)
    upd = (rs.randn(m, F) * 3.0).astype(np.float32)
    got = onehot_grad(torch.from_numpy(idx).to(device), torch.from_numpy(upd).to(device), rows)
    ref = plain_onehot_grad(torch.from_numpy(idx), torch.from_numpy(upd), rows)
    mag = plain_onehot_grad(torch.from_numpy(idx), torch.from_numpy(np.abs(upd)), rows)
    g_err = float((got.cpu().double() - ref.double()).abs().max())
    g_tol = 1e-6 * float(mag.max()) + 1e-6
    if not g_err <= g_tol:
        raise AssertionError(f"P1g, all indices equal: max|kernel - plain| = {g_err:.3e} "
                             f"beyond {g_tol:.3e}")
    sidx = rs.randint(0, SUB_ROWS, (37, 128)).astype(np.int32)
    table = rs.randn(SUB_ROWS, 128).astype(np.float32)
    got = sublane_gather(torch.from_numpy(sidx).to(device), torch.from_numpy(table).to(device))
    s_err = float((got.cpu() - plain_sublane_gather(torch.from_numpy(sidx),
                                                    torch.from_numpy(table))).abs().max())
    if not s_err == 0.0:
        raise AssertionError(f"P1e, 37 rows: max|kernel - plain| = {s_err:.3e}, not 0")
    return {"P1g_onehot_grad": g_err, "P1e_sublane_gather": s_err}


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
        plain_ms = time_ms(lambda: plain_of(name, d))
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[probe] {name}: {ms:.4f} ms, {ms * 1e6 / n_idx:.3f} ns/index (library "
            f"{lib_name}: {lib_ms:.4f} ms, {lib_ms * 1e6 / n_idx:.3f} ns/index; plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by bytes; max|kernel - numpy| "
            f"{err:.3e}) at M={n_idx}")
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "library_call": lib_name, "ns_per_index": ms * 1e6 / n_idx,
            "library_ns_per_index": lib_ms * 1e6 / n_idx, "m": n_idx,
        })
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="M = 2^20 for P1 (else 2^22)")
    ap.add_argument("--only", default="",
                    help="comma-separated probe names to run (default: all), e.g. "
                         "P1e_sublane_gather,P1g_onehot_grad")
    args = ap.parse_args(argv)
    only = [n for n in args.only.split(",") if n]
    if not torch.cuda.is_available():
        print("microbench_gather: needs a CUDA card", file=sys.stderr)
        return 2
    m_p1 = 1 << 20 if args.quick else 1 << 22
    device = torch.device("cuda")
    cuda_build.build_all()
    print(f"[probe] {torch.cuda.get_device_name(0)}; P1 M={m_p1} into ({T}, {F}) f32; "
          f"P2 M={P2_M} rows of ({P2_T}, 128) f32", flush=True)
    entries = run(m_p1, P2_M, device, log=lambda s: print(s, flush=True), only=only)
    counts = launch_counts()
    for e in entries:
        e["launches"] = counts[e["name"]]
    print(json.dumps({"probes": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
