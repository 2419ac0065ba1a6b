"""Time the marching-tetrahedra pass on the card (MT1 / MT2,
``csrc/marching_tet.cu``) stage by stage, optionally from another checkout
of the port, and capture a trained model's level grid from a launcher run.

    python instant_nsr_pl_tpu_torch/tools/mt_bench.py [--root DIR]
        [--grids sphere_128,sphere_256,sphere_512,GRID.npy] [--reps 5]
        [--check] [--out result.json]
    python instant_nsr_pl_tpu_torch/tools/mt_bench.py --capture GRID.npy
        -- <launcher arguments>

``--root`` imports the port from checkout DIR (for example the parent commit
unpacked with ``git archive``) instead of this one. Each grid (a sphere SDF
of radius 0.6 at res^3, as ``chip_smoke.py`` marches it, or a saved
``.npy`` with its iso level in ``GRID.iso.json`` beside it, 0 without one)
is marched once cold and ``--reps`` times warm (wall seconds around a
synchronised pass), once under torch.profiler (device ms by kernel), and
once with a CUDA event after each stage. The stages are the design's own:
a design whose ``marching_tetrahedra_launch`` takes ``stages=`` reports
them itself; the first design (``nonzero`` / ``cumsum`` / ``unique``
between MT1 and MT2) is split here by running its steps in its order:
``mt_classify``, ``nonzero``, ``cumsum + sync`` (the host reads the face
count), ``mt_emit``, ``unique``, ``mt_verts``, ``degenerate sync``. A stage's
ms is the event time from the end of the previous stage, so it holds the
host's gaps where the pass waits on the host. ``--check`` also holds the
mesh against the numpy twin (faces equal, vertices within 1 ulp).

``--capture GRID.npy -- ARGS`` runs ``tools/launch_timed.py`` with ARGS (its
JSON line: loads, the export by stage) and saves the level grid of the run's
last marching call (the fine pass of its last mesh) with its iso level.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def sphere_grid(res):
    """A sphere SDF of radius 0.6 about (0.05, -0.1, 0.02) on a res^3 grid
    over [-1, 1]^3, float32 (``chip_smoke.py`` ``sphere_grid``)."""
    c = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return np.sqrt((x - 0.05) ** 2 + (y + 0.1) ** 2 + (z - 0.02) ** 2).astype(np.float32) - 0.6


def load_grid(spec):
    """(name, values, iso) of a ``--grids`` entry."""
    if spec.startswith("sphere_"):
        return spec, sphere_grid(int(spec.split("_")[1])), 0.0
    path = Path(spec)
    meta = path.with_suffix(".iso.json")
    iso = json.loads(meta.read_text())["iso"] if meta.exists() else 0.0
    return path.stem, np.load(path), float(iso)


# ---------------------------------------------------------------------------
# a plain emulation of the kernels' design (the CPU tests hold it against JAX)
# ---------------------------------------------------------------------------

WARP = 32  # lanes of a warp
RUN = 4  # the z a lane takes in a chunk
CHUNK = WARP * RUN  # a chunk: 128 z of a grid line
RANK_CORNER = (4, 2, 6, 1, 5, 3, 7)  # the far corner (x = 1, y = 2, z = 4) of rank r's offset
POPC = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _tables():
    """The twin's tetrahedra and 16-case table, and a cube's faces by its
    8-bit inside mask (``marching_tet.cu`` ``kCube``)."""
    from instant_nsr_pl_tpu_torch.ops.isosurface import _TET_EDGES, _TET_TABLE, _TETS

    tet_count = (_TET_TABLE[:, :, 0] >= 0).sum(axis=1)
    masks = np.arange(256)[:, None]
    tet_masks = sum(((masks >> _TETS[:, j]) & 1) << j for j in range(4))  # (256, 6)
    return _TETS, _TET_EDGES, _TET_TABLE, tet_count[tet_masks].sum(axis=1)


def _shift(a, c, fill):
    """a[x + cx, y + cy, z + cz] for corner c, ``fill`` beyond the grid."""
    cx, cy, cz = c & 1, (c >> 1) & 1, c >> 2
    out = np.full(a.shape, fill, a.dtype)
    out[:a.shape[0] - cx, :a.shape[1] - cy, :a.shape[2] - cz] = a[cx:, cy:, cz:]
    return out


def _back(a, s):
    """a[x - sx, y - sy, z - sz] for the axes of s, False before the grid."""
    sx, sy, sz = s & 1, (s >> 1) & 1, s >> 2
    out = np.zeros(a.shape, bool)
    out[sx:, sy:, sz:] = a[:a.shape[0] - sx, :a.shape[1] - sy, :a.shape[2] - sz]
    return out


def classify_emulated(values, iso, lines_per_tile=32):
    """MT1 (``mt_classify``, ``mt_scan``) in numpy: each grid vertex's byte
    (mesh edges by rank in bits 0-6: the crossed edges of lo that a cube
    without a NaN corner contains, the cube at lo or one at lo - s; bit 7,
    the cube at lo active), each line's faces, vertices and 32-bit mask of
    its chunks with a non-zero byte, each tile's sums and first face and
    vertex, the totals."""
    v = np.asarray(values, np.float32)
    rx, ry, rz = v.shape
    _, _, _, cube_faces = _tables()
    inside = v < np.float32(iso)
    ones = np.ones(v.shape, bool)
    in_range = [_shift(ones, c, False) for c in range(8)]
    valid = in_range[7].copy()  # the cube at lo exists
    mask = np.zeros(v.shape, np.int64)
    for c in range(8):
        valid &= ~_shift(np.isnan(v), c, True)
        mask |= _shift(inside, c, False).astype(np.int64) << c
    active = valid & (mask != 0) & (mask != 255)
    edges = np.zeros(v.shape, np.int64)
    for r, c in enumerate(RANK_CORNER):
        crossed = in_range[c] & (inside != _shift(inside, c, False))
        owned, rest = valid.copy(), 7 & ~c
        s = rest
        while s:  # the other cubes that contain the edge
            owned |= _back(valid, s)
            s = (s - 1) & rest
        edges |= (crossed & owned).astype(np.int64) << r
    flags = (edges | (active.astype(np.int64) << 7)).astype(np.uint8)
    n_lines = rx * ry
    chunks = -(-rz // CHUNK)
    per_bit = -(-chunks // 32)
    nonzero = np.zeros((n_lines, chunks * CHUNK), bool)
    nonzero[:, :rz] = flags.reshape(n_lines, rz) != 0
    occupied = np.zeros(n_lines, np.int64)
    for k in np.nonzero(nonzero.reshape(n_lines, chunks, CHUNK).any(2).any(0))[0]:
        occupied |= nonzero[:, k * CHUNK:(k + 1) * CHUNK].any(1).astype(np.int64) << (k // per_bit)
    line_info = np.stack([np.where(active, cube_faces[mask], 0).reshape(n_lines, rz).sum(1),
                          POPC[edges].reshape(n_lines, rz).sum(1), occupied], axis=1)
    n_tiles = -(-n_lines // lines_per_tile)
    padded = np.zeros((n_tiles * lines_per_tile, 3), np.int64)
    padded[:n_lines, 0] = active.reshape(n_lines, rz).sum(1)
    padded[:n_lines, 1:] = line_info[:, :2]
    tile_sums = padded.reshape(n_tiles, lines_per_tile, 3).sum(1)
    tile_bases = np.cumsum(tile_sums[:, 1:], axis=0) - tile_sums[:, 1:]
    return {"flags": flags.reshape(-1), "line_info": line_info, "tile_sums": tile_sums,
            "tile_bases": tile_bases, "totals": tile_sums.sum(0), "lines_per_tile": lines_per_tile,
            "per_bit": per_bit}


def _line_base(c, line, k):
    """A line's first face (k = 0) or vertex (k = 1): its tile's base and the
    lines before it in the tile (``marching_tet.cu`` ``line_base``)."""
    t = line // c["lines_per_tile"]
    return int(c["tile_bases"][t, k] + c["line_info"][t * c["lines_per_tile"]:line, k].sum())


def _interpolate(va, vb, iso, pa, pb):
    va, vb = np.atleast_1d(va), np.atleast_1d(vb)
    denom = vb - va
    t = np.where(np.abs(denom) > 1e-12, (iso - va) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t.astype(np.float32), 0.0, 1.0)
    return (pa + t[:, None] * (pb - pa)).astype(np.float32)


def _lane_runs(flags_line, z0, rz):
    """A chunk's bytes of one line as (lanes, RUN + 1): each lane's RUN bytes
    and the next lane's first, zeros beyond the line."""
    z = z0 + np.arange(WARP)[:, None] * RUN + np.arange(RUN + 1)[None, :]
    return np.where(z < rz, flags_line[np.minimum(z, rz - 1)], 0), z


def emit_emulated(values, iso, c):
    """MT2 (``mt_verts``, ``mt_emit``) in numpy as the warps walk: each line
    over the chunks of 128 z that the occupancy masks mark, a lane taking 4
    consecutive z, the running vertex counts of the four lines a cube
    touches (an exclusive scan of the lanes' counts); the vertices at their
    scanned slots, the faces at their scanned offsets (each id the line's
    first vertex + the vertices before lo on it + lo's mesh edges of lower
    rank), then oriented as the twin orients them."""
    v = np.asarray(values, np.float32)
    rx, ry, rz = v.shape
    iso = np.float32(iso)
    tets, tet_edges, table, cube_faces = _tables()
    flags = c["flags"].reshape(rx, ry, rz).astype(np.int64)
    info, per_bit = c["line_info"], c["per_bit"]
    verts = np.full((int(c["totals"][2]), 3), np.nan, np.float32)
    faces = np.full((int(c["totals"][1]), 3), -1, np.int64)
    chunks = -(-rz // CHUNK)
    for line in range(rx * ry):
        x, y = divmod(line, ry)
        if info[line, 1]:  # mt_verts
            carry = _line_base(c, line, 1)
            for k in range(chunks):
                if not (info[line, 2] >> (k // per_bit)) & 1:
                    continue
                b, z = _lane_runs(flags[x, y], k * CHUNK, rz)
                e = b[:, :RUN] & 0x7F
                n = POPC[e].sum(1)
                first = carry + np.cumsum(n) - n  # each lane's first vertex
                carry += int(n.sum())
                for lane, j in zip(*np.nonzero(e)):
                    slot = first[lane] + POPC[e[lane, :j]].sum()
                    for r, corner in enumerate(RANK_CORNER):
                        if not (e[lane, j] >> r) & 1:
                            continue
                        pa = np.array([[x, y, z[lane, j]]], np.float32)
                        pb = pa + np.array([corner & 1, (corner >> 1) & 1, corner >> 2])
                        hb = pb.astype(np.int64)[0]
                        verts[slot] = _interpolate(v[x, y, z[lane, j]], v[hb[0], hb[1], hb[2]],
                                                   iso, pa, pb.astype(np.float32))[0]
                        slot += 1
        if not info[line, 0]:  # mt_emit
            continue
        lines = [line + (d & 1) * ry + (d >> 1) for d in range(4)]
        carry = [_line_base(c, ld, 1) for ld in lines]
        occupied = np.bitwise_or.reduce([info[ld, 2] for ld in lines])
        f_carry = _line_base(c, line, 0)
        for k in range(chunks):
            if not (occupied >> (k // per_bit)) & 1:
                continue
            runs, before = [], []
            for d, ld in enumerate(lines):
                b, z = _lane_runs(flags[ld // ry, ld % ry], k * CHUNK, rz)
                n = POPC[b[:, :RUN] & 0x7F].sum(1)
                runs.append(b)
                before.append(carry[d] + np.cumsum(n) - n)
                carry[d] += int(n.sum())
            act = (runs[0][:, :RUN] >> 7) & 1
            masks = np.zeros(act.shape, np.int64)
            for lane, j in zip(*np.nonzero(act)):
                zz = z[lane, j]
                masks[lane, j] = sum(int(v[x + (q & 1), y + ((q >> 1) & 1), zz + (q >> 2)] < iso)
                                     << q for q in range(8))
            n = np.where(act == 1, cube_faces[masks], 0).sum(1)
            first = f_carry + np.cumsum(n) - n  # each lane's first face
            f_carry += int(n.sum())
            for lane in range(WARP):
                f = first[lane]
                for j in range(RUN):
                    if not act[lane, j]:
                        continue
                    for t in range(6):
                        tm = sum(((masks[lane, j] >> tets[t, q]) & 1) << q for q in range(4))
                        for kk in range(2):
                            if table[tm, kk, 0] < 0:
                                continue
                            for q in range(3):
                                ca, cb = tets[t, tet_edges[table[tm, kk, q]]]
                                lo, hi = ca & cb, ca | cb
                                d, below = lo & 3, (1 << RANK_CORNER.index(hi ^ lo)) - 1
                                e = runs[d][lane] & 0x7F  # the lane's bytes and the next one
                                upto = j + (lo >> 2)  # lo's z in the lane's run
                                faces[f, q] = (before[d][lane] + POPC[e[:upto]].sum()
                                               + POPC[e[upto] & below])
                            f += 1
    return verts, _orient(v, verts, faces)


def _orient(values, verts, faces):
    """The twin's orientation (``ops/isosurface.py``), as MT2 applies it."""
    rx, ry, rz = values.shape
    c = verts[faces].mean(axis=1)
    g = np.clip(np.round(c).astype(np.int64), 1, [rx - 2, ry - 2, rz - 2])
    grad = np.stack([values[g[:, 0] + 1, g[:, 1], g[:, 2]] - values[g[:, 0] - 1, g[:, 1], g[:, 2]],
                     values[g[:, 0], g[:, 1] + 1, g[:, 2]] - values[g[:, 0], g[:, 1] - 1, g[:, 2]],
                     values[g[:, 0], g[:, 1], g[:, 2] + 1] - values[g[:, 0], g[:, 1], g[:, 2] - 1]],
                    axis=-1)
    n = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]])
    flip = (n * grad).sum(axis=1) < 0
    faces = faces.copy()
    faces[flip] = faces[flip][:, ::-1]
    return faces


def marching_emulated(values, iso=0.0, lines_per_tile=32):
    """MT1 then MT2 in numpy: (verts, faces), the twin's mesh."""
    values = np.asarray(values, np.float32)
    if min(values.shape) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    return emit_emulated(values, iso, classify_emulated(values, iso, lines_per_tile))


def first_design_stages(iso_mod, cuda_build, values, iso, mark):
    """The first design's pass (``marching_classify``, then its
    ``marching_emit`` step by step) with ``mark(name)`` after each step."""
    import ctypes

    import torch

    counts = iso_mod.marching_classify(values, iso)
    mark("mt_classify")
    cubes = torch.nonzero(counts).reshape(-1)
    mark("nonzero")
    tris = counts[cubes].long()
    first = torch.cumsum(tris, 0) - tris
    n_faces = int(first[-1] + tris[-1])
    mark("cumsum + sync")
    device = values.device
    keys = torch.empty((n_faces, 3), dtype=torch.int64, device=device)
    degenerate = torch.empty((n_faces,), dtype=torch.uint8, device=device)
    emit = cuda_build.entry("marching_tet", "mt_emit", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    interp = cuda_build.entry("marching_tet", "mt_verts", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    grid = (values.data_ptr(), *(int(d) for d in values.shape))
    stream = torch.cuda.current_stream(device).cuda_stream
    cuda_build.check(emit(*grid, iso, cubes.data_ptr(), first.data_ptr(), cubes.numel(),
                          keys.data_ptr(), degenerate.data_ptr(), stream), "mt_emit", "any")
    mark("mt_emit")
    uniq, faces = torch.unique(keys.reshape(-1), sorted=True, return_inverse=True)
    mark("unique")
    verts = torch.empty((uniq.numel(), 3), dtype=torch.float32, device=device)
    cuda_build.check(interp(*grid, iso, uniq.data_ptr(), uniq.numel(), verts.data_ptr(), stream),
                     "mt_verts", "any")
    mark("mt_verts")
    faces = faces.reshape(-1, 3)
    if bool(degenerate.any()):
        faces = faces[degenerate == 0]
    mark("degenerate sync")
    return verts, faces


def staged_pass(iso_mod, cuda_build, values, iso, mark):
    """One pass of the root's design with ``mark`` called after each stage."""
    import inspect

    launch = iso_mod.marching_tetrahedra_launch
    if "stages" in inspect.signature(launch).parameters:
        return launch(values, iso, stages=mark)
    return first_design_stages(iso_mod, cuda_build, values, iso, mark)


def stage_split(iso_mod, cuda_build, values, iso, reps):
    """Median event ms of each stage over ``reps`` warm passes, and their sum."""
    import torch

    runs = []
    for _ in range(reps):
        names, events = [], []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            names.append(name)
            events.append(ev)

        torch.cuda.synchronize()
        mark("start")
        staged_pass(iso_mod, cuda_build, values, iso, mark)
        torch.cuda.synchronize()
        runs.append({n: a.elapsed_time(b) for n, a, b in zip(names[1:], events, events[1:])})
    split = {n: statistics.median(r[n] for r in runs) for n in runs[0]}
    return split, statistics.median(sum(r.values()) for r in runs)


def device_split(fn, calls=3):
    """Device ms per call by kernel name (torch.profiler), and their sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + e.time_range.elapsed_us()
    by_name = {k: v / calls / 1e3 for k, v in by_name.items()}
    return sum(by_name.values()), by_name


def ulps(a, b):
    """Units in the last place between float32 arrays a and b (elementwise)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def bench_grid(iso_mod, cuda_build, name, values, iso, reps, check, smi):
    import torch

    grid = torch.from_numpy(values).cuda()
    fn = lambda: iso_mod.marching_tetrahedra(grid, iso)  # noqa: E731
    walls = []
    for _ in range(reps + 1):  # the first cold
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, f = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev_ms, by_kernel = device_split(fn)
    split, split_sum = stage_split(iso_mod, cuda_build, grid, iso, reps)
    out = {"shape": list(values.shape), "iso": iso, "vertices": int(v.shape[0]),
           "faces": int(f.shape[0]), "cold_ms": walls[0],
           "warm_ms": statistics.median(walls[1:]), "warm_ms_all": walls[1:],
           "device_ms": dev_ms, "device_by_kernel": by_kernel, "stages_ms": split,
           "stages_sum_ms": split_sum}
    print(f"[mt] {name} {tuple(values.shape)}: {out['vertices']} vertices, {out['faces']} faces; "
          f"warm {out['warm_ms']:.4f} ms (cold {walls[0]:.3f}); device {dev_ms:.4f} ms "
          f"({', '.join(f'{k} {t:.4f}' for k, t in sorted(by_kernel.items(), key=lambda kv: -kv[1]))})"
          f"; stages {', '.join(f'{k} {t:.4f}' for k, t in split.items())} (sum {split_sum:.4f}) "
          f"[{smi}]", flush=True)
    if check:
        t0 = time.perf_counter()
        rv, rf = iso_mod.marching_tetrahedra_numpy(values, iso)
        twin_s = time.perf_counter() - t0
        vv, ff = v.cpu().numpy(), f.cpu().numpy()
        assert ff.shape == rf.shape and np.array_equal(ff, rf), f"{name}: faces differ"
        assert vv.shape == rv.shape, (vv.shape, rv.shape)
        worst = int(ulps(vv, rv).max()) if len(vv) else 0
        assert worst <= 1, f"{name}: vertices differ by {worst} ulp"
        out.update(twin_s=twin_s, max_ulp=worst)
        print(f"[mt] {name}: faces equal to the numpy twin's, vertices within {worst} ulp "
              f"(twin {twin_s:.1f} s)", flush=True)
    return out


def capture(path, launcher_args):
    """``tools/launch_timed.py`` with the last marched level grid saved."""
    import torch

    import instant_nsr_pl_tpu_torch.models.isosurface as iso_mod
    from instant_nsr_pl_tpu_torch.tools import launch_timed

    last = {}
    march = iso_mod.marching_tetrahedra

    def keep(values, iso=0.0):
        last.update(values=values, iso=float(iso))
        return march(values, iso)

    iso_mod.marching_tetrahedra = keep
    try:
        rc = launch_timed.main(launcher_args)
    finally:
        iso_mod.marching_tetrahedra = march
    values = last["values"]
    values = values.cpu().numpy() if torch.is_tensor(values) else np.asarray(values)
    np.save(path, values)
    Path(path).with_suffix(".iso.json").write_text(json.dumps({"iso": last["iso"]}))
    print(f"[mt] captured the level grid {values.shape} (iso {last['iso']}) to {path}",
          flush=True)
    return rc


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    launcher_args = []
    if "--" in argv:
        i = argv.index("--")
        argv, launcher_args = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--grids", default="sphere_128,sphere_256,sphere_512")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--capture", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("mt_bench: needs a CUDA card", file=sys.stderr)
        return 2
    if args.capture:
        return capture(args.capture, launcher_args)
    from instant_nsr_pl_tpu_torch.ops import cuda_build
    from instant_nsr_pl_tpu_torch.ops import isosurface as iso_mod

    if Path(cuda_build.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported the port from {cuda_build.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cuda_build.build_all()
    log = cuda_build.build_log("marching_tet") or ""
    ptxas = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    for line in ptxas:
        print(f"[build] marching_tet: {line}", flush=True)
    result = {"root": str(root), "card": smi, "ptxas": ptxas, "grids": {}}
    for spec in args.grids.split(","):
        name, values, iso = load_grid(spec)
        result["grids"][name] = bench_grid(iso_mod, cuda_build, name, values, iso, args.reps,
                                           args.check, smi)
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
