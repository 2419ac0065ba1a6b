"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. All sources are compiled in parallel, at first use,
into ``instant_nsr_pl_tpu_torch/_build/``; a library's file name carries a
hash of its sources and flags, so an edit rebuilds it, and its build's
nvcc / ptxas output is kept beside it under the same name with ``.log``
(:func:`build_log`), so a later process that reuses the library still reads
its registers and spills. A missing ``nvcc`` or a failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no contraction of separate mul/add into FMA: the kernels call fmaf
    # where they want one, so elementwise rounding follows the plain versions
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source stem -> nvcc/ptxas output of its build
# launch plans of the persistent backward kernels (csrc/mma_common.cuh), by
# (entry point, shape, device index): grid cap, blocks per SM, shared-memory
# bytes per block, partial sums per block
PLANS: dict[tuple, dict] = {}
BWD_TILE = 64  # samples per tile of those kernels (mma_common.cuh kT)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
            "CUDA kernels are built from instant_nsr_pl_tpu_torch/csrc at first use"
        )
    return cand


def _library_path(src: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every ``csrc/*.cu`` whose library is missing, all at once.
    Returns the wall seconds spent; raises on the first failed build."""
    t0 = time.perf_counter()
    todo = [(s, _library_path(s)) for s in sorted(CSRC.glob("*.cu"))]
    todo = [(s, p) for s, p in todo if not p.exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
            lib.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(stem: str) -> str | None:
    """The nvcc / ptxas output of the build of ``csrc/<stem>.cu``'s current
    library: this process's (``BUILD_LOG``) or, when an earlier process built
    it, the ``.log`` file beside it. None when neither exists."""
    log = BUILD_LOG.get(stem)
    if log:
        return log
    path = _library_path(CSRC / f"{stem}.cu").with_suffix(".log")
    return path.read_text() if path.exists() else None


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it at first use."""
    lib = _LIBS.get(stem)
    if lib is None:
        src = CSRC / f"{stem}.cu"
        path = _library_path(src)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[stem] = lib
    return lib


_ENTRIES: dict[tuple, object] = {}


def entry(stem: str, name: str, argtypes) -> object:
    """Entry point ``name`` of ``csrc/<stem>.cu``'s library with its argument
    types set (once per loaded library) and an int return code."""
    lib = library(stem)
    known = _ENTRIES.get((stem, name))
    if known is not None and known[0] is lib:
        return known[1]
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    _ENTRIES[(stem, name)] = (lib, fn)
    return fn


def check(rc: int, name: str, supported: str):
    """Raise for a non-zero return code of a kernel's C entry point."""
    if rc == -1:
        raise ValueError(f"{name}: no CUDA instantiation for this shape; "
                         f"supported: {supported}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def launch_persistent(key, call, n, device, name, supported):
    """Launch a persistent backward entry point (csrc/mma_common.cuh) on n
    samples: its plan (the first call per ``key`` asks the entry point with no
    scratch; cached in ``PLANS``: grid cap, blocks per SM, shared-memory
    bytes, partial sums per block), the (blocks, count) f32 scratch and the
    summed f32 output, then ``call(part, blocks, out, info, n)``. Returns the
    output."""
    plan = PLANS.get(key)
    if plan is None:
        info = (ctypes.c_int * 4)()
        check(call(None, 0, None, info, 1 << 40), name, supported)
        plan = {"grid_cap": info[0], "blocks_per_sm": info[1], "smem_bytes": info[2],
                "count": info[3]}
        PLANS[key] = plan
    grid = min(plan["grid_cap"], -(-n // BWD_TILE))
    part = torch.empty((grid, plan["count"]), dtype=torch.float32, device=device)
    out = torch.empty((plan["count"],), dtype=torch.float32, device=device)
    check(call(part.data_ptr(), grid, out.data_ptr(), (ctypes.c_int * 4)(), n), name, supported)
    return out


def record_plan(key, info):
    """Keep a single-launch kernel's plan (``csrc/mma_common.cuh``
    plan_persistent: grid, blocks per SM, shared-memory bytes) in ``PLANS``."""
    PLANS[key] = {"grid": info[0], "blocks_per_sm": info[1], "smem_bytes": info[2]}


def check_operands(name, tensors, shapes, device):
    """Raise unless each tensor lies on ``device``, has its shape and is
    contiguous: the kernels read raw pointers with these layouts."""
    for t, shape in zip(tensors, shapes):
        if t.device != device or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: operand {tuple(t.shape)} on {t.device} "
                             f"does not match {tuple(shape)} contiguous on {device}")
