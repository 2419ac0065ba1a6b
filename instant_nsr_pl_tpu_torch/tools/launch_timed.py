"""The port's launcher with its data loads and its mesh export timed by stage.

    python -m instant_nsr_pl_tpu_torch.tools.launch_timed <launcher arguments>

runs ``instant_nsr_pl_tpu_torch.launch`` in this process with the same
arguments (``--config X.yaml --train|--test|--export ... [overrides]``) and
then prints one JSON line: the run's wall seconds, each dataset split's load
(views, size, wall seconds and the decode and resize seconds of
``utils/image_io.py``), and the mesh export by stage (the level grid on the
device, marching on the host, vertex colours, and the whole export with the
OBJ). On a CUDA card every timed stage starts and ends with
``torch.cuda.synchronize()``. Training rates and quality are in the run's
``csv_logs/metrics.csv``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_loads(records):
    """Append each Blender / DTU / COLMAP split's load figures to
    ``records`` (a COLMAP capture is parsed by its first split; the others
    record 0 s of decode and resize)."""
    from instant_nsr_pl_tpu_torch.datasets.blender import BlenderDatasetBase
    from instant_nsr_pl_tpu_torch.datasets.colmap import ColmapDatasetBase
    from instant_nsr_pl_tpu_torch.datasets.dtu import DTUDatasetBase

    originals = {cls: cls.setup for cls in (BlenderDatasetBase, ColmapDatasetBase,
                                            DTUDatasetBase)}

    def wrap(fn):
        def setup(self, config, split, *args, **kwargs):
            t0 = time.perf_counter()
            fn(self, config, split, *args, **kwargs)
            records.append({"split": split, "views": int(self.all_images.shape[0]),
                            "wh": [self.w, self.h], "wall": time.perf_counter() - t0,
                            **self.load_seconds})
        return setup

    for cls, fn in originals.items():
        cls.setup = wrap(fn)
    try:
        yield records
    finally:
        for cls, fn in originals.items():
            cls.setup = fn


@contextlib.contextmanager
def timed_export(stage):
    """Add the seconds of each mesh export stage into ``stage`` ("level
    grid", "marching", "vertex colours", "export": the whole
    ``Trainer.export`` with the OBJ)."""
    import instant_nsr_pl_tpu_torch.models.isosurface as iso_mod
    from instant_nsr_pl_tpu_torch.models.nerf import NeRFModel
    from instant_nsr_pl_tpu_torch.models.neus import NeuSModel
    from instant_nsr_pl_tpu_torch.trainer import Trainer

    for k in ("level grid", "marching", "vertex colours", "export"):
        stage.setdefault(k, 0.0)

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            stage[key] += time.perf_counter() - t0
            return out
        return wrapper

    patches = [(iso_mod, "_eval_level_grid", "level grid"),
               (iso_mod, "marching_tetrahedra", "marching"),
               (NeRFModel, "vertex_colors", "vertex colours"),
               (NeuSModel, "vertex_colors", "vertex colours"),
               (Trainer, "export", "export")]
    originals = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, key in patches:
        setattr(owner, attr, timed(key, getattr(owner, attr)))
    try:
        yield stage
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)


def main(argv=None):
    from instant_nsr_pl_tpu_torch.launch import main as launch_main

    argv = sys.argv[1:] if argv is None else argv
    loads, stage = [], {}
    with timed_loads(loads), timed_export(stage):
        t0 = time.perf_counter()
        rc = launch_main(argv)
        _sync()
        wall = time.perf_counter() - t0
    device = (torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
    print(json.dumps({"rc": rc, "wall_s": wall, "loads": loads, "export_s": stage,
                      "device": device}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
