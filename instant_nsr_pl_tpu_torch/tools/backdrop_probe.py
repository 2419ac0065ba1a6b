"""The foreground / background split of ``configs/neus-colmap.yaml`` on the
procedural scene's COLMAP export, white and on a textured backdrop.

    python -m instant_nsr_pl_tpu_torch.tools.backdrop_probe

runs from the root of a checkout on one CUDA card. It writes the COLMAP
export twice at 800x800 (80 views): with ``--backdrop`` as ``chip_smoke.py``
does, and white as the JAX script does. Then it trains through the launcher
with ``chip_smoke.py``'s ``dataset_launcher_phase``, whose checks it reports
but does not stop on: ``neus-colmap.yaml`` on the backdrop, the same on the
white export, ``nerf-colmap.yaml`` on the backdrop (300 steps each), and
both NeuS runs again at 1,000 steps. After each NeuS run it renders the
first two val views and prints, against the scene's analytic object mask:
the foreground opacity on and off the object, the foreground's colour
(un-premultiplied), the background model's colour and the ground truth off
the object, and inv_s. A foreground that covers the whole view in the
background's colour is a shell that stands in for the background model.
"""

from __future__ import annotations

import glob
import os
import sys
import time
import traceback

STEPS = (("colmap_neus", 300), ("colmap_neus_white", 300), ("colmap_nerf", 300),
         ("colmap_neus_white", 1000), ("colmap_neus", 1000))
SIZE, VIEWS = 800, 80


def _split_stats(cs, key, mask_of, device):
    import numpy as np
    import torch

    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.registry import datasets, systems
    from instant_nsr_pl_tpu_torch.systems.base import dataset_device_arrays
    from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint

    name, overrides, *_ = cs.DATASET_PATHS[key]
    (ckpt,) = glob.glob(os.path.join(cs.ROOT, "exp", "chip_smoke_datasets", key, "*", "*",
                                     "ckpt", "*.ckpt"))
    cfg = load_config(os.path.join(cs.ROOT, "configs", name), cli_args=overrides)
    system = systems.make(cfg.system.name, cfg)
    state = load_checkpoint(ckpt, system.init_state(0))
    dm = datasets.make(cfg.dataset.name, cfg.dataset)
    dm.setup("validate")
    system.setup_data(dm.val)
    inv_s = float(torch.exp(state["params"]["variance"]["variance"] * 10))
    for view in (0, 1):
        im = system.render_image(state, view, data=dataset_device_arrays(dm.val, device))
        op = im["opacity"][..., 0]
        fg = im["comp_rgb_fg"] / np.maximum(im["opacity"], 1e-6)
        bg = im["comp_rgb_bg"]
        gt = np.asarray(dm.val.all_images[view], np.float32)
        if gt.max() > 1.5:
            gt = gt / 255.0
        on = mask_of(view)
        off = ~on
        print(f"[probe] {key} view {view}: object pixels {on.mean():.4f}; fg opacity on "
              f"object {op[on].mean():.4f}, off object {op[off].mean():.4f} (share > 0.5 "
              f"off object {(op[off] > 0.5).mean():.4f}); off object: fg colour "
              f"{fg[off].mean(0).round(3)}, bg colour {bg[off].mean(0).round(3)}, gt "
              f"{gt[off].mean(0).round(3)}, |fg - gt| {np.abs(fg[off] - gt[off]).mean():.4f}, "
              f"|bg - gt| {np.abs(bg[off] - gt[off]).mean():.4f}; on object |fg - gt| "
              f"{np.abs(fg[on] - gt[on]).mean():.4f}; inv_s {inv_s:.2f}", flush=True)
    del system, state
    torch.cuda.empty_cache()


def main(argv=None):
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from instant_nsr_pl_tpu_torch.config import config_from_dict
    from instant_nsr_pl_tpu_torch.datasets.synthetic import SyntheticDatasetBase
    from instant_nsr_pl_tpu_torch.ops import cuda_build
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[probe] build {cuda_build.build_all():.1f} s", flush=True)
    smi = cs.nvidia_smi_line()
    cs.colmap_export_phase()
    white = os.path.join(cs.ROOT, "exp", "chip_smoke_colmap_white")
    make_synthetic_data.main(["--out", white, "--format", "colmap", "--size", str(SIZE),
                              "--n-train", str(VIEWS)])
    cs.DATASET_PATHS["colmap_neus_white"] = (
        "neus-colmap.yaml", [o.replace(cs.COLMAP_EXPORT, white) for o in cs.COLMAP_OVERRIDES],
        "val", 2, cs.BG_KERNELS)
    # the val views are the train views, at the config's img_downscale 4
    syn = SyntheticDatasetBase()
    syn.setup(config_from_dict({"size": SIZE // 4, "n_train": VIEWS, "fov": 0.8}), "train")
    device = torch.device("cuda")
    for key, steps in STEPS:
        cs.LAUNCHER_STEPS = steps
        t1 = time.time()
        try:
            cs.dataset_launcher_phase(device, smi, key)
            print(f"[probe] {key} {steps} steps ok in {time.time() - t1:.0f} s", flush=True)
        except AssertionError:
            print(f"[probe] {key} {steps} steps FAILED in {time.time() - t1:.0f} s: "
                  f"{traceback.format_exc(limit=2)}", flush=True)
        if not key.endswith("nerf"):
            _split_stats(cs, key, lambda v: syn.all_fg_masks[v] > 0.5, device)
        torch.cuda.empty_cache()
    print(f"[probe] total {time.time() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
