"""Export the procedural sphere scene as on-disk datasets in the reference's
input formats, so the port's real loaders (``datasets/blender.py``,
``datasets/dtu.py``) run end to end through the launcher without downloaded
data. The port's copy of ``scripts/make_synthetic_data.py`` (its blender and
dtu formats; PNGs written by ``utils/savers.py``, without PIL).

- **blender** (NeRF-Synthetic layout, reference datasets/blender.py:27-48):
  ``transforms_{train,val,test}.json`` with ``camera_angle_x`` and a 4x4
  OpenGL ``transform_matrix`` per frame, RGBA PNGs whose alpha is the
  foreground mask.
- **dtu** (NeuS preprocessing layout, reference datasets/dtu.py:20-34):
  ``cameras_sphere.npz`` with per-view ``world_mat_i`` (K @ w2c in the NeuS
  right-down-front convention) and identity ``scale_mat_i`` (the scene is
  already inside the unit sphere), ``image/%06d.png`` and ``mask/%03d.png``,
  the train split's views.

    python -m instant_nsr_pl_tpu_torch.tools.make_synthetic_data --out exp/data \
        [--format all|blender|dtu] [--size 128] [--n-train 20] [--n-val 2] [--n-test 4]

writes ``<out>/blender`` and / or ``<out>/dtu``. It runs on the CPU (numpy).
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from instant_nsr_pl_tpu_torch.config import config_from_dict
from instant_nsr_pl_tpu_torch.datasets.synthetic import SyntheticDatasetBase
from instant_nsr_pl_tpu_torch.utils.savers import save_image


def _splits(size, n_train, n_val, n_test, fov, names=("train", "val", "test")):
    """The synthetic dataset's splits ``names`` at ``size`` x ``size``."""
    cfg = config_from_dict({"size": size, "n_train": n_train, "n_val": n_val,
                            "n_test": n_test, "fov": fov})
    out = {}
    for split in names:
        ds = SyntheticDatasetBase()
        ds.setup(cfg, split)
        out[split] = ds
    return out


def _to_u8(x):
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def export_blender(root, splits, fov):
    os.makedirs(root, exist_ok=True)
    for split, ds in splits.items():
        frames = []
        for i in range(ds.all_images.shape[0]):
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3, :4] = ds.all_c2w[i]
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
            rgba = np.concatenate([_to_u8(ds.all_images[i]), _to_u8(ds.all_fg_masks[i])[..., None]],
                                  axis=-1)
            save_image(os.path.join(root, split), f"r_{i}.png", rgba)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f)
    print(f"[blender] wrote {root}", flush=True)


def export_dtu(root, splits):
    """The DTU layout holds ONE image set (the reference aliases val to
    train): the train split's views."""
    ds = splits["train"]
    h, w = ds.all_images.shape[1:3]
    focal = 0.5 * w / math.tan(0.5 * float(ds.config.get("fov", 0.8)))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float64)
    cams = {}
    for i in range(ds.all_images.shape[0]):
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, :4] = ds.all_c2w[i]
        # OpenGL (right-up-back) -> NeuS DTU (right-down-front): the loader
        # flips back with c2w[:3, 1:3] *= -1
        c2w[:3, 1:3] *= -1.0
        w2c = np.linalg.inv(c2w)
        P = np.eye(4, dtype=np.float64)
        P[:3, :4] = K @ w2c[:3, :4]
        cams[f"world_mat_{i}"] = P
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float64)
        save_image(os.path.join(root, "image"), f"{i:06d}.png", _to_u8(ds.all_images[i]))
        save_image(os.path.join(root, "mask"), f"{i:03d}.png", _to_u8(ds.all_fg_masks[i]))
    np.savez(os.path.join(root, "cameras_sphere.npz"), **cams)
    print(f"[dtu] wrote {root}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--format", default="all", choices=("all", "blender", "dtu"))
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--n-train", type=int, default=20)
    p.add_argument("--n-val", type=int, default=2)
    p.add_argument("--n-test", type=int, default=4)
    p.add_argument("--fov", type=float, default=0.8)
    args = p.parse_args(argv)

    names = ("train",) if args.format == "dtu" else ("train", "val", "test")
    splits = _splits(args.size, args.n_train, args.n_val, args.n_test, args.fov, names)
    if args.format in ("all", "blender"):
        export_blender(os.path.join(args.out, "blender"), splits, args.fov)
    if args.format in ("all", "dtu"):
        export_dtu(os.path.join(args.out, "dtu"), splits)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
