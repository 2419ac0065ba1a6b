"""Export the procedural sphere scene as on-disk datasets in the reference's
input formats, so the port's real loaders (``datasets/blender.py``,
``datasets/dtu.py``) run end to end through the launcher without downloaded
data. The port's copy of ``scripts/make_synthetic_data.py`` (PNGs written by
``utils/savers.py``, without PIL).

- **blender** (NeRF-Synthetic layout, reference datasets/blender.py:27-48):
  ``transforms_{train,val,test}.json`` with ``camera_angle_x`` and a 4x4
  OpenGL ``transform_matrix`` per frame, RGBA PNGs whose alpha is the
  foreground mask.
- **dtu** (NeuS preprocessing layout, reference datasets/dtu.py:20-34):
  ``cameras_sphere.npz`` with per-view ``world_mat_i`` (K @ w2c in the NeuS
  right-down-front convention) and identity ``scale_mat_i`` (the scene is
  already inside the unit sphere), ``image/%06d.png`` and ``mask/%03d.png``,
  the train split's views.
- **colmap** (COLMAP sparse reconstruction, reference datasets/colmap.py:
  143-208; JAX ``scripts/make_synthetic_data.py:118-182``):
  ``sparse/0/{cameras,images,points3D}.bin`` with one shared PINHOLE camera,
  ``images/img_%04d.png`` (the train split's views, RGB) and 3D points drawn
  on the analytic spheres' surfaces with a seeded ``RandomState``. With
  ``--backdrop R`` the background is not white but a textured sphere of
  radius R around the scene (an unbounded capture's far surroundings, which
  a learned background model can take on); the JAX script has no such
  option, so its default (white, ``--backdrop 0``) is the same export.

    python -m instant_nsr_pl_tpu_torch.tools.make_synthetic_data --out exp/data \
        [--format all|blender|dtu|colmap] [--size 128] [--n-train 20] [--n-val 2] \
        [--n-test 4] [--backdrop 0]

writes ``<out>/blender``, ``<out>/dtu`` and / or ``<out>/colmap``. It runs on
the CPU (numpy).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct

import numpy as np

from instant_nsr_pl_tpu_torch.config import config_from_dict
from instant_nsr_pl_tpu_torch.datasets.synthetic import _DEFAULT_SPHERES, SyntheticDatasetBase
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


def _rotmat_to_qvec(R):
    qw = math.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
    return np.array([qw, (R[2, 1] - R[1, 2]) / (4 * qw), (R[0, 2] - R[2, 0]) / (4 * qw),
                     (R[1, 0] - R[0, 1]) / (4 * qw)])


def backdrop_colours(origins, dirs, radius):
    """The colours (N, 3) where rays from ``origins`` (N, 3), inside a sphere
    of ``radius`` about the origin, leave it along unit ``dirs``: smooth
    colour bands over longitude and latitude with a checker on them."""
    b = (origins * dirs).sum(-1)
    t = -b + np.sqrt(b * b - ((origins * origins).sum(-1) - radius * radius))
    p = (origins + t[:, None] * dirs) / radius
    lon = np.arctan2(p[:, 1], p[:, 0])[:, None]
    lat = np.arcsin(np.clip(p[:, 2], -1.0, 1.0))[:, None]
    bands = 0.5 + 0.3 * np.sin(3.0 * lon + np.array([0.0, 2.1, 4.2])) * np.cos(2.0 * lat)
    checker = 0.12 * np.sign(np.sin(6.0 * lon) * np.sin(6.0 * lat))
    return np.clip(bands + checker, 0.0, 1.0).astype(np.float32)


def _with_backdrop(ds, i, radius):
    """View ``i`` of ``ds`` with its background pixels (mask 0) coloured by
    ``backdrop_colours``."""
    c2w = ds.all_c2w[i].astype(np.float64)
    dirs = ds.directions.reshape(-1, 3).astype(np.float64) @ c2w[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    back = backdrop_colours(np.broadcast_to(c2w[:3, 3], dirs.shape), dirs, radius)
    mask = ds.all_fg_masks[i].reshape(-1, 1) > 0.5
    return np.where(mask, ds.all_images[i].reshape(-1, 3), back).reshape(ds.all_images[i].shape)


def export_colmap(root, splits, fov, backdrop=0.0):
    """The COLMAP layout of the train split's views: one PINHOLE camera, the
    OpenGL poses turned into COLMAP's right-down-front world-to-camera
    quaternion and translation, and 120 points on each analytic sphere (the
    ``point`` centre estimator's foreground). A ``backdrop`` radius > 0
    colours the background with ``backdrop_colours``."""
    ds = splits["train"]
    os.makedirs(os.path.join(root, "sparse/0"), exist_ok=True)
    h, w = ds.all_images.shape[1:3]
    focal = 0.5 * w / math.tan(0.5 * fov)
    with open(os.path.join(root, "sparse/0/cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))  # PINHOLE, model id 1
        f.write(struct.pack("<4d", focal, focal, w / 2.0, h / 2.0))
    with open(os.path.join(root, "sparse/0/images.bin"), "wb") as f:
        f.write(struct.pack("<Q", ds.all_images.shape[0]))
        for i in range(ds.all_images.shape[0]):
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3, :4] = ds.all_c2w[i]
            c2w[:3, 1:3] *= -1.0  # OpenGL (right-up-back) -> COLMAP (right-down-front)
            w2c = np.linalg.inv(c2w)
            f.write(struct.pack("<idddddddi", i + 1, *_rotmat_to_qvec(w2c[:3, :3]),
                                *w2c[:3, 3], 1))
            f.write(f"img_{i:04d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
            rgb = _with_backdrop(ds, i, backdrop) if backdrop > 0 else ds.all_images[i]
            save_image(os.path.join(root, "images"), f"img_{i:04d}.png", _to_u8(rgb))
    rng = np.random.RandomState(0)
    pts = []
    for c, r, _a in _DEFAULT_SPHERES:
        d = rng.randn(120, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts.append(np.asarray(c) + r * d)
    pts = np.concatenate(pts, axis=0)
    with open(os.path.join(root, "sparse/0/points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, p in enumerate(pts):
            f.write(struct.pack("<QdddBBBd", i, *p, 128, 128, 128, 0.5))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))
    print(f"[colmap] wrote {root}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--format", default="all", choices=("all", "blender", "dtu", "colmap"))
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--n-train", type=int, default=20)
    p.add_argument("--n-val", type=int, default=2)
    p.add_argument("--n-test", type=int, default=4)
    p.add_argument("--fov", type=float, default=0.8)
    p.add_argument("--backdrop", type=float, default=0.0,
                   help="COLMAP only: radius of a textured sphere around the scene that "
                        "colours the background (0: white, as the JAX script writes)")
    args = p.parse_args(argv)

    names = ("train",) if args.format in ("dtu", "colmap") else ("train", "val", "test")
    splits = _splits(args.size, args.n_train, args.n_val, args.n_test, args.fov, names)
    if args.format in ("all", "blender"):
        export_blender(os.path.join(args.out, "blender"), splits, args.fov)
    if args.format in ("all", "dtu"):
        export_dtu(os.path.join(args.out, "dtu"), splits)
    if args.format in ("all", "colmap"):
        export_colmap(os.path.join(args.out, "colmap"), splits, args.fov, args.backdrop)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
