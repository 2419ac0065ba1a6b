"""NeRF-Synthetic (Blender) dataset.

The port's copy of ``instant_nsr_pl_tpu/datasets/blender.py`` (the
reference's ``datasets/blender.py``, BlenderDatasetBase at 27-85): parses
``transforms_{split}.json``, focal from ``camera_angle_x``, loads the PNGs
(an RGBA image's alpha becomes the foreground mask, an RGB image's mask is
ones) and shares one per-pixel direction grid across views. Images are read
and resized by ``utils/image_io.py`` (PIL's decoder and ``Image.BICUBIC``,
bit for bit) because the card has no PIL. Arrays stay in host numpy; the
system moves them to the device once in ``setup_data``. ``load_seconds``
holds the split's decode and resize seconds.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

from instant_nsr_pl_tpu_torch.ops.ray import get_ray_directions
from instant_nsr_pl_tpu_torch.registry import datasets
from instant_nsr_pl_tpu_torch.utils.image_io import read_png, resize_bicubic


class BlenderDatasetBase:
    def setup(self, config, split):
        self.config = config
        self.split = split

        with open(os.path.join(config.root_dir, f"transforms_{split}.json")) as f:
            meta = json.load(f)

        if "w" in meta and "h" in meta:
            W, H = int(meta["w"]), int(meta["h"])
        else:
            W, H = 800, 800

        if "img_wh" in config:
            w, h = tuple(config["img_wh"])
        elif "img_downscale" in config:
            w, h = W // int(config.img_downscale), H // int(config.img_downscale)
        else:
            raise ValueError("specify img_wh or img_downscale")
        assert round(W / w * h) == H, "aspect ratio must be preserved"

        self.w, self.h = w, h
        self.img_wh = (w, h)
        self.near, self.far = float(config.get("near_plane", 2.0)), float(
            config.get("far_plane", 6.0))
        self.focal = 0.5 * w / math.tan(0.5 * float(meta["camera_angle_x"]))

        self.has_mask = True
        self.apply_mask = True

        # shared direction grid (intrinsics identical across views)
        self.directions = get_ray_directions(w, h, self.focal, self.focal, w / 2, h / 2)

        decode_s = resize_s = 0.0
        c2w_list, img_list, mask_list = [], [], []
        for frame in meta["frames"]:
            c2w_list.append(np.array(frame["transform_matrix"], np.float32)[:3, :4])
            t0 = time.perf_counter()
            path = os.path.join(config.root_dir, f"{frame['file_path']}.png")
            img, mode = read_png(path)
            t1 = time.perf_counter()
            if (img.shape[1], img.shape[0]) != (w, h):
                if mode not in ("L", "LA", "RGB", "RGBA"):
                    raise ValueError(f"{path}: no bicubic resize of a {mode!r} image")
                img = resize_bicubic(img, (w, h))
            resize_s += time.perf_counter() - t1
            decode_s += t1 - t0
            img = np.asarray(img, np.float32) / 255.0  # (h, w, 4)
            if img.shape[-1] == 4:
                mask = img[..., 3]
                rgb = img[..., :3]
            else:
                mask = np.ones(img.shape[:2], np.float32)
                rgb = img[..., :3]
            img_list.append(rgb)
            mask_list.append(mask)

        self.all_c2w = np.stack(c2w_list)
        self.all_images = np.stack(img_list)
        self.all_fg_masks = np.stack(mask_list)
        self.load_seconds = {"decode": decode_s, "resize": resize_s}


@datasets.register("blender")
class BlenderDataModule:
    """The splits, as the reference's LightningDataModule names them
    (datasets/blender.py:96-135), without the DataLoader: ray batching
    happens on the device inside the system."""

    def __init__(self, config):
        self.config = config
        self._splits = {}

    def setup(self, stage=None):
        cfg = self.config
        wanted = {
            "fit": [cfg.get("train_split", "train"), cfg.get("val_split", "val")],
            "validate": [cfg.get("val_split", "val")],
            "test": [cfg.get("test_split", "test")],
            # the reference's predict renders the TRAIN split's views
            # (datasets/blender.py:109-110)
            "predict": [cfg.get("train_split", "train")],
        }.get(stage or "fit")
        for split in wanted:
            if split not in self._splits:
                ds = BlenderDatasetBase()
                ds.setup(cfg, split)
                self._splits[split] = ds

    def split(self, name):
        return self._splits[name]

    @property
    def train(self):
        return self._splits[self.config.get("train_split", "train")]

    @property
    def val(self):
        return self._splits[self.config.get("val_split", "val")]

    @property
    def test(self):
        return self._splits[self.config.get("test_split", "test")]

    @property
    def predict(self):
        return self._splits[self.config.get("train_split", "train")]
