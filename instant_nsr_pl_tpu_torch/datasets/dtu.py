"""DTU multi-view stereo dataset (NeuS preprocessing).

The port's copy of ``instant_nsr_pl_tpu/datasets/dtu.py`` (the reference's
``datasets/dtu.py``): ``cameras_sphere.npz`` holds per-view ``world_mat_i``
(projection) and ``scale_mat_i`` (the normalisation that puts the object in
the unit sphere); their product is decomposed into intrinsics and pose, and
the NeuS (right-down-front) camera is flipped into the OpenGL (right-up-back)
convention (reference datasets/dtu.py:20-34,100-106). Per-view direction
grids are kept because intrinsics vary. The test split renders a spheric
trajectory through the camera cloud over blank frames, which is why the
reference calls test PSNR "meaningless" for DTU (README.md:67).

The JAX package decomposes with ``cv2.decomposeProjectionMatrix`` and reads
images with PIL; the card has neither, so :func:`load_K_Rt_from_P` repeats
OpenCV's Givens RQ decomposition in numpy (with its sign conventions) and
the images go through ``utils/image_io.py``. ``load_seconds`` holds the
split's decode and resize seconds.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from instant_nsr_pl_tpu_torch.ops.ray import get_ray_directions
from instant_nsr_pl_tpu_torch.registry import datasets
from instant_nsr_pl_tpu_torch.utils.image_io import png_size, read_png, resize_bicubic


def _givens(c, s):
    """(c, s) normalised as OpenCV's ``cvRQDecomp3x3`` does."""
    z = 1.0 / math.sqrt(c * c + s * s + np.finfo(np.float64).eps)
    return c * z, s * z


def rq_decomp3x3(m):
    """OpenCV's ``RQDecomp3x3``: (R upper triangular, Q orthogonal) with
    m = R Q, by Givens rotations about x, y and z. R[1, 1] comes out >= 0;
    a negative R[0, 0] is made positive by a rotation of 180 degrees about
    y, as OpenCV does (its other two sign cases cannot arise)."""
    m = np.asarray(m, np.float64)
    c, s = _givens(m[2, 2], m[2, 1])
    qx = np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    r = m @ qx
    r[2, 1] = 0.0
    c, s = _givens(r[2, 2], -r[2, 0])
    qy = np.array([[c, 0, -s], [0, 1.0, 0], [s, 0, c]])
    m2 = r @ qy
    m2[2, 0] = 0.0
    c, s = _givens(m2[1, 1], m2[1, 0])
    qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    r = m2 @ qz
    r[1, 0] = 0.0
    if r[0, 0] < 0:
        r[0, 0] *= -1
        r[0, 2] *= -1
        r[1, 2] *= -1
        r[2, 2] *= -1
        qz = qz.T.copy()
        qy[0, 0] *= -1
        qy[0, 2] *= -1
        qy[2, 0] *= -1
        qy[2, 2] *= -1
    q = (qz.T @ qy.T) @ qx.T
    return r, q


def load_K_Rt_from_P(P):
    """Decompose a 3x4 projection into (intrinsics 4x4, c2w pose 4x4) as
    ``cv2.decomposeProjectionMatrix`` followed by the reference's
    normalisation: K / K[2, 2], the pose's rotation R^T and its centre, the
    null vector of P (OpenCV's ``t[:3] / t[3]``, here solved directly)."""
    P = np.asarray(P, np.float64)
    K, R = rq_decomp3x3(P[:, :3])
    K = K / K[2, 2]
    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])
    return intrinsics, pose


def create_spheric_poses(cam_positions, n_steps=120):
    """Circular c2w trajectory through the camera cloud looking at the
    origin (reference datasets/dtu.py:36-56)."""
    cams = np.asarray(cam_positions, np.float64)
    center = np.zeros(3)
    mean = cams.mean(0)
    cam_center = mean / np.linalg.norm(mean) * np.linalg.norm(mean)
    _eigvals, eigvecs = np.linalg.eig(cams.T @ cams)
    rot_axis = np.real(eigvecs[:, 1])
    rot_axis = rot_axis / np.linalg.norm(rot_axis)
    up = rot_axis
    rot_dir = np.cross(rot_axis, cam_center)
    unit_cams = cams / np.linalg.norm(cams, axis=-1, keepdims=True)
    unit_c = cam_center / np.linalg.norm(cam_center)
    max_angle = np.arccos(np.clip((unit_cams * unit_c).sum(-1), -1, 1)).max()

    all_c2w = []
    for theta in np.linspace(-max_angle, max_angle, n_steps):
        pos = cam_center * math.cos(theta) + rot_dir * math.sin(theta)
        look = center - pos
        look = look / np.linalg.norm(look)
        s = np.cross(look, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, look)
        u = u / np.linalg.norm(u)
        c2w = np.concatenate([np.stack([s, u, -look], axis=1), pos[:, None]], axis=1)
        all_c2w.append(c2w.astype(np.float32))
    return np.stack(all_c2w)


VAL_NOTE = ("[dtu] note: the val split aliases the TRAINING images (reference behavior) — "
            "val metrics are train-set metrics")


class DTUDatasetBase:
    def setup(self, config, split, images_of=None):
        """Load ``split``. ``images_of``: a loaded split whose images and
        masks this one shares (the val split aliases the training images)."""
        self.config = config
        self.split = split

        cams = np.load(os.path.join(config.root_dir, config.get("cameras_file",
                                                                "cameras_sphere.npz")))

        W, H = png_size(os.path.join(config.root_dir, "image", "000000.png"))
        if "img_wh" in config:
            w, h = tuple(config["img_wh"])
            assert round(W / w * h) == H
        elif "img_downscale" in config:
            d = float(config.img_downscale)
            w, h = int(W / d + 0.5), int(H / d + 0.5)
        else:
            raise ValueError("specify img_wh or img_downscale")
        self.w, self.h = w, h
        self.img_wh = (w, h)
        factor = w / W

        self.has_mask = True
        self.apply_mask = bool(config.get("apply_mask", True))

        n_images = max(int(k.split("_")[-1]) for k in cams.keys()) + 1

        decode_s = resize_s = 0.0
        directions, all_c2w, images, masks = [], [], [], []
        for i in range(n_images):
            P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
            K, c2w = load_K_Rt_from_P(P)
            fx, fy = K[0, 0] * factor, K[1, 1] * factor
            cx, cy = K[0, 2] * factor, K[1, 2] * factor
            directions.append(get_ray_directions(w, h, fx, fy, cx, cy))
            # NeuS DTU (right-down-front) -> OpenGL (right-up-back)
            c2w = c2w.copy()
            c2w[:3, 1:3] *= -1.0
            all_c2w.append(c2w[:3, :4])

            if split in ("train", "val"):
                if split == "val" and i == 0:
                    # the reference's val split loads the training images:
                    # "val PSNR" on DTU runs is train-set PSNR
                    print(VAL_NOTE, flush=True)
                if images_of is not None:
                    continue
                t0 = time.perf_counter()
                img, mode = read_png(os.path.join(config.root_dir, "image", f"{i:06d}.png"))
                mask, _ = read_png(os.path.join(config.root_dir, "mask", f"{i:03d}.png"),
                                   convert="L")
                t1 = time.perf_counter()
                if mode not in ("L", "LA", "RGB", "RGBA"):
                    raise ValueError(f"{config.root_dir}: no bicubic resize of a {mode!r} image")
                img = resize_bicubic(img, self.img_wh)
                mask = resize_bicubic(mask, self.img_wh)
                resize_s += time.perf_counter() - t1
                decode_s += t1 - t0
                images.append(np.asarray(img, np.float32)[..., :3] / 255.0)
                masks.append(np.asarray(mask, np.float32) / 255.0)

        self.all_c2w = np.stack(all_c2w)
        if split == "test":
            n_steps = int(config.get("n_test_traj_steps", 60))
            self.all_c2w = create_spheric_poses(self.all_c2w[:, :, 3], n_steps)
            self.all_images = np.zeros((n_steps, h, w, 3), np.float32)
            self.all_fg_masks = np.zeros((n_steps, h, w), np.float32)
            self.directions = directions[0]
        else:
            if images_of is not None:
                self.all_images, self.all_fg_masks = images_of.all_images, images_of.all_fg_masks
            else:
                self.all_images = np.stack(images)
                self.all_fg_masks = np.stack(masks)
            self.directions = np.stack(directions)
        self.load_seconds = {"decode": decode_s, "resize": resize_s}


@datasets.register("dtu")
class DTUDataModule:
    def __init__(self, config):
        self.config = config
        self._splits = {}

    def setup(self, stage=None):
        wanted = {
            "fit": ["train", "val"],
            "validate": ["val"],
            "test": ["test"],
            # the reference's predict renders the TRAIN split (dtu.py:175-176)
            "predict": ["train"],
        }.get(stage or "fit")
        for split in wanted:
            if split not in self._splits:
                ds = DTUDatasetBase()
                # val and train hold the same images: read them once
                other = self._splits.get({"train": "val", "val": "train"}.get(split))
                ds.setup(self.config, split, images_of=other)
                self._splits[split] = ds

    def split(self, name):
        return self._splits[name]

    @property
    def train(self):
        return self._splits["train"]

    @property
    def val(self):
        return self._splits["val"]

    @property
    def test(self):
        return self._splits["test"]

    @property
    def predict(self):
        return self._splits["train"]
