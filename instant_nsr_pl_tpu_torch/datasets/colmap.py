"""COLMAP captures (e.g. MipNeRF-360 unbounded scenes).

The port's copy of ``instant_nsr_pl_tpu/datasets/colmap.py:31-337`` (the
reference's ``datasets/colmap.py:20-130,142-268``): reads
``sparse/0/{cameras,images,points3D}.bin``, takes SIMPLE_RADIAL / PINHOLE /
OPENCV intrinsics (distortion ignored, as in the reference), normalises world
space (the centre from the cameras, the look-at ray intersections or a robust
foreground point centre; up from the camera cloud or a seeded RANSAC ground
plane), turns up to +z, scales so that the nearest camera sits at distance 1,
and renders the test split along a circular path. Poses and images are
parsed once per ``root_dir`` and shared by the splits (the class-level
``_cache``, reference colmap.py:133-135); the val split is the training
images, and the test split's frames are blank.

Images are read with the port's PNG decoder and resized as Pillow's BICUBIC
does in the image's own mode (``utils/image_io.py``; the card has no PIL);
masks (``masks/``) are converted to luma first. Real COLMAP captures are
mostly JPEG: the port has no JPEG decoder yet (ROADMAP.md queue 1, the JPEG
item), so any image that is not a PNG raises a ValueError naming the file.
``load_seconds`` holds the parse's decode and resize seconds.
"""

from __future__ import annotations

import math
import os
import time
import warnings

import numpy as np

from instant_nsr_pl_tpu_torch.datasets.colmap_utils import (
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from instant_nsr_pl_tpu_torch.ops.ray import get_ray_directions
from instant_nsr_pl_tpu_torch.registry import datasets
from instant_nsr_pl_tpu_torch.utils.image_io import read_png, resize_bicubic

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
VAL_NOTE = ("[colmap] note: the val split aliases the TRAINING images (reference behavior) "
            "— val metrics are train-set metrics")


def _normalize(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def get_center(pts):
    """Robust inlier centre (reference datasets/colmap.py:20-27)."""
    center = pts.mean(0)
    dis = np.linalg.norm(pts - center[None, :], axis=-1)
    mean, std = dis.mean(), dis.std()
    q25, q75 = np.quantile(dis, 0.25), np.quantile(dis, 0.75)
    valid = (
        (dis > mean - 1.5 * std)
        & (dis < mean + 1.5 * std)
        & (dis > mean - (q75 - q25) * 1.5)
        & (dis < mean + (q75 - q25) * 1.5)
    )
    return pts[valid].mean(0)


def ransac_plane(pts, thresh=0.01, iters=256, seed=0):
    """Plane (A, B, C, D) with the most inliers within ``thresh`` over
    ``iters`` seeded three-point draws (the pyransac3d.Plane role)."""
    rng = np.random.RandomState(seed)
    n = pts.shape[0]
    best_eq, best_count = None, -1
    for _ in range(iters):
        ids = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[ids]
        normal = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(normal)
        if nn < 1e-12:
            continue
        normal = normal / nn
        d = -normal.dot(p0)
        count = int((np.abs(pts @ normal + d) < thresh).sum())
        if count > best_count:
            best_count = count
            best_eq = np.array([*normal, d])
    return best_eq


def _lookat_center(poses):
    """Mean of the least-squares closest points of consecutive camera-axis
    pairs."""
    cams_ori = poses[..., 3]
    cams_dir = _normalize(poses[:, :3, :3] @ np.array([0.0, 0.0, -1.0]))
    rolled_dir = np.roll(cams_dir, 1, axis=0)
    rolled_ori = np.roll(cams_ori, 1, axis=0)
    A = np.stack([cams_dir, -rolled_dir], axis=-1)  # (N, 3, 2)
    b = -cams_ori + rolled_ori
    t = np.stack([np.linalg.lstsq(A[i], b[i], rcond=None)[0] for i in range(len(A))])
    return (np.stack([cams_dir, rolled_dir], axis=-1) * t[:, None, :]
            + np.stack([cams_ori, rolled_ori], axis=-1)).mean(axis=(0, 2))


def _up(poses, pts, center, up_est_method):
    if up_est_method == "ground":
        plane_eq = ransac_plane(pts, thresh=0.01)
        z = _normalize(plane_eq[:3])
        signed = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ plane_eq
        return -z if signed.mean() < 0 else z
    if up_est_method == "camera":
        v = (poses[..., 3] - center).mean(0)
        if np.linalg.norm(v) < 1e-6:
            # a capture symmetric about its centre: the reference's formula
            # (colmap.py:62) normalises ~0; fall back to world +z, loudly
            warnings.warn("up_est_method=camera degenerated (camera positions are symmetric "
                          "about the center); falling back to +z up")
            return np.array([0.0, 0.0, 1.0])
        return _normalize(v, axis=0)
    raise ValueError(f"Unknown up estimation method: {up_est_method}")


def _transform(inv_trans, poses, pts):
    homo = np.concatenate(
        [poses, np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (len(poses), 1, 1))], axis=1)
    poses_n = (inv_trans @ homo)[:, :3]
    pts_n = (inv_trans @ np.concatenate([pts, np.ones_like(pts[:, :1])], -1)[..., None])[:, :3, 0]
    return poses_n, pts_n


def normalize_poses(poses, pts, up_est_method, center_est_method):
    """World-space normalisation (reference datasets/colmap.py:29-110), in
    float64, returned as float32 (poses (N, 3, 4), points (M, 3))."""
    poses = np.asarray(poses, np.float64)
    pts = np.asarray(pts, np.float64)
    if center_est_method in ("camera", "point"):
        center = poses[..., 3].mean(0)
    elif center_est_method == "lookat":
        center = _lookat_center(poses)
    else:
        raise ValueError(f"Unknown center estimation method: {center_est_method}")

    z = _up(poses, pts, center, up_est_method)
    y_ = np.array([z[1], -z[0], 0.0])
    if np.linalg.norm(y_) < 1e-6:
        # up already along +-z: any horizontal axis works
        y_ = np.array([1.0, 0.0, 0.0])
    x = _normalize(np.cross(y_, z), axis=0)
    y = np.cross(z, x)
    Rc = np.stack([x, y, z], axis=1)
    inv = np.eye(4)
    inv[:3, :3] = Rc.T
    if center_est_method == "point":
        # rotate, then translate by the robust foreground point centre
        poses_n, pts = _transform(inv, poses, pts)
        pmin, pmax = poses_n[..., 3].min(0), poses_n[..., 3].max(0)
        fg = pts[(pmin[0] < pts[:, 0]) & (pts[:, 0] < pmax[0])
                 & (pmin[1] < pts[:, 1]) & (pts[:, 1] < pmax[1])]
        center = get_center(fg if len(fg) else pts)
        inv = np.eye(4)
        inv[:3, 3] = -center
        poses_n, pts = _transform(inv, poses_n, pts)
    else:
        inv[:3, 3] = (-Rc.T @ center.reshape(3, 1))[:, 0]
        poses_n, pts = _transform(inv, poses, pts)

    scale = np.linalg.norm(poses_n[..., 3], axis=-1).min()
    poses_n[..., 3] /= scale
    pts = pts / scale
    return poses_n.astype(np.float32), pts.astype(np.float32)


def create_spheric_poses(cameras, n_steps=120):
    """Circular path at the cameras' mean height and distance looking at the
    origin (reference datasets/colmap.py:112-130)."""
    cams = np.asarray(cameras, np.float64)
    mean_d = np.linalg.norm(cams, axis=-1).mean()
    mean_h = cams[:, 2].mean()
    r = math.sqrt(max(mean_d**2 - mean_h**2, 1e-12))
    up = np.array([0.0, 0.0, 1.0])
    all_c2w = []
    for theta in np.linspace(0, 2 * math.pi, n_steps):
        pos = np.array([r * math.cos(theta), r * math.sin(theta), mean_h])
        look = _normalize(-pos, axis=0)
        s = _normalize(np.cross(look, up), axis=0)
        u = _normalize(np.cross(s, look), axis=0)
        c2w = np.concatenate([np.stack([s, u, -look], 1), pos[:, None]], axis=1)
        all_c2w.append(c2w.astype(np.float32))
    return np.stack(all_c2w)


def _read_image(path, convert=None):
    """``(array, mode)`` of a PNG (``read_png``); any other file raises."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG; the port reads PNG images only (a JPEG decoder "
                         "is queued in ROADMAP.md queue 1, the JPEG item)")
    return read_png(path, convert=convert)


def _intrinsics(cam, factor):
    if cam.model == "SIMPLE_RADIAL":
        fx = fy = cam.params[0] * factor
        cx, cy = cam.params[1] * factor, cam.params[2] * factor
    elif cam.model in ("PINHOLE", "OPENCV"):
        fx, fy = cam.params[0] * factor, cam.params[1] * factor
        cx, cy = cam.params[2] * factor, cam.params[3] * factor
    else:
        raise ValueError(f"Unsupported camera model {cam.model}")
    return fx, fy, cx, cy


def _load(config):
    """Parse and normalise a capture: the properties its splits share."""
    root = config.root_dir
    camdata = read_cameras_binary(os.path.join(root, "sparse/0/cameras.bin"))
    cam = camdata[min(camdata.keys())]
    H, W = int(cam.height), int(cam.width)
    if "img_wh" in config:
        w, h = tuple(config["img_wh"])
        assert round(W / w * h) == H
    elif "img_downscale" in config:
        d = float(config.img_downscale)
        w, h = int(W / d + 0.5), int(H / d + 0.5)
    else:
        raise ValueError("specify img_wh or img_downscale")
    factor = w / W
    directions = get_ray_directions(w, h, *_intrinsics(cam, factor))

    imdata = read_images_binary(os.path.join(root, "sparse/0/images.bin"))
    mask_dir = os.path.join(root, "masks")
    has_mask = os.path.exists(mask_dir)
    decode_s = resize_s = 0.0
    all_c2w, images, masks = [], [], []
    for d in imdata.values():
        R = qvec2rotmat(d.qvec)
        t = d.tvec.reshape(3, 1)
        c2w = np.concatenate([R.T, -R.T @ t], axis=1).astype(np.float32)
        c2w[:, 1:3] *= -1.0  # COLMAP -> OpenGL
        all_c2w.append(c2w)

        t0 = time.perf_counter()
        img, mode = _read_image(os.path.join(root, "images", d.name))
        mask = None
        if has_mask:
            cands = [os.path.join(mask_dir, d.name), os.path.join(mask_dir, d.name[3:])]
            mask, _ = _read_image([p for p in cands if os.path.exists(p)][0], convert="L")
        t1 = time.perf_counter()
        if mode not in ("L", "LA", "RGB", "RGBA"):
            raise ValueError(f"{d.name}: no bicubic resize of a {mode!r} image")
        images.append(np.asarray(resize_bicubic(img, (w, h)), np.float32)[..., :3] / 255.0)
        if mask is None:
            masks.append(np.ones((h, w), np.float32))
        else:
            masks.append(np.asarray(resize_bicubic(mask, (w, h)), np.float32) / 255.0)
        resize_s += time.perf_counter() - t1
        decode_s += t1 - t0

    pts3d_map = read_points3d_binary(os.path.join(root, "sparse/0/points3D.bin"))
    pts3d = np.array([p.xyz for p in pts3d_map.values()], np.float32)
    all_c2w, pts3d = normalize_poses(np.stack(all_c2w), pts3d,
                                     up_est_method=config.up_est_method,
                                     center_est_method=config.center_est_method)
    return {
        "w": w, "h": h, "factor": factor,
        "has_mask": has_mask, "apply_mask": has_mask and bool(config.get("apply_mask", False)),
        "directions": directions, "pts3d": pts3d, "all_c2w": all_c2w,
        "all_images": np.stack(images), "all_fg_masks": np.stack(masks),
        "load_seconds": {"decode": decode_s, "resize": resize_s},
    }


class ColmapDatasetBase:
    # one parse and normalisation shared by all splits (reference colmap.py:133-135)
    _cache = {}

    def setup(self, config, split):
        self.config = config
        self.split = split
        key = str(config.root_dir)
        fresh = key not in ColmapDatasetBase._cache
        if fresh:
            ColmapDatasetBase._cache[key] = _load(config)
        props = ColmapDatasetBase._cache[key]
        for k, v in props.items():
            setattr(self, k, v)
        if not fresh:  # the split read nothing
            self.load_seconds = {"decode": 0.0, "resize": 0.0}
        self.img_wh = (self.w, self.h)
        if split == "val":
            # the reference's colmap has no held-out split
            print(VAL_NOTE, flush=True)
        if split == "test":
            n_steps = int(config.get("n_test_traj_steps", 120))
            self.all_c2w = create_spheric_poses(props["all_c2w"][:, :, 3], n_steps)
            self.all_images = np.zeros((n_steps, self.h, self.w, 3), np.float32)
            self.all_fg_masks = np.zeros((n_steps, self.h, self.w), np.float32)


@datasets.register("colmap")
class ColmapDataModule:
    def __init__(self, config):
        self.config = config
        self._splits = {}

    def setup(self, stage=None):
        wanted = {
            "fit": ["train", "val"],
            "validate": ["val"],
            "test": ["test"],
            # the reference's predict renders the TRAIN split (colmap.py:306-307)
            "predict": ["train"],
        }.get(stage or "fit")
        for split in wanted:
            if split not in self._splits:
                ds = ColmapDatasetBase()
                ds.setup(self.config, split)
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
