"""COLMAP sparse-reconstruction binary readers.

The port's copy of ``instant_nsr_pl_tpu/datasets/colmap_utils.py:43-122``:
readers for the documented COLMAP binary format (``cameras.bin`` /
``images.bin`` / ``points3D.bin``, https://colmap.github.io/format.html), the
role the reference fills with its vendored reader (reference
datasets/colmap_utils.py:107-296), and ``qvec2rotmat``. numpy only.
"""

from __future__ import annotations

import collections
import struct

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage",
    ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"],
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)

# model id -> (name, num params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * n_pts), dtype=[("xy", "<f8", 2), ("id", "<i8")]
            )
            images[image_id] = ColmapImage(
                image_id,
                qvec,
                tvec,
                camera_id,
                name.decode("utf-8"),
                np.array(data["xy"]),
                np.array(data["id"]),
            )
    return images


def read_points3d_binary(path):
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            error = vals[7]
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(
                f.read(8 * track_len), dtype=[("image_id", "<i4"), ("p2d", "<i4")]
            )
            pts[pid] = Point3D(
                pid, xyz, rgb, error,
                np.array(track["image_id"]), np.array(track["p2d"]),
            )
    return pts


def qvec2rotmat(qvec):
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )
