"""Artifact savers: image panels and grids, PNG frames and their sequence,
OBJ meshes and JSON.

The port's own copy of ``instant_nsr_pl_tpu/utils/savers.py`` (the
reference's ``SaverMixin``, utils/mixins.py:16-229), as free functions keyed
off an explicit ``save_dir``. The machine with the card has neither ``cv2``
nor ``PIL``, so PNGs go through a writer of this module's own (stdlib
``zlib`` and ``struct``), and the jet and magma colormaps are 256-entry
lookup tables equal to OpenCV's ``COLORMAP_JET`` and ``COLORMAP_MAGMA``.
:func:`save_img_sequence` assembles an mp4 (``cv2``) or a gif (``PIL``) where
that module imports, and otherwise says so on one line and leaves the PNG
frames. Everything here runs on the host.
"""

from __future__ import annotations

import json
import os
import re
import struct
import zlib

import numpy as np

# OpenCV's COLORMAP_JET and COLORMAP_MAGMA, entry g = the RGB colour of grey
# level g (cv2.applyColorMap on np.arange(256), BGR reversed)
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000e000"
    "00e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff0010ff0014ff"
    "0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048"
    "ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff00"
    "7cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff00acff"
    "00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcff00e0"
    "ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff02fffe06fffa0afff60efff212ffee16"
    "ffea1affe61effe222ffde26ffda2affd62effd232ffce36ffca3affc63effc242ffbe46ffba"
    "4affb64effb252ffae56ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff"
    "867eff8282ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56ae"
    "ff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22"
    "e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec"
    "00ffe800ffe400ffe000ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ff"
    "b800ffb400ffb000ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800"
    "ff8400ff8000ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff"
    "2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000bc00"
    "00b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c000088"
    "0000840000800000"
)
_MAGMA_HEX = (
    "00000401000501010601010802010902020b02020d03030f0303120404140504160605180605"
    "1a07061c08071e0907200a08220b09240c09260d0a290e0b2b100b2d110c2f120d31130d3414"
    "0e36150e38160f3b180f3d19103f1a10421c10441d11471e114920114b21114e221150241253"
    "25125527125829115a2a115c2c115f2d11612f116331116533106734106936106b38106c390f"
    "6e3b0f703d0f713f0f72400f74420f75440f764510774710784910784a10794c117a4e117b4f"
    "127b51127c52137c54137d56147d57157e59157e5a167e5c167f5d177f5f187f601880621980"
    "641a80651a80671b80681c816a1c816b1d816d1d816e1e81701f81721f817320817521817621"
    "817822817922827b23827c23827e24828025828125818326818426818627818827818928818b"
    "29818c29818e2a81902a81912b81932b80942c80962c80982d80992d809b2e7f9c2e7f9e2f7f"
    "a02f7fa1307ea3307ea5317ea6317da8327daa337dab337cad347cae347bb0357bb2357bb336"
    "7ab5367ab73779b83779ba3878bc3978bd3977bf3a77c03a76c23b75c43c75c53c74c73d73c8"
    "3e73ca3e72cc3f71cd4071cf4070d0416fd2426fd3436ed5446dd6456cd8456cd9466bdb476a"
    "dc4869de4968df4a68e04c67e24d66e34e65e44f64e55064e75263e85362e95462ea5661eb57"
    "60ec5860ed5a5fee5b5eef5d5ef05f5ef1605df2625df2645cf3655cf4675cf4695cf56b5cf6"
    "6c5cf66e5cf7705cf7725cf8745cf8765cf9785df9795df97b5dfa7d5efa7f5efa815ffb835f"
    "fb8560fb8761fc8961fc8a62fc8c63fc8e64fc9065fd9266fd9467fd9668fd9869fd9a6afd9b"
    "6bfe9d6cfe9f6dfea16efea36ffea571fea772fea973feaa74feac76feae77feb078feb27afe"
    "b47bfeb67cfeb77efeb97ffebb81febd82febf84fec185fec287fec488fec68afec88cfeca8d"
    "fecc8ffecd90fecf92fed194fed395fed597fed799fed89afdda9cfddc9efddea0fde0a1fde2"
    "a3fde3a5fde5a7fde7a9fde9aafdebacfcecaefceeb0fcf0b2fcf2b4fcf4b6fcf6b8fcf7b9fc"
    "f9bbfcfbbdfcfdbf"
)
_COLORMAPS = {
    name: np.frombuffer(bytes.fromhex("".join(hx)), np.uint8).reshape(256, 3)
    for name, hx in (("jet", _JET_HEX), ("magma", _MAGMA_HEX))
}


def _ensure_dir(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _to_u8(img):
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return img


def _apply_colormap(gray_u8, cmap):
    if cmap is None:
        return np.repeat(gray_u8[..., None], 3, axis=-1)
    return _COLORMAPS[cmap][gray_u8]


def rgb_to_panel(img, data_range=(0, 1)):
    """(H, W, 3) float -> uint8 RGB panel."""
    lo, hi = data_range
    x = (np.asarray(img, np.float32) - lo) / max(hi - lo, 1e-8)
    return _to_u8(x)


def grayscale_to_panel(img, cmap="jet", data_range=None):
    """(H, W) or (H, W, 1) float -> uint8 RGB panel through ``cmap`` ('jet',
    'magma' or None for grey). ``data_range=None`` normalizes by the image's
    own min/max (the reference's behavior for depth panels)."""
    x = np.asarray(img, np.float32)
    if x.ndim == 3:
        x = x[..., 0]
    if data_range is None:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = data_range
    x = (x - lo) / max(hi - lo, 1e-8)
    return _apply_colormap(_to_u8(x), cmap)


def normal_to_panel(img):
    """(H, W, 3) world normals in [-1,1] -> rgb panel."""
    return _to_u8((np.asarray(img, np.float32) + 1.0) / 2.0)


_PANEL_FNS = {
    "rgb": rgb_to_panel,
    "grayscale": grayscale_to_panel,
    "normal": normal_to_panel,
}


def make_image_grid(specs):
    """One row of panels from specs: a list of {type, img, kwargs} (the
    reference's ``save_image_grid`` input, utils/mixins.py:91-116)."""
    panels = [_PANEL_FNS[s["type"]](s["img"], **s.get("kwargs", {})) for s in specs]
    h = max(p.shape[0] for p in panels)
    padded = []
    for p in panels:
        if p.shape[0] < h:
            p = np.concatenate([p, np.zeros((h - p.shape[0], p.shape[1], 3), np.uint8)], axis=0)
        padded.append(p)
    return np.concatenate(padded, axis=1)


def _png_chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img_u8):
    """A uint8 image as PNG bytes: (H, W) grey, (H, W, 3) RGB or (H, W, 4)
    RGBA, 8 bits a sample, every row with filter 0, one zlib stream."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        colour = 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"encode_png: expected (H, W), (H, W, 3) or (H, W, 4) uint8, "
                         f"got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def save_image(save_dir, filename, img_u8):
    path = _ensure_dir(os.path.join(save_dir, filename))
    with open(path, "wb") as f:
        f.write(encode_png(img_u8))
    return path


def save_image_grid(save_dir, filename, specs):
    return save_image(save_dir, filename, make_image_grid(specs))


def _frames(img_dir, matcher):
    """Files of ``img_dir`` matching ``matcher`` (a regex with one int
    group), ordered by that integer."""
    pat = re.compile(matcher)
    frames = []
    for name in os.listdir(img_dir):
        m = pat.search(name)
        if m:
            frames.append((int(m.group(1)), os.path.join(img_dir, name)))
    return [f for _, f in sorted(frames)]


def save_img_sequence(save_dir, filename, img_dir, matcher, save_format="mp4", fps=30):
    """Assemble the frames of ``img_dir`` matching ``matcher`` into
    ``<filename>.mp4`` (cv2's VideoWriter) or ``<filename>.gif`` (PIL), the
    reference's ``save_img_sequence`` (utils/mixins.py:191-207). Where that
    module does not import, prints one line naming it and returns None: the
    PNG frames stay."""
    if save_format not in ("mp4", "gif"):
        raise ValueError(f"unknown save_format {save_format!r} (mp4|gif)")
    module = "cv2" if save_format == "mp4" else "PIL"
    try:
        if save_format == "mp4":
            import cv2
        else:
            from PIL import Image
    except ImportError:
        print(f"[savers] no {save_format} for {filename}: module {module} is not installed; "
              f"the PNG frames stay in {img_dir}", flush=True)
        return None
    frames = _frames(img_dir, matcher)
    if not frames:
        return None
    if not filename.endswith("." + save_format):
        filename += "." + save_format
    path = _ensure_dir(os.path.join(save_dir, filename))
    if save_format == "mp4":
        h, w = cv2.imread(frames[0]).shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            writer.write(cv2.imread(f))
        writer.release()
    else:
        imgs = [Image.open(f).convert("RGB") for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=max(int(round(1000.0 / fps)), 1), loop=0)
    return path


def save_obj(save_dir, filename, v_pos, t_pos_idx, v_rgb=None):
    """Minimal OBJ writer with optional per-vertex colours (the reference uses
    trimesh, utils/mixins.py:211-222; colours follow the common
    'v x y z r g b' extension)."""
    path = _ensure_dir(os.path.join(save_dir, filename))
    v = np.asarray(v_pos, np.float32).tolist()
    f = (np.asarray(t_pos_idx, np.int64) + 1).tolist()  # OBJ is 1-indexed
    if v_rgb is None:
        lines = ["v %.6f %.6f %.6f" % tuple(p) for p in v]
    else:
        c = np.asarray(v_rgb, np.float32).tolist()
        lines = ["v %.6f %.6f %.6f %.4f %.4f %.4f" % (*p, *col) for p, col in zip(v, c)]
    lines += ["f %d %d %d" % tuple(tri) for tri in f]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def load_obj(path):
    """Minimal OBJ reader (vertices, optional vertex colours, faces
    fan-triangulated), the reference's utils/obj.py role."""
    verts, faces, colors = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    out = {
        "v_pos": np.asarray(verts, np.float32).reshape(-1, 3),
        "t_pos_idx": np.asarray(faces, np.int64).reshape(-1, 3),
    }
    if colors:
        out["v_rgb"] = np.asarray(colors, np.float32)
    return out


def save_json(save_dir, filename, payload):
    path = _ensure_dir(os.path.join(save_dir, filename))
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return path
