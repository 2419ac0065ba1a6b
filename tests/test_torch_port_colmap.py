"""The COLMAP loader (slice 9), port against the JAX package, and the
unbounded-scene configs through the port's launcher on the CPU.

The fixtures are ``tests/test_datasets.py``'s in-code COLMAP model (a
PINHOLE camera, six views on a ring, 200 points with a ground plane, random
RGB PNGs), here also with RGBA images and a ``masks/`` folder, and the
port's own COLMAP export of the procedural scene
(``tools/make_synthetic_data.py --format colmap``). Tolerances: the binary
readers' values and the images and masks equal to the bit, poses and
directions within 1e-6.

The launcher runs take ``configs/nerf-colmap.yaml``, ``neus-colmap.yaml``
and ``neus-dtu.yaml`` unmodified but for the dataset path, the up
estimator (``camera``: the procedural scene has no ground plane for
``ground``'s RANSAC) and size cuts (4 hash levels of 2^12 rows, a few rays
and steps, a 16^3 mesh). Their occupancy grids are swapped for 32^3 ones in
the test (no 256^3 grid is updated on the CPU).
"""

import ast
import csv
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu.datasets.colmap as j_colmap
import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets.colmap as t_colmap
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.datasets import colmap_utils as j_cu
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.datasets import colmap_utils as t_cu
from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_datasets import _write_colmap_model  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "instant_nsr_pl_tpu_torch"


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both loaders cache a capture by root_dir (a class attribute)."""
    j_colmap.ColmapDatasetBase._cache = {}
    t_colmap.ColmapDatasetBase._cache = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    j_colmap.ColmapDatasetBase._cache = {}
    t_colmap.ColmapDatasetBase._cache = {}


def _scene(tmp_path, rgba=False, masks=False, jpeg=None):
    """The fixture; ``jpeg`` (a PIL subsampling, 0 for 4:4:4 or 2 for
    4:2:0) re-encodes its images and masks as ``.jpg`` files (quality 90),
    renamed in ``images.bin``."""
    root = str(tmp_path / "scene")
    _write_colmap_model(root)
    rs = np.random.RandomState(9)
    names = sorted(os.listdir(os.path.join(root, "images")))
    if rgba:  # RGBA images: PIL resizes them premultiplied
        for n in names:
            p = os.path.join(root, "images", n)
            rgb = np.asarray(Image.open(p))
            alpha = rs.randint(0, 256, rgb.shape[:2] + (1,), np.uint8)
            alpha[:4] = 0
            alpha[-4:] = 255
            Image.fromarray(np.concatenate([rgb, alpha], -1)).save(p)
    if masks:  # RGB masks: the loader converts them to luma
        os.makedirs(os.path.join(root, "masks"))
        for n in names:
            Image.fromarray(rs.randint(0, 256, (24, 32, 3), np.uint8)).save(
                os.path.join(root, "masks", n))
    if jpeg is not None:
        for sub in ("images", "masks") if masks else ("images",):
            for n in names:
                p = os.path.join(root, sub, n)
                Image.open(p).save(p[:-4] + ".jpg", quality=90, subsampling=jpeg)
                os.remove(p)
        images_bin = os.path.join(root, "sparse/0/images.bin")
        with open(images_bin, "rb") as fh:
            data = fh.read()
        with open(images_bin, "wb") as fh:
            fh.write(data.replace(b".png\x00", b".jpg\x00"))
    return root


def _both(cfg, stage="fit"):
    j_dm = j_reg.datasets.make("colmap", j_config(dict(cfg)))
    t_dm = t_reg.datasets.make("colmap", t_config(dict(cfg)))
    j_dm.setup(stage)
    t_dm.setup(stage)
    return j_dm, t_dm


def test_colmap_readers_match_jax(tmp_path):
    """cameras.bin, images.bin and points3D.bin read by both packages:
    every field equal; qvec2rotmat equal to the bit."""
    root = _scene(tmp_path)
    sparse = os.path.join(root, "sparse/0")
    for fn in ("read_cameras_binary", "read_images_binary", "read_points3d_binary"):
        stem = {"read_cameras_binary": "cameras", "read_images_binary": "images"}.get(
            fn, "points3D")
        ref = getattr(j_cu, fn)(os.path.join(sparse, f"{stem}.bin"))
        got = getattr(t_cu, fn)(os.path.join(sparse, f"{stem}.bin"))
        assert sorted(ref) == sorted(got) and len(got) > 0
        for k in ref:
            for a, b in zip(ref[k], got[k]):
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b
    q = np.random.RandomState(0).randn(20, 4)
    for qq in q / np.linalg.norm(q, axis=1, keepdims=True):
        np.testing.assert_array_equal(t_cu.qvec2rotmat(qq), j_cu.qvec2rotmat(qq))


@pytest.mark.parametrize("center_m,up_m,downscale,images,masks", [
    ("lookat", "camera", 1, False, False),
    ("camera", "ground", 3, True, False),
    ("lookat", "ground", 2, False, True),
    ("point", "ground", 1.5, True, True),
    ("lookat", "camera", 2, "jpeg420", True),
    ("camera", "ground", 1, "jpeg444", True),
])
def test_colmap_loader_matches_jax(tmp_path, capsys, center_m, up_m, downscale, images, masks):
    """The loader against the JAX package's on the fixture, for each centre
    and up estimator (RANSAC ground included), downscales that round
    (``int(W / d + 0.5)``), RGB or RGBA PNG images (``images`` False /
    True) or JPEG images at 4:2:0 / 4:4:4 (their masks JPEG too), and RGB
    masks: poses, directions and the test trajectory within 1e-6, images
    and masks equal to the bit, the val split the training images with its
    note, the test frames blank."""
    jpeg = {"jpeg420": 2, "jpeg444": 0}.get(images)
    root = _scene(tmp_path, images is True, masks, jpeg)
    if jpeg is not None:
        assert all(n.endswith(".jpg") for n in os.listdir(os.path.join(root, "images")))
    cfg = {"name": "colmap", "root_dir": root, "img_downscale": downscale,
           "up_est_method": up_m, "center_est_method": center_m, "n_test_traj_steps": 5,
           "apply_mask": masks}
    j_dm, t_dm = _both(cfg)
    w, h = int(32 / downscale + 0.5), int(24 / downscale + 0.5)
    for split in ("train", "val"):
        j, t = j_dm.split(split), t_dm.split(split)
        assert (t.w, t.h, t.img_wh) == (j.w, j.h, j.img_wh) == (w, h, (w, h))
        np.testing.assert_allclose(t.all_c2w, j.all_c2w, rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.directions, j.directions, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t.all_images, j.all_images)
        np.testing.assert_array_equal(t.all_fg_masks, j.all_fg_masks)
        np.testing.assert_allclose(t.pts3d, j.pts3d, rtol=0, atol=1e-6)
        assert (t.has_mask, t.apply_mask) == (j.has_mask, j.apply_mask) == (masks, masks)
    assert t_colmap.VAL_NOTE in capsys.readouterr().out
    assert t_dm.val.all_images is t_dm.train.all_images
    if masks:
        assert 0.0 < float(t_dm.train.all_fg_masks.mean()) < 1.0
    j_dm.setup("test")
    t_dm.setup("test")
    np.testing.assert_allclose(t_dm.test.all_c2w, j_dm.test.all_c2w, rtol=0, atol=1e-6)
    assert t_dm.test.all_images.shape == (5, h, w, 3) and not t_dm.test.all_images.any()


def test_colmap_refuses_images_that_are_neither_png_nor_jpeg(tmp_path):
    """A GIF among the images: ValueError naming the file, no fallback."""
    root = _scene(tmp_path)
    p = os.path.join(root, "images", "img_002.png")
    Image.open(p).convert("P").save(p, format="GIF")
    cfg = {"name": "colmap", "root_dir": root, "img_downscale": 1, "up_est_method": "ground",
           "center_est_method": "lookat", "apply_mask": False}
    with pytest.raises(ValueError, match="img_002.png: neither a PNG nor a JPEG"):
        t_reg.datasets.make("colmap", t_config(cfg)).setup("fit")


def test_port_colmap_export_reads_in_jax_loader(tmp_path):
    """``tools/make_synthetic_data.py --format colmap`` read back by the JAX
    loader and the port's (img_downscale 2): the same poses, images and
    points; the images are the procedural scene's train views and the
    normalised cameras look at the centre."""
    assert t_make.main(["--out", str(tmp_path), "--format", "colmap", "--size", "32",
                        "--n-train", "5"]) == 0
    root = str(tmp_path / "colmap")
    assert sorted(os.listdir(os.path.join(root, "images")))[0] == "img_0000.png"
    cams = j_cu.read_cameras_binary(os.path.join(root, "sparse/0/cameras.bin"))
    assert cams[1].model == "PINHOLE" and (cams[1].width, cams[1].height) == (32, 32)
    cfg = {"name": "colmap", "root_dir": root, "img_downscale": 2, "up_est_method": "camera",
           "center_est_method": "lookat", "n_test_traj_steps": 3, "apply_mask": False}
    j_dm, t_dm = _both(cfg)
    j, t = j_dm.train, t_dm.train
    np.testing.assert_allclose(t.all_c2w, j.all_c2w, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.all_images, j.all_images)
    assert t.all_images.shape == (5, 16, 16, 3) and len(t.pts3d) == len(j.pts3d) > 200
    centers = t.all_c2w[:, :, 3]
    np.testing.assert_allclose(np.linalg.norm(centers, axis=-1).min(), 1.0, atol=1e-5)
    look = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    assert ((-t.all_c2w[:, :, 2]) * look).sum(-1).min() > 0.99


def test_colmap_export_backdrop(tmp_path):
    """``--backdrop 10``: the object's pixels are the white export's, every
    background pixel is the textured sphere's colour (``backdrop_colours``
    on the view's own rays, to the 8-bit value) and not white, and both
    loaders read the export alike (images equal to the bit)."""
    from instant_nsr_pl_tpu_torch.datasets.synthetic import SyntheticDatasetBase

    for name, extra in (("white", []), ("backdrop", ["--backdrop", "10"])):
        assert t_make.main(["--out", str(tmp_path / name), "--format", "colmap", "--size",
                            "24", "--n-train", "3", *extra]) == 0
    ds = SyntheticDatasetBase()
    ds.setup(t_config({"size": 24, "n_train": 3, "fov": 0.8}), "train")
    for i in range(3):
        png = f"colmap/images/img_{i:04d}.png"
        white = np.asarray(Image.open(tmp_path / "white" / png))
        back = np.asarray(Image.open(tmp_path / "backdrop" / png))
        mask = ds.all_fg_masks[i] > 0.5
        assert 0 < mask.sum() < mask.size
        np.testing.assert_array_equal(back[mask], white[mask])
        assert (white[~mask] == 255).all() and not (back[~mask] == 255).all(axis=-1).any()
        c2w = ds.all_c2w[i].astype(np.float64)
        dirs = ds.directions.reshape(-1, 3).astype(np.float64) @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        want = t_make.backdrop_colours(np.broadcast_to(c2w[:3, 3], dirs.shape), dirs, 10.0)
        np.testing.assert_array_equal(back.reshape(-1, 3)[~mask.reshape(-1)],
                                      t_make._to_u8(want)[~mask.reshape(-1)])
    cfg = {"name": "colmap", "root_dir": str(tmp_path / "backdrop" / "colmap"),
           "img_downscale": 1, "up_est_method": "camera", "center_est_method": "lookat",
           "n_test_traj_steps": 3, "apply_mask": False}
    j_dm, t_dm = _both(cfg)
    np.testing.assert_array_equal(t_dm.train.all_images, j_dm.train.all_images)


def test_colmap_modules_import_no_pil_cv2_jax():
    """The loader's modules (the PNG / JPEG reader among them) import no
    PIL, cv2, JAX or JAX package module, and importing them loads none."""
    new = ["datasets/colmap.py", "datasets/colmap_utils.py", "utils/image_io.py"]
    forbidden = ("PIL", "cv2", "jax", "jaxlib", "instant_nsr_pl_tpu")
    for rel in new:
        for node in ast.walk(ast.parse((PORT / rel).read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            assert not any(n.split(".")[0] in forbidden for n in names), (rel, names)
    code = ("import sys, instant_nsr_pl_tpu_torch.datasets.colmap\n"
            "import instant_nsr_pl_tpu_torch.utils.image_io\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the launcher on the CPU
# ---------------------------------------------------------------------------

CUTS = ["model.train_num_rays=32", "model.max_train_num_rays=64",
        "model.train_num_samples=4096", "model.eval_chunk_rays=256",
        "model.eval_num_samples=16384", "trainer.max_steps=3", "trainer.val_check_interval=3",
        "trainer.log_every_n_steps=1", "model.geometry.isosurface.resolution=16",
        "model.grid_warmup_steps=0", "model.geometry.xyz_encoding_config.n_levels=4",
        "model.geometry.xyz_encoding_config.log2_hashmap_size=12",
        "dataset.n_test_traj_steps=1"]
BG_CUTS = ["model.train_num_samples_bg=2048", "model.eval_num_samples_bg=8192",
           "model.geometry_bg.xyz_encoding_config.n_levels=4",
           "model.geometry_bg.xyz_encoding_config.log2_hashmap_size=12"]


def _small_grids(monkeypatch):
    """Every grid the models build at most 32^3."""
    from instant_nsr_pl_tpu_torch.models import nerf, neus

    for mod in (nerf, neus):
        spec = mod.OccGridSpec
        monkeypatch.setattr(mod, "OccGridSpec", lambda resolution=128, _s=spec, **kw: _s(
            resolution=min(resolution, 32), **kw))


@pytest.mark.parametrize("config", ["nerf-colmap", "neus-colmap", "neus-dtu"])
def test_launcher_runs_unbounded_config_on_cpu(tmp_path, monkeypatch, capsys, config):
    """The config through the port's launcher on the CPU (on the port's
    COLMAP export, or for neus-dtu its DTU export, 32x32): --train (the
    val note, the automatic test and the mesh export) with a finite loss and
    val PSNR, NeuS's background panels in the saved val view, the test view
    and an OBJ with valid indices; for nerf-colmap then --validate,
    --predict and --export of the checkpoint."""
    from instant_nsr_pl_tpu_torch.launch import main as launch_main
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    _small_grids(monkeypatch)
    dtu = config == "neus-dtu"
    data = tmp_path / "data"
    assert t_make.main(["--out", str(data), "--format", "dtu" if dtu else "colmap",
                        "--size", "32", "--n-train", "3"]) == 0
    exp = tmp_path / "exp"
    argv = ["--config", str(ROOT / "configs" / f"{config}.yaml"), "--device", "cpu",
            "--exp_dir", str(exp), f"dataset.root_dir={data / ('dtu' if dtu else 'colmap')}",
            *CUTS, *([] if config == "nerf-colmap" else BG_CUTS),
            *([] if dtu else ["dataset.up_est_method=camera"])]
    assert launch_main(argv + ["--train"]) == 0
    assert "val split aliases the TRAINING images" in capsys.readouterr().out
    name = f"{config}-{'dtu' if dtu else 'colmap'}"
    (trial,) = os.listdir(exp / name)
    run = exp / name / trial
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train/loss"]) for r in rows if r.get("train/loss")]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert math.isfinite(float([r for r in rows if r.get("val/psnr")][-1]["val/psnr"]))
    val = np.asarray(Image.open(run / "save" / "it3-0.png"))
    panels = 4 if config == "nerf-colmap" else 6  # NeuS adds its fg and bg panels
    assert val.shape[1] == panels * val.shape[0]
    assert sorted(os.listdir(run / "save" / "it3-test"))[:2] == ["0.json", "0.png"]
    obj = run / "save" / f"it3-{config.split('-')[0]}.obj"
    mesh = load_obj(str(obj))
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    assert v.shape[1:] == (3,) and (len(f) == 0 or (f.min() >= 0 and f.max() < len(v)))
    if config == "nerf-colmap":  # the other modes from the checkpoint
        ckpt = str(run / "ckpt" / "step=3.ckpt")
        obj.unlink()
        for mode in ("--validate", "--predict", "--export"):
            assert launch_main(argv + [mode, "--resume", ckpt]) == 0, mode
        assert obj.exists() and len(os.listdir(run / "save" / "it3-predict")) >= 3
