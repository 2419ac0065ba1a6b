"""The port's Blender and DTU data modules, chamfer, callbacks and export
tools against the JAX package's (which read images with PIL and decompose
projections with cv2): data80's val and test splits bit-equal at 800x800
and within the JAX tests' tolerance at 400x400; DTU on an in-code fixture
and on an export round trip (c2w within 1e-5, directions within 1e-4, test
poses within 1e-6); ``load_K_Rt_from_P`` against cv2 on seeded random
projections of both signs; chamfer equal on the same seed; and tiny CPU
launcher runs of ``configs/nerf-blender.yaml`` and
``configs/neus-dtu-wmask.yaml`` on the port's own exports."""

from __future__ import annotations

import ast
import csv
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.registry import datasets as j_datasets
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.datasets import dtu as t_dtu
from instant_nsr_pl_tpu_torch.registry import datasets as t_datasets

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "instant_nsr_pl_tpu_torch"
DATA80 = ROOT / "data80" / "blender"
ARRAYS = ("all_images", "all_fg_masks", "all_c2w", "directions")


def _both(name, cfg, stage):
    j = j_datasets.make(name, j_config(dict(cfg)))
    t = t_datasets.make(name, t_config(dict(cfg)))
    j.setup(stage)
    t.setup(stage)
    return j, t


def _jax_scripts():
    sys.path.insert(0, str(ROOT / "scripts"))
    import make_synthetic_data

    return make_synthetic_data


# ---------------------------------------------------------------------------
# Blender on data80
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", ["validate", "test"])
def test_blender_data80_bit_equal(stage):
    cfg = {"name": "blender", "scene": "procsphere", "root_dir": str(DATA80),
           "img_wh": [800, 800]}
    j, t = _both("blender", cfg, stage)
    split = "val" if stage == "validate" else "test"
    jd, td = j.split(split), t.split(split)
    for key in ARRAYS:
        a, b = getattr(jd, key), getattr(td, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    assert td.all_images.shape == ((2, 800, 800, 3) if split == "val" else (4, 800, 800, 3))
    assert td.focal == jd.focal and (td.w, td.h) == (800, 800)
    assert td.has_mask and td.apply_mask
    assert set(td.load_seconds) == {"decode", "resize"} and td.load_seconds["resize"] < 0.01


def test_blender_data80_resized():
    """img_wh 400x400: every view through the bicubic resize (RGBA via
    RGBa); the JAX package's own export tolerance (tests/test_datasets.py:
    290-295), and the share of equal values printed."""
    cfg = {"name": "blender", "scene": "procsphere", "root_dir": str(DATA80),
           "img_wh": [400, 400]}
    j, t = _both("blender", cfg, "validate")
    jd, td = j.val, t.val
    np.testing.assert_allclose(td.all_fg_masks, jd.all_fg_masks, atol=1 / 255, rtol=0)
    m = jd.all_fg_masks[..., None]
    np.testing.assert_allclose(td.all_images * m, jd.all_images * m, atol=2 / 255, rtol=0)
    np.testing.assert_array_equal(td.directions, jd.directions)
    np.testing.assert_array_equal(td.all_c2w, jd.all_c2w)
    print(f"blender 400x400: images {np.mean(td.all_images == jd.all_images):.6f}, masks "
          f"{np.mean(td.all_fg_masks == jd.all_fg_masks):.6f} equal to the JAX package's")


# ---------------------------------------------------------------------------
# DTU
# ---------------------------------------------------------------------------


@pytest.fixture
def dtu_fixture(tmp_path):
    """tests/test_datasets.py's in-code DTU scene: four cameras on a ring,
    16x16 images and masks written by cv2."""
    import cv2

    root = tmp_path / "dtu_scan"
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    rng = np.random.RandomState(0)
    cams = {}
    K = np.array([[100.0, 0, 8], [0, 100.0, 8], [0, 0, 1]])
    for i in range(4):
        theta = 2 * math.pi * i / 4
        pos = np.array([2 * math.cos(theta), 2 * math.sin(theta), 1.0])
        forward = -pos / np.linalg.norm(pos)
        right = np.cross(forward, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(forward, right)
        R_w2c = np.stack([right, down, forward], axis=0)
        P = K @ np.concatenate([R_w2c, (-R_w2c @ pos)[:, None]], axis=1)
        world_mat = np.eye(4)
        world_mat[:3, :4] = P
        cams[f"world_mat_{i}"] = world_mat
        cams[f"scale_mat_{i}"] = np.eye(4)
        cv2.imwrite(str(root / "image" / f"{i:06d}.png"), rng.randint(0, 255, (16, 16, 3),
                                                                      np.uint8))
        cv2.imwrite(str(root / "mask" / f"{i:03d}.png"),
                    (rng.rand(16, 16) > 0.5).astype(np.uint8) * 255)
    np.savez(root / "cameras_sphere.npz", **cams)
    return str(root)


def _assert_dtu_close(j, t, image_atol, ring=False):
    """Train / val / test splits of the two packages. ``ring``: cameras on a
    ring, whose scatter matrix has two equal eigenvalues, so the trajectory's
    rotation axis is any vector of a plane and differences of 1e-16 in the
    camera centres (cv2's SVD against a direct solve) pick another one: there
    the test poses are held to the port's own centres and to JAX's radius."""
    for split in ("train", "val"):
        jd, td = j.split(split), t.split(split)
        np.testing.assert_allclose(td.all_c2w, jd.all_c2w, atol=1e-5, rtol=0)
        np.testing.assert_allclose(td.directions, jd.directions, atol=1e-4, rtol=0)
        np.testing.assert_allclose(td.all_images, jd.all_images, atol=image_atol, rtol=0)
        np.testing.assert_allclose(td.all_fg_masks, jd.all_fg_masks, atol=image_atol, rtol=0)
        assert td.all_images.shape == jd.all_images.shape
        assert (td.w, td.h, td.apply_mask) == (jd.w, jd.h, jd.apply_mask)
    jt, tt = j.test, t.test
    if ring:
        n = tt.all_c2w.shape[0]
        np.testing.assert_array_equal(
            tt.all_c2w, t_dtu.create_spheric_poses(t.train.all_c2w[:, :, 3], n))
        np.testing.assert_allclose(np.linalg.norm(tt.all_c2w[:, :, 3], axis=-1),
                                   np.linalg.norm(jt.all_c2w[:, :, 3], axis=-1), atol=1e-5)
    else:
        np.testing.assert_allclose(tt.all_c2w, jt.all_c2w, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.directions, jt.directions, atol=1e-4, rtol=0)
    assert tt.all_images.shape == jt.all_images.shape and not tt.all_images.any()


@pytest.mark.parametrize("scale", ["downscale1", "downscale2", "img_wh"])
def test_dtu_fixture_matches_jax(dtu_fixture, scale, capsys):
    cfg = {"name": "dtu", "root_dir": dtu_fixture, "cameras_file": "cameras_sphere.npz",
           "n_test_traj_steps": 6, "apply_mask": True}
    cfg.update({"downscale1": {"img_downscale": 1}, "downscale2": {"img_downscale": 2},
                "img_wh": {"img_wh": [8, 8]}}[scale])
    j, t = _both("dtu", cfg, "fit")
    j.setup("test")
    t.setup("test")
    _assert_dtu_close(j, t, 0.0, ring=True)  # the same bytes as PIL's decode, resize, luma
    out = capsys.readouterr().out
    assert out.count(t_dtu.VAL_NOTE) == 2  # printed once by each package


def test_dtu_export_round_trip_matches_jax(tmp_path):
    """The JAX package's export (scripts/make_synthetic_data.py) read by both
    packages, and the port's own export (tools/make_synthetic_data.py) equal
    to it after decoding."""
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make

    j_make = _jax_scripts()
    j_root, t_root = str(tmp_path / "jax"), str(tmp_path / "port")
    j_make.export_dtu(j_root, j_make._splits(size=24, n_train=3, n_val=2, n_test=2, fov=0.8))
    t_splits = t_make._splits(size=24, n_train=3, n_val=2, n_test=2, fov=0.8, names=("train",))
    t_make.export_dtu(t_root, t_splits)
    cfg = {"name": "dtu", "root_dir": j_root, "img_wh": [24, 24], "n_test_traj_steps": 5}
    j, t = _both("dtu", cfg, "fit")
    j.setup("test")
    t.setup("test")
    _assert_dtu_close(j, t, 0.0)
    src = t_splits["train"]
    np.testing.assert_allclose(t.train.all_c2w, src.all_c2w, atol=1e-5)
    # the port's export: the same cameras, the same pixels
    j_cams, t_cams = np.load(os.path.join(j_root, "cameras_sphere.npz")), np.load(
        os.path.join(t_root, "cameras_sphere.npz"))
    assert sorted(j_cams.keys()) == sorted(t_cams.keys())
    for k in j_cams.keys():
        np.testing.assert_array_equal(j_cams[k], t_cams[k])
    t2 = t_datasets.make("dtu", t_config({**cfg, "root_dir": t_root}))
    t2.setup("fit")
    for key in ARRAYS:
        np.testing.assert_array_equal(getattr(t2.train, key), getattr(t.train, key))


def test_load_K_Rt_from_P_matches_cv2():
    """100 seeded projections: K [R | t] scaled by a factor of either sign
    (a negative scale makes K[2, 2] negative and cv2's R improper), and
    unstructured random 3x4 matrices."""
    from instant_nsr_pl_tpu.datasets.dtu import load_K_Rt_from_P as j_load

    rng = np.random.RandomState(0)
    for i in range(100):
        if i % 4 == 3:
            P = rng.normal(size=(3, 4))
        else:
            K = np.array([[rng.uniform(300, 2000), rng.uniform(-5, 5), rng.uniform(100, 900)],
                          [0, rng.uniform(300, 2000), rng.uniform(100, 700)], [0, 0, 1]])
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            w, x, y, z = q
            R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                          [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                          [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
            t = rng.normal(size=3) * 2
            P = K @ np.concatenate([R, t[:, None]], 1) * rng.uniform(0.1, 10) * (-1) ** i
        jK, jpose = j_load(P)
        tK, tpose = t_dtu.load_K_Rt_from_P(P)
        assert tK.dtype == jK.dtype and tpose.dtype == jpose.dtype
        np.testing.assert_allclose(tK, jK, rtol=1e-6, atol=1e-6 * np.abs(jK).max())
        np.testing.assert_allclose(tpose[:3, :3], jpose[:3, :3], atol=1e-6, rtol=0)
        np.testing.assert_allclose(tpose[:3, 3], jpose[:3, 3], rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(jpose[:3, 3]).max()))
        assert np.array_equal(np.sign(np.linalg.det(tpose[:3, :3])),
                              np.sign(np.linalg.det(jpose[:3, :3])))


def test_create_spheric_poses_matches_jax():
    from instant_nsr_pl_tpu.datasets.dtu import create_spheric_poses as j_poses

    rng = np.random.RandomState(1)
    cams = rng.normal(size=(12, 3)) + np.array([0.0, 0.0, 2.0])
    np.testing.assert_allclose(t_dtu.create_spheric_poses(cams, 7), j_poses(cams, 7), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# chamfer, callbacks, export tools
# ---------------------------------------------------------------------------


def test_chamfer_matches_jax():
    from instant_nsr_pl_tpu.utils import chamfer as j_chamfer
    from instant_nsr_pl_tpu_torch.utils import chamfer as t_chamfer

    rng = np.random.RandomState(2)
    v = rng.normal(size=(60, 3))
    f = rng.randint(0, 60, (90, 3))
    mesh = {"v_pos": v, "t_pos_idx": f}
    other = {"v_pos": v * 1.1 + 0.01, "t_pos_idx": f}
    for a, b, kw in ((mesh, other, {}), (mesh, v * 0.9, {"max_dist": 0.05}),
                     (mesh, np.zeros((0, 3)), {})):
        assert t_chamfer.chamfer_distance(a, b, n_points=3000, seed=3, **kw) == \
            j_chamfer.chamfer_distance(a, b, n_points=3000, seed=3, **kw)
    np.testing.assert_array_equal(t_chamfer.sample_mesh_surface(v, f, 500, seed=4),
                                  j_chamfer.sample_mesh_surface(v, f, 500, seed=4))


def test_eval_chamfer_matches_jax_script(tmp_path):
    from instant_nsr_pl_tpu_torch.datasets.synthetic import _DEFAULT_SPHERES
    from instant_nsr_pl_tpu_torch.tools import eval_chamfer as t_eval

    sys.path.insert(0, str(ROOT / "scripts"))
    import eval_chamfer as j_eval

    np.testing.assert_array_equal(t_eval.surface_samples(_DEFAULT_SPHERES, 2000),
                                  j_eval.surface_samples(_DEFAULT_SPHERES, 2000))
    pts = np.random.RandomState(5).normal(size=(400, 3)) * 0.5
    np.testing.assert_array_equal(t_eval.unsigned_distance(pts, _DEFAULT_SPHERES),
                                  j_eval.unsigned_distance(pts, _DEFAULT_SPHERES))


def test_snapshots(tmp_path):
    from instant_nsr_pl_tpu_torch.config import load_config
    from instant_nsr_pl_tpu_torch.utils.callbacks import snapshot_code, snapshot_config

    raw = ROOT / "configs" / "nerf-blender.yaml"
    cfg = load_config(str(raw), cli_args=["dataset.scene=procsphere"])
    out = snapshot_config(str(tmp_path / "config"), cfg, str(raw))
    assert load_config(os.path.join(out, "parsed.yaml")).to_dict() == cfg.to_dict()
    assert (tmp_path / "config" / "raw.yaml").read_text() == raw.read_text()
    code = snapshot_code(str(tmp_path / "code"), repo_root=str(ROOT))
    if code is not None:  # a checkout without git has nothing to list
        assert (tmp_path / "code" / "instant_nsr_pl_tpu_torch" / "launch.py").read_text() == (
            PORT / "launch.py").read_text()
    assert snapshot_code(str(tmp_path / "none"), repo_root=str(tmp_path)) is None


def test_blender_export_matches_jax(tmp_path):
    """The port's blender export decodes (with PIL) to the JAX script's
    pixels, and its transforms files are the same."""
    from PIL import Image

    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make

    j_make = _jax_scripts()
    j_root, t_root = tmp_path / "jax", tmp_path / "port"
    j_make.export_blender(str(j_root), j_make._splits(16, 2, 1, 1, 0.8), fov=0.8)
    assert t_make.main(["--out", str(t_root), "--format", "blender", "--size", "16",
                        "--n-train", "2", "--n-val", "1", "--n-test", "1"]) == 0
    for split in ("train", "val", "test"):
        assert (j_root / f"transforms_{split}.json").read_text() == (
            t_root / "blender" / f"transforms_{split}.json").read_text()
        for png in sorted((j_root / split).glob("*.png")):
            assert np.array_equal(np.asarray(Image.open(png)),
                                  np.asarray(Image.open(t_root / "blender" / split / png.name)))


def test_data_modules_import_no_pil_cv2_jax():
    """The new modules import no PIL, cv2, JAX or JAX package module, and
    importing them (the registry's loaders with them) loads none."""
    new = ["utils/image_io.py", "datasets/blender.py", "datasets/dtu.py", "datasets/__init__.py",
           "utils/chamfer.py", "utils/callbacks.py", "tools/make_synthetic_data.py",
           "tools/eval_chamfer.py", "tools/launch_timed.py", "launch.py"]
    forbidden = ("PIL", "cv2", "jax", "jaxlib", "instant_nsr_pl_tpu")
    for rel in new:
        tree = ast.parse((PORT / rel).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for name in names:
                assert name.split(".")[0] not in forbidden, (rel, name)
    mods = [".".join(("instant_nsr_pl_tpu_torch",) + Path(r).with_suffix("").parts)
            .removesuffix(".__init__") for r in new]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the launcher on the CPU
# ---------------------------------------------------------------------------

# the launcher tests' cuts: few rays and samples, 4 steps, a 16^3 mesh, no
# grid warmup, and a narrow hash grid (4 levels of 2^12 rows in place of 16
# of 2^19: the full table's optimizer pass dominates a CPU step)
CUTS = ["model.train_num_rays=64", "model.max_train_num_rays=128",
        "model.train_num_samples=4096", "model.eval_chunk_rays=256",
        "model.eval_num_samples=16384", "trainer.max_steps=4", "trainer.val_check_interval=4",
        "trainer.log_every_n_steps=2", "model.geometry.isosurface.resolution=16",
        "model.grid_warmup_steps=0", "model.geometry.xyz_encoding_config.n_levels=4",
        "model.geometry.xyz_encoding_config.log2_hashmap_size=12"]


def _metrics(run):
    with open(run / "csv_logs" / "metrics.csv") as f:
        return list(csv.DictReader(f))


def test_launcher_nerf_blender_on_cpu(tmp_path, capsys):
    """configs/nerf-blender.yaml, unmodified but for the dataset path and
    the cuts (``CUTS``), on a 16x16 blender export of the port's own, through
    ``tools/launch_timed.py``: --train (the automatic test and mesh), the
    config and code snapshots, and the tool's load and export figures."""
    import json

    from instant_nsr_pl_tpu_torch.tools import launch_timed
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make

    data = tmp_path / "data"
    t_make.main(["--out", str(data), "--format", "blender", "--size", "16", "--n-train", "2",
                 "--n-val", "1", "--n-test", "1"])
    exp = tmp_path / "exp"
    argv = ["--config", str(ROOT / "configs" / "nerf-blender.yaml"), "--device", "cpu",
            "--exp_dir", str(exp), "dataset.scene=procsphere",
            f"dataset.root_dir={data / 'blender'}", "dataset.img_wh=[16,16]", *CUTS]
    assert launch_timed.main(argv + ["--train"]) == 0
    timed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert timed["rc"] == 0 and timed["device"] == "cpu"
    assert [(d["split"], d["views"], d["wh"]) for d in timed["loads"]] == [
        ("train", 2, [16, 16]), ("val", 1, [16, 16]), ("test", 1, [16, 16])]
    assert timed["export_s"]["export"] >= timed["export_s"]["level grid"] > 0
    (trial,) = os.listdir(exp / "nerf-blender-procsphere")
    run = exp / "nerf-blender-procsphere" / trial
    rows = _metrics(run)
    assert float([r for r in rows if r.get("test/psnr")][-1]["test/psnr"]) > 0
    assert sorted(os.listdir(run / "save" / "it4-test")) == ["0.json", "0.png"]
    assert (run / "save" / "it4-nerf.obj").exists()
    assert (run / "config" / "raw.yaml").read_text() == (
        ROOT / "configs" / "nerf-blender.yaml").read_text()
    assert (run / "config" / "parsed.yaml").exists()


def test_launcher_neus_dtu_wmask_on_cpu(tmp_path, capsys):
    """configs/neus-dtu-wmask.yaml, unmodified but for the dataset path and
    the cuts, on a 32x32 DTU export of the port's own (img_downscale 2:
    16x16): --train with the val note, the test trajectory, a mesh, and its
    chamfer against the analytic surface (tools/eval_chamfer.py)."""
    import json

    from instant_nsr_pl_tpu_torch.launch import main as launch_main
    from instant_nsr_pl_tpu_torch.tools import eval_chamfer
    from instant_nsr_pl_tpu_torch.tools import make_synthetic_data as t_make
    from instant_nsr_pl_tpu_torch.utils.savers import load_obj

    data = tmp_path / "data"
    t_make.main(["--out", str(data), "--format", "dtu", "--size", "32", "--n-train", "3"])
    exp = tmp_path / "exp"
    argv = ["--config", str(ROOT / "configs" / "neus-dtu-wmask.yaml"), "--device", "cpu",
            "--exp_dir", str(exp), f"dataset.root_dir={data / 'dtu'}",
            "dataset.n_test_traj_steps=2", *CUTS]
    assert launch_main(argv + ["--train"]) == 0
    assert t_dtu.VAL_NOTE in capsys.readouterr().out
    (trial,) = os.listdir(exp / "neus-dtu-wmask-dtu")
    run = exp / "neus-dtu-wmask-dtu" / trial
    rows = _metrics(run)
    assert math.isfinite(float([r for r in rows if r.get("val/psnr")][-1]["val/psnr"]))
    assert sorted(os.listdir(run / "save" / "it4-test")) == ["0.json", "0.png", "1.json", "1.png"]
    mesh = load_obj(str(run / "save" / "it4-neus.obj"))
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v)  # the sphere init's surface
    assert eval_chamfer.main(["--exp_dir", str(exp), "--n_points", "2000"]) == 0
    chamfer = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert chamfer["mesh"] == str(run / "save" / "it4-neus.obj")
    assert math.isfinite(chamfer["chamfer"]) and chamfer["chamfer"] < 0.5
