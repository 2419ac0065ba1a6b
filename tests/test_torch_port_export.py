"""Test, predict and mesh export in the port against the JAX package: the
marching tetrahedra, the two-stage isosurface of a transplanted tiny NeuS
(raw-product CP encoding, C=16, R=(16, 48), on the jac path: K7 in eval mode
for the vertex colours) and NeRF (the fused density head, K1, for the level
grid), the savers, and the launcher's --test, --predict and --export on the
CPU.

Tolerances: the marching pass is the same numpy algorithm, so vertices and
faces are identical on the same grid; level grids within 2e-2 of their
largest reference value and vertex colours within 2e-2 (bf16-operand
encodings with f32 sums in another order, as the JAX kernel tests allow);
PNG pixels, colormap entries and OBJ round trips exact (OBJ to its six
printed decimals)."""

import copy
import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import instant_nsr_pl_tpu.models  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.models  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.models import isosurface as j_iso
from instant_nsr_pl_tpu.ops.isosurface import marching_tetrahedra as j_marching
from instant_nsr_pl_tpu.utils import savers as j_savers
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.launch import main as launch_main
from instant_nsr_pl_tpu_torch.models import isosurface as t_iso
from instant_nsr_pl_tpu_torch.ops.isosurface import marching_tetrahedra as t_marching
from instant_nsr_pl_tpu_torch.utils import savers as t_savers
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIUS = 1.5
RES = 24


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the CPU run shares its cores among
    several pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# marching tetrahedra
# ---------------------------------------------------------------------------


def _sphere_field(res=33, radius=0.6, center=(0.05, -0.1, 0.02)):
    c = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2)
            - radius).astype(np.float32)


@pytest.mark.parametrize("field", ["random", "sphere"])
def test_marching_tetrahedra_matches_jax(field):
    """The port's copy of the numpy marching tetrahedra against the JAX
    package's on a seeded random field (iso 0.1) and a sphere SDF (iso 0):
    identical vertices and faces."""
    if field == "random":
        values, iso = np.random.RandomState(0).randn(13, 11, 9).astype(np.float32), 0.1
    else:
        values, iso = _sphere_field(), 0.0
    jv, jf = j_marching(values, iso)
    tv, tf = t_marching(values, iso)
    assert tv.dtype == np.float32 and tf.dtype == np.int64 and len(tf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    if field == "sphere":  # every vertex within one voxel of the sphere
        r = np.linalg.norm(tv * (2.0 / 32) - 1.0 - np.float32([0.05, -0.1, 0.02]), axis=1)
        assert np.abs(r - 0.6).max() < 2.0 / 32


# ---------------------------------------------------------------------------
# the isosurface and vertex colours of transplanted models
# ---------------------------------------------------------------------------

_MLP = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}


def _model_cfg(kind):
    iso = {"method": "mc", "resolution": RES, "chunk": 4096,
           "threshold": 0.0}
    tex = {"name": "volume-radiance", "fused": True,
           "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4}}
    if kind == "neus":
        geometry = {
            "name": "volume-sdf", "radius": RADIUS, "feature_dim": 13, "grad_type": "analytic",
            "analytic_jac": True, "isosurface": iso,
            "xyz_encoding_config": {"otype": "CP", "n_components": 16, "resolutions": [16, 48],
                                    "n_features": 0, "include_xyz": True, "grad_mode": "fast"},
            "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                   "output_activation": "none", "n_neurons": 32,
                                   "n_hidden_layers": 1, "sphere_init": True,
                                   "sphere_init_radius": 0.5, "weight_norm": True},
        }
        tex.update({"input_feature_dim": 16, "color_activation": "sigmoid",
                    "mlp_network_config": {**_MLP, "output_activation": "none",
                                           "n_hidden_layers": 2}})
        extra = {"variance": {"init_val": 0.3}}
    else:
        geometry = {
            "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
            "density_activation": "trunc_exp", "density_bias": -1, "isosurface": iso,
            "xyz_encoding_config": {"otype": "CP", "n_components": 16, "resolutions": [24, 64],
                                    "n_features": 8, "grad_mode": "fast"},
            "mlp_network_config": {**_MLP, "output_activation": "none", "n_hidden_layers": 1},
        }
        tex.update({"input_feature_dim": 16,
                    "mlp_network_config": {**_MLP, "output_activation": "Sigmoid",
                                           "n_hidden_layers": 2}})
        extra = {}
    return {"name": kind, "radius": RADIUS, "num_samples_per_ray": 1024, "grid_prune": True,
            "learned_background": False, "geometry": geometry, "texture": tex, **extra}


def _jax_vertex_rgb(kind, model, params, v_pos):
    """The JAX package's vertex colours (models/nerf.py:269-277,
    models/neus.py:467-478) at given vertices, evaluated eagerly (the jac
    path hits this XLA CPU build's missing bf16 x bf16 -> f32 dot under jit)."""
    v = jnp.asarray(v_pos)
    if kind == "neus":
        _, grad, feature = model.geometry.apply(params["geometry"], v, with_grad=True,
                                                with_feature=True)
        normal = grad / jnp.maximum(jnp.linalg.norm(grad, axis=-1, keepdims=True), 1e-10)
        rgb = model.texture.apply(params["texture"], feature, -normal, normal)
    else:
        _, feature = model.geometry.apply(params["geometry"], v)
        rgb = model.texture.apply(params["texture"], feature,
                                  jnp.zeros_like(v).at[..., 2].set(-1.0))
    return np.asarray(jnp.clip(rgb, 0.0, 1.0))


@pytest.mark.parametrize("kind", ["neus", "nerf"])
def test_isosurface_and_vertex_colours_match_jax(kind, monkeypatch):
    """A transplanted tiny model's level grid at 24^3 (the port's chunks of
    4,096 points, the tail padded) against the JAX package's within 2e-2 of
    its largest value; the port's extraction of the JAX level grid identical
    to the JAX package's (its numpy path); the port's two-stage mesh
    non-empty with valid indices; its vertex colours (NeuS: seen along
    -normal from the analytic gradient, K7 plain in eval mode; NeRF: along
    -z) within 2e-2 of the JAX package's at the same vertices and in [0, 1].
    The NeRF's random CP tables are scaled up so that its density varies, and
    its threshold is the median density of the grid."""
    cfg = _model_cfg(kind)
    j_model = j_reg.models.make(kind, j_config(copy.deepcopy(cfg)))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.02) * np.asarray(rs.randn(*np.shape(a)), np.float32),
        j_model.init(jax.random.PRNGKey(0)))
    if kind == "nerf":
        cp = params["geometry"]["encoding"]["cp"]
        for k in cp:
            cp[k] = cp[k] * (4.0 if k.startswith("line") else 1.0)
    tp = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                                "cpu")
    vmin, vmax = np.full(3, -RADIUS, np.float32), np.full(3, RADIUS, np.float32)
    # eagerly, in the JAX package's chunking (its own _eval_level_grid jits)
    pts = np.stack(np.meshgrid(*[np.linspace(-RADIUS, RADIUS, RES, dtype=np.float32)] * 3,
                               indexing="ij"), -1).reshape(-1, 3)
    j_vals = np.concatenate([
        np.asarray(j_model.geometry.forward_level(params["geometry"], jnp.asarray(pts[s:s + 4096])))
        for s in range(0, len(pts), 4096)]).reshape(RES, RES, RES)
    if kind == "nerf":
        cfg["geometry"]["isosurface"]["threshold"] = float(np.median(-j_vals))
    t_model = t_reg.models.make(kind, t_config(copy.deepcopy(cfg)))
    t_vals = t_iso._eval_level_grid(t_model.geometry, tp["geometry"], vmin, vmax, RES, 4096,
                                    "cpu")
    np.testing.assert_allclose(t_vals, j_vals, rtol=0, atol=2e-2 * np.abs(j_vals).max())
    iso = -float(cfg["geometry"]["isosurface"]["threshold"])
    monkeypatch.setattr(j_iso._native, "native_available", lambda: False)
    got, ref = t_iso._extract(j_vals, vmin, vmax, iso), j_iso._extract(j_vals, vmin, vmax, iso)
    assert len(ref["t_pos_idx"]) > 0
    for key in ("v_pos", "t_pos_idx"):
        np.testing.assert_array_equal(got[key], ref[key])

    mesh = t_model.export(tp, {"export_vertex_color": True, "chunk_size": 1000})
    v, f, rgb = mesh["v_pos"], mesh["t_pos_idx"], mesh["v_rgb"]
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v)
    assert np.abs(v).max() <= RADIUS + 1e-5 and rgb.shape == v.shape
    assert np.isfinite(rgb).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0
    np.testing.assert_allclose(rgb, _jax_vertex_rgb(kind, j_model, params, v), rtol=0, atol=2e-2)


def test_chunked_point_eval_halves_on_oom_only():
    """chunked_point_eval halves its chunk on torch.OutOfMemoryError (and
    restarts the sweep), stops halving at 4,096 points, and lets any other
    error through."""
    seen = []

    def oom_above(limit):
        def fn(x):
            seen.append(x.shape[0])
            if x.shape[0] > limit:
                raise torch.OutOfMemoryError("simulated")
            return x.sum(-1)
        return fn

    pts = np.random.RandomState(0).rand(20000, 3).astype(np.float32)
    out = t_iso.chunked_point_eval(oom_above(5000), pts, 16384, "cpu")
    np.testing.assert_allclose(out, pts.sum(-1), rtol=1e-6)
    assert seen[0] == 16384 and 4096 in seen and max(seen[1:]) <= 8192
    with pytest.raises(torch.OutOfMemoryError):
        t_iso.chunked_point_eval(oom_above(100), pts, 16384, "cpu")

    def broken(x):
        raise RuntimeError("a failed kernel launch")

    with pytest.raises(RuntimeError, match="kernel launch"):
        t_iso.chunked_point_eval(broken, pts, 16384, "cpu")


# ---------------------------------------------------------------------------
# savers
# ---------------------------------------------------------------------------


def test_savers_match_jax(tmp_path):
    """The port's PNG writer decodes (cv2) to the same uint8 array; its jet
    and magma tables equal cv2.applyColorMap; its panels and grid equal the
    JAX package's (which uses cv2); its OBJ reads back through the JAX
    package's load_obj; save_json writes what json reads."""
    import cv2

    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (19, 23, 3)).astype(np.uint8)
    path = t_savers.save_image(str(tmp_path), "sub/x.png", img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    grey = np.arange(256, dtype=np.uint8)[None]
    for name, cm in (("jet", cv2.COLORMAP_JET), ("magma", cv2.COLORMAP_MAGMA)):
        np.testing.assert_array_equal(t_savers._COLORMAPS[name],
                                      cv2.applyColorMap(grey, cm)[0, :, ::-1])
    h, w = 9, 11
    specs = [
        {"type": "rgb", "img": rs.rand(h, w, 3).astype(np.float32)},
        {"type": "grayscale", "img": rs.rand(h, w, 1).astype(np.float32) * 3.0,
         "kwargs": {"cmap": "jet"}},
        {"type": "grayscale", "img": rs.rand(h, w).astype(np.float32),
         "kwargs": {"cmap": "magma", "data_range": (0, 1)}},
        {"type": "grayscale", "img": rs.rand(h, w, 1).astype(np.float32),
         "kwargs": {"cmap": None, "data_range": (0, 1)}},
        {"type": "normal", "img": rs.uniform(-1, 1, (h, w, 3)).astype(np.float32)},
    ]
    grid = t_savers.make_image_grid(specs)
    np.testing.assert_array_equal(grid, j_savers.make_image_grid(specs))
    path = t_savers.save_image_grid(str(tmp_path), "grid.png", specs)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], grid)

    v = rs.uniform(-1, 1, (50, 3)).astype(np.float32)
    f = rs.randint(0, 50, (70, 3)).astype(np.int64)
    c = rs.rand(50, 3).astype(np.float32)
    for colours in (None, c):
        path = t_savers.save_obj(str(tmp_path), "m.obj", v, f, v_rgb=colours)
        back = j_savers.load_obj(path)
        np.testing.assert_allclose(back["v_pos"], v, atol=5e-7)
        np.testing.assert_array_equal(back["t_pos_idx"], f)
        if colours is None:
            assert "v_rgb" not in back
        else:
            np.testing.assert_allclose(back["v_rgb"], c, atol=5e-5)
        own = t_savers.load_obj(path)
        np.testing.assert_array_equal(own["t_pos_idx"], f)
    path = t_savers.save_json(str(tmp_path), "a/m.json", {"psnr": 1.5})
    with open(path) as fh:
        assert json.load(fh) == {"psnr": 1.5}


def test_img_sequence_without_its_module(tmp_path, monkeypatch, capsys):
    """save_img_sequence assembles an mp4 with cv2 (here); where the module
    does not import it prints one line naming it and leaves the frames."""
    frames = tmp_path / "frames"
    for i in range(3):
        t_savers.save_image(str(frames), f"{i}.png", np.full((8, 8, 3), 40 * i, np.uint8))
    path = t_savers.save_img_sequence(str(tmp_path), "seq", str(frames), r"(\d+)\.png")
    assert path.endswith("seq.mp4") and os.path.getsize(path) > 0
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    assert t_savers.save_img_sequence(str(tmp_path), "seq2", str(frames), r"(\d+)\.png") is None
    out = capsys.readouterr().out
    assert "cv2" in out and "seq2" in out and len(out.strip().splitlines()) == 1
    assert sorted(os.listdir(frames)) == ["0.png", "1.png", "2.png"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_raw_neus_train_test_predict_export(tmp_path, capsys):
    """``python -m instant_nsr_pl_tpu_torch.launch --device cpu --train`` with
    the raw-product NeuS config at full width (CP C=64, R=(128, 2048), no
    basis), cut to a 24x24 scene with two train and two test views, 64
    samples per ray without the occupancy grid, 64 rays, two steps and a 16^3
    isosurface: the automatic test writes the test views with their
    sidecars, logs test/psnr and exports the coloured mesh; then --test on
    the checkpoint reports every view cached, --predict writes the
    train-camera views and --export the mesh again."""
    config = os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "configs",
                          "neus-cp-raw-synthetic.yaml")
    exp = tmp_path / "exp"
    overrides = ["dataset.size=24", "dataset.n_train=2", "dataset.n_test=2",
                 "model.num_samples_per_ray=64", "model.grid_prune=false",
                 "model.train_num_rays=64", "model.max_train_num_rays=64",
                 "model.train_num_samples=4096", "model.eval_chunk_rays=1024",
                 "model.eval_num_samples=40960", "trainer.max_steps=2",
                 "trainer.log_every_n_steps=1", "trainer.val_check_interval=2",
                 "model.geometry.isosurface.resolution=16",
                 "model.geometry.isosurface.chunk=4096", "export.chunk_size=4096"]
    base = ["--config", config, "--device", "cpu", "--exp_dir", str(exp)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "instant_nsr_pl_tpu_torch.launch", *base,
                          "--train", *overrides], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    (trial,) = os.listdir(exp / "neus-cp-raw-synthetic")
    run = exp / "neus-cp-raw-synthetic" / trial
    save = run / "save"
    test_dir = save / "it2-test"
    assert sorted(os.listdir(test_dir)) == sorted(f"{i}.{e}" for i in range(2)
                                                  for e in ("png", "json"))
    assert (save / "it2-0.png").exists()  # the validation grid
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert np.isfinite(float([r for r in rows if r.get("test/psnr")][-1]["test/psnr"]))
    mesh = t_savers.load_obj(str(save / "it2-neus.obj"))
    assert len(mesh["t_pos_idx"]) > 0 and mesh["v_rgb"].shape == mesh["v_pos"].shape
    assert "[test] view 1: psnr=" in out.stdout

    ckpt = str(run / "ckpt" / "step=2.ckpt")
    for mode in ("--test", "--predict", "--export"):
        (save / "it2-neus.obj").unlink(missing_ok=True)
        assert launch_main([*base, mode, "--resume", ckpt, *overrides]) == 0
        assert (save / "it2-neus.obj").exists() == (mode != "--predict")
    printed = capsys.readouterr().out
    assert all(f"[test] view {i}: cached" in printed for i in range(2))
    assert sorted(os.listdir(save / "it2-predict")) == ["0.png", "1.png"]
    assert os.listdir(exp / "neus-cp-raw-synthetic") == [trial]
