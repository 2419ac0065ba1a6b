"""The training slice end to end, port against the JAX package: one NeRF
loss and its gradients on fixed rays with transplanted parameters and an SDF
occupancy grid, a short CPU training run, the JAX ``.npz`` checkpoint loaded
into the port, the port's own save/resume, and the launcher on the CPU. The
JAX model runs its fused Pallas kernels (``cp_mlp_apply``, ``sh_mlp_apply``)
in interpret mode: the configs set ``grad_mode: fast`` and texture ``fused:
true``, without which the JAX package takes its XLA paths on the CPU."""

import copy
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu.systems  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.datasets.synthetic import scene_sdf
from instant_nsr_pl_tpu.ops.marching import OccupancyGridState as JGrid
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.launch import main as launch_main
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_weights_only,
    save_checkpoint,
)
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIUS = 1.5
N_RAYS = 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the CPU test run shares the cores among
    several pytest workers, and a training step's many small ops then wait on
    OpenMP barriers for descheduled threads (a short training run took
    minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(size=32, rays=N_RAYS, capacity=16384):
    """The bench NeRF's shape at narrow widths (CP C=16, R=(24, 64), F=8,
    MLP width 32), 1024 samples per ray, fixed ray count."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "name": "nerf-cp-small",
        "seed": 3,
        "dataset": {"name": "synthetic", "size": size, "n_train": 8, "n_val": 1},
        "model": {
            "name": "nerf", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": rays, "max_train_num_rays": rays, "train_num_samples": capacity,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_warmup_steps": 16, "learned_background": False,
            "background_color": "random", "randomized": True,
            "geometry": {
                "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "xyz_encoding_config": {"otype": "CP", "n_components": 16,
                                        "resolutions": [24, 64], "n_features": 8,
                                        "grad_mode": "fast"},
                "mlp_network_config": {**mlp, "output_activation": "none", "n_hidden_layers": 1},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16, "fused": True,
                "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
                "mlp_network_config": {**mlp, "output_activation": "Sigmoid",
                                       "n_hidden_layers": 2},
            },
        },
        "system": {
            "name": "nerf-system", "loss": {"lambda_rgb": 1.0, "lambda_distortion": 0.0},
            "optimizer": {"name": "AdamW",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1.0e-15}},
        },
        "checkpoint": {"save_top_k": -1, "every_n_train_steps": 4},
        "trainer": {"max_steps": 6, "log_every_n_steps": 2, "val_check_interval": 6,
                    "limit_val_batches": 1},
    }


def _close(got, ref, what=""):
    """The JAX gradient tests' tolerance (tests/test_cp_mlp_pallas.py:83),
    2.5e-2 of the largest reference value: both sides round the heads'
    matmul operands to bf16 and sum in f32 in other orders."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-2 * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


@pytest.fixture(scope="module")
def carried():
    """JAX parameters (random, non-zero biases) and a grid occupied where
    the scene SDF is below one cell diagonal, plus their port copies."""
    model = j_reg.models.make("nerf", j_config(_cfg())["model"])
    params = model.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a, params)
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, model.occ_spec))(jnp.asarray(binary))
    jgrid = JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                  binary_dilated=dil, bricks=bricks)
    return {"j_params": params, "j_occ": {"grid": jgrid},
            "np_params": jax.tree_util.tree_map(np.asarray, params)}


def _t_params(carried):
    return make_trainable(params_from_state_dict(params_from_jax(carried["np_params"]), "cpu"))


def test_loss_and_gradients_match_jax(carried):
    """One loss_fn forward and backward on fixed rays (no stratified jitter,
    a fixed random background), both packages: the loss within 1e-3
    relative, the training PSNR within 0.05 dB, every parameter gradient
    within 2.5e-2 of its largest reference value."""
    rs = np.random.RandomState(1)
    eye = np.array([0.3, -2.4, 0.8], np.float32)
    d = -eye / np.linalg.norm(eye) + rs.randn(N_RAYS, 3).astype(np.float32) * 0.25
    batch = {
        "rays_o": np.broadcast_to(eye, (N_RAYS, 3)).copy(),
        "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
        "rgb": rs.rand(N_RAYS, 3).astype(np.float32),
        "fg_mask": np.ones(N_RAYS, np.float32),
        "background_color": rs.rand(N_RAYS, 3).astype(np.float32),
    }
    cfg = _cfg()
    cfg["model"]["randomized"] = False
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    assert j_sys.model.geometry.encoding_with_network.fused and j_sys.model.texture.fused
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_sys.loss_fn(p, carried["j_occ"], b, None, jnp.int32(0)),
        has_aux=True))(carried["j_params"], jax.tree_util.tree_map(jnp.asarray, batch))

    t_sys = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    params = _t_params(carried)
    occ = {"grid": occupancy_from_jax(carried["j_occ"]["grid"], "cpu")}
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = t_sys.loss_fn(params, occ, t_batch, None, 0)
    assert loss.grad_fn is not None
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    assert float(metrics["train/psnr"]) == pytest.approx(float(j_metrics["train/psnr"]), abs=0.05)
    assert int(metrics["train/num_samples"]) == int(j_metrics["train/num_samples"]) > 20 * N_RAYS
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(params):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, ref[key], key)
        assert float(t.grad.abs().max()) > 0, key


def test_ray_buckets_and_adapt_match_jax():
    """Dynamic ray batching: the same bucket ladder and the same bucket
    chosen for each live-sample count as the JAX system."""
    cfg = _cfg(rays=64)
    cfg["model"].update(dynamic_ray_sampling=True, max_train_num_rays=1024,
                        train_num_samples=65536)
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    t_sys = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    assert t_sys.ray_buckets == j_sys.ray_buckets == [64, 128, 256, 512, 1024]
    assert t_sys.active_num_rays == j_sys.active_num_rays == 64
    for live in (0.0, 1e6, 9000.0, 3000.0, 500.0, 20000.0):
        assert t_sys.adapt_num_rays(live) == j_sys.adapt_num_rays(live), live


@pytest.mark.parametrize("value,step", [(0.5, 7), ([0, 1.0, 0.0, 100], 30),
                                        ([10, 0.2, 1.0, 50], 5), ([10, 0.2, 1.0, 50], 70),
                                        ([1.0, 3.0, 6], 4), ([0, 0.0, 1.0, 4.0], 13)])
def test_scheduled_scalar_matches_jax(value, step):
    """C(): constants, step-interpolated lists and, with a float end step,
    the epoch form (epoch = step // 4 images here)."""
    from instant_nsr_pl_tpu.systems.base import C as j_C
    from instant_nsr_pl_tpu_torch.systems.base import C as t_C

    assert t_C(value, step, epoch_steps=4) == pytest.approx(
        float(j_C(value, jnp.int32(step), epoch_steps=4)), rel=1e-6)


def test_distortion_loss_raises():
    """A non-zero lambda_distortion no longer raises: the NeRF loss adds the
    MipNeRF-360 distortion term (ops/rendering.py distortion_loss, held
    against the JAX package in tests/test_torch_port_neus_ops.py)."""
    cfg = _cfg(size=24, rays=32, capacity=4096)
    cfg["system"]["loss"]["lambda_distortion"] = 0.01
    system, _ = _system(cfg)
    state, metrics = system.train_step(system.init_state(seed=0))
    assert float(metrics["train/loss_distortion"]) > 0
    assert np.isfinite(float(metrics["train/loss"]))


def _system(cfg, split="train"):
    dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    dm.setup("fit")
    system = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    system.setup_data(dm.train)
    return system, dm


def test_train_step_cpu_run_learns():
    """100 steps of train_step on a 48x48 scene (256 rays, 8,192 packed
    samples, grid warmup at step 0 then slab updates every 16 steps): the
    loss falls, the training PSNR rises, the grid prunes, and the val view
    renders finite (as tests/test_systems.py:264-281 checks the JAX
    package)."""
    cfg = _cfg(size=48, rays=256, capacity=8192)
    system, dm = _system(cfg)
    state = system.init_state(seed=0)
    assert state["generator"].device.type == "cpu"
    losses, psnrs = [], []
    for _ in range(100):
        state, metrics = system.train_step(state)
        losses.append(float(metrics["train/loss"]))
        psnrs.append(float(metrics["train/psnr"]))
    assert state["step"] == 100 and np.isfinite(losses).all()
    assert np.mean(losses[-20:]) < np.mean(losses[:20])
    assert np.mean(psnrs[-20:]) > np.mean(psnrs[:20])
    grid = state["occ"]["grid"]
    assert 0 < int(grid.binary.sum()) < grid.binary.numel()
    res = system.evaluate_image(state, 0, data=None)
    assert res["images"]["comp_rgb"].shape == (48, 48, 3)
    assert np.isfinite(res["psnr"])


def _fill(tree, rs):
    """Random values in every float leaf of a JAX state (ints and keys kept)."""
    def f(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return jnp.asarray(rs.rand(*a.shape).astype(np.float32))
        return a
    return jax.tree_util.tree_map(f, tree)


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A JAX .npz train state (utils/checkpoint.py), written with random
    leaves, loaded into the port: parameters, grid, step and the Adam
    moments and counts land where they belong; training continues."""
    cfg = _cfg(size=24)
    j_dm = j_reg.datasets.make("synthetic", j_config(copy.deepcopy(cfg))["dataset"])
    j_dm.setup("fit")
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    j_sys.setup_data(j_dm.train)
    j_state = _fill(j_sys.init_state(seed=0), np.random.RandomState(2))
    j_state["step"] = jnp.int32(37)
    inner = j_state["opt_state"].inner_states
    for key in ("geometry", "texture"):
        adam = inner[key].inner_state[0]
        inner[key] = inner[key]._replace(inner_state=(
            adam._replace(count=jnp.int32(37)), *inner[key].inner_state[1:]))
    path = str(tmp_path / "jax.ckpt.npz")
    j_save_checkpoint(path, j_state)

    system, _ = _system(cfg)
    state = load_checkpoint(path, system.init_state(seed=0))
    assert state["step"] == 37
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_state["params"])))
    for key, t in named_leaves(state["params"]):
        np.testing.assert_array_equal(t.detach().numpy(), ref[key], err_msg=key)
        assert t.requires_grad
    np.testing.assert_array_equal(state["occ"]["grid"].occs.numpy(),
                                  np.asarray(j_state["occ"]["grid"].occs))
    opt = state["optimizer"].optimizer
    for group in opt.param_groups:
        key = group["name"]
        adam = inner[key].inner_state[0]
        mu = [v for _, v in named_leaves(jax.tree_util.tree_map(np.asarray, adam.mu[key]))]
        nu = [v for _, v in named_leaves(jax.tree_util.tree_map(np.asarray, adam.nu[key]))]
        assert len(mu) == len(group["params"])
        for p, m, v in zip(group["params"], mu, nu):
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), m)
            np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(), v)
            assert float(opt.state[p]["step"]) == 37
    state, metrics = system.train_step(state)
    assert state["step"] == 38 and np.isfinite(float(metrics["train/loss"]))
    weights = load_weights_only(path, system.init_state(seed=1))
    assert weights["step"] == 0 and not weights["optimizer"].optimizer.state
    np.testing.assert_array_equal(
        weights["params"]["texture"]["network"]["layers"][0]["w"].detach().numpy(),
        ref["texture.network.layers.0.w"])


def test_port_checkpoint_resume_is_exact(tmp_path):
    """Save after 3 steps, run 2 more; a fresh state resumed from the save
    runs the same 2 steps to the same parameters, bit for bit (the
    generator state travels with the checkpoint)."""
    cfg = _cfg(size=24, rays=64, capacity=4096)
    cfg["model"]["grid_update_every"] = 2
    cfg["model"]["grid_warmup_steps"] = 2
    system, _ = _system(cfg)
    state = system.init_state(seed=0)
    for _ in range(3):
        state, _ = system.train_step(state)
    path = save_checkpoint(str(tmp_path / "step=3.ckpt"), state)
    for _ in range(2):
        state, _ = system.train_step(state)

    system2, _ = _system(cfg)
    resumed = load_checkpoint(path, system2.init_state(seed=5))
    assert resumed["step"] == 3
    for _ in range(2):
        resumed, _ = system2.train_step(resumed)
    for (key, a), (_, b) in zip(named_leaves(state["params"]), named_leaves(resumed["params"])):
        assert torch.equal(a, b), key
    assert torch.equal(state["occ"]["grid"].occs, resumed["occ"]["grid"].occs)

    fresh = load_weights_only(path, system2.init_state(seed=5))
    assert fresh["step"] == 0 and not fresh["optimizer"].optimizer.state


def test_launcher_trains_and_validates_on_cpu(tmp_path, capsys):
    """``python -m instant_nsr_pl_tpu_torch.launch --train --device cpu``:
    six steps write checkpoints (every 4 steps and at the end) and CSV logs,
    then the automatic test renders the two test views and exports the mesh
    (a 16^3 isosurface at density 5); --validate resumes the last
    checkpoint; --test, --predict and --export run on it too (the test views
    cached, the two train-camera views rendered, the mesh written)."""
    cfg_path = tmp_path / "nerf.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg(size=24, rays=64, capacity=4096)))
    exp = tmp_path / "exp"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    overrides = ["tag=t", "dataset.n_train=2", "dataset.n_test=2",
                 "model.geometry.isosurface.resolution=16",
                 "model.geometry.isosurface.threshold=5.0"]
    cmd = [sys.executable, "-m", "instant_nsr_pl_tpu_torch.launch", "--config", str(cfg_path),
           "--device", "cpu", "--exp_dir", str(exp), *overrides]
    out = subprocess.run(cmd + ["--train"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (trial,) = os.listdir(exp / "nerf-cp-small")
    assert trial.startswith("t@")
    run = exp / "nerf-cp-small" / trial
    assert sorted(os.listdir(run / "ckpt")) == ["step=4.ckpt", "step=6.ckpt"]
    assert (run / "config" / "parsed.yaml").exists()
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    steps = [r["step"] for r in rows if r.get("train/loss")]
    assert steps == ["2", "4", "6"]
    val_row = [r for r in rows if r.get("val/psnr")][-1]
    assert float(val_row["val/psnr"]) > 0 and float(rows[0]["train/rays_per_sec"]) > 0
    assert "[val] view 0" in out.stdout

    ckpt = str(run / "ckpt" / "step=6.ckpt")
    out = subprocess.run(cmd + ["--validate", "--resume", ckpt], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[val] view 0" in out.stdout and sorted(os.listdir(exp / "nerf-cp-small")) == [trial]
    save = run / "save"
    assert sorted(os.listdir(save / "it6-test")) == ["0.json", "0.png", "1.json", "1.png"]
    assert float(rows[-1]["test/psnr"]) > 0 and (save / "it6-nerf.obj").exists()
    for mode in ("--test", "--predict", "--export"):
        (save / "it6-nerf.obj").unlink()
        assert launch_main(cmd[3:] + [mode, "--resume", ckpt]) == 0
        if mode == "--predict":
            (save / "it6-nerf.obj").touch()
    printed = capsys.readouterr().out
    assert all(f"[test] view {i}: cached" in printed for i in range(2))
    assert sorted(os.listdir(save / "it6-predict")) == ["0.png", "1.png"]
    assert (save / "it6-nerf.obj").stat().st_size > 0
    with pytest.raises(SystemExit, match="needs --resume"):
        launch_main(cmd[3:] + ["--export"])


def test_launcher_defaults_to_cuda(tmp_path):
    cfg_path = tmp_path / "nerf.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg(size=16)))
    argv = ["--config", str(cfg_path), "--train", "--exp_dir", str(tmp_path / "exp")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_main(argv)
