"""The stacked-scales slice end to end, port against the JAX package: one NeRF
and one NeuS loss with their gradients on fixed rays, from transplanted JAX
parameters and an SDF occupancy grid, with the bench's ``cp_stacked`` encoding
cut to the JAX tests' small spec (CP C=16, nested R=(17, 65), F=8,
``stack_scales: true``; MLP width 32); and one short CPU launch of each
stacked config (``instant_nsr_pl_tpu_torch/configs/{nerf,neus}-cp-stacked-
synthetic.yaml``, full width, cut to a small scene and two steps).

The JAX side runs its kernels as on the TPU: ``grad_mode: fast`` (and
``analytic_jac: true`` for NeuS, texture ``fused: true``), so the stacked
Pallas kernels (``cp_mlp_apply_stacked``, ``cp_jac_basis_stacked``) run in
interpret mode; without it the JAX package takes its XLA twins on the CPU.

Tolerances: the loss within 1e-3 relative; every parameter gradient within
2.5e-2 of its largest reference value (the JAX kernel tests' tolerance: bf16
operands, f32 sums in another order)."""

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

import instant_nsr_pl_tpu.systems  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.datasets.synthetic import scene_sdf
from instant_nsr_pl_tpu.ops.marching import OccupancyGridState as JGrid
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIUS = 1.5
N_RAYS = 48
ENCODING = {"otype": "CP", "n_components": 16, "resolutions": [17, 65], "n_features": 8,
            "grad_mode": "fast", "stack_scales": True}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the CPU run shares its cores among
    several pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nerf_cfg():
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "name": "nerf-cp-stacked-small", "seed": 3,
        "dataset": {"name": "synthetic", "size": 32, "n_train": 8, "n_val": 1},
        "model": {
            "name": "nerf", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": N_RAYS, "max_train_num_rays": N_RAYS, "train_num_samples": 16384,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_warmup_steps": 16, "learned_background": False,
            "background_color": "random", "randomized": False,
            "geometry": {
                "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "xyz_encoding_config": dict(ENCODING),
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
    }


def _neus_cfg():
    return {
        "name": "neus-cp-stacked-small", "seed": 3,
        "dataset": {"name": "synthetic", "size": 32, "n_train": 8, "n_val": 1},
        "model": {
            "name": "neus", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": N_RAYS, "max_train_num_rays": N_RAYS, "train_num_samples": 16384,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_prune_occ_thre": 0.001, "grid_warmup_steps": 2,
            "cos_anneal_end": 200, "learned_background": False, "background_color": "random",
            "randomized": False, "variance": {"init_val": 0.3, "modulate": False},
            "geometry": {
                "name": "volume-sdf", "radius": RADIUS, "feature_dim": 13,
                "grad_type": "analytic", "analytic_jac": True,
                "xyz_encoding_config": {**ENCODING, "include_xyz": True},
                "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                       "output_activation": "none", "n_neurons": 32,
                                       "n_hidden_layers": 1, "sphere_init": True,
                                       "sphere_init_radius": 0.5, "weight_norm": True},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16, "fused": True,
                "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
                "mlp_network_config": {"otype": "FullyFusedMLP", "activation": "ReLU",
                                       "output_activation": "none", "n_neurons": 32,
                                       "n_hidden_layers": 2},
                "color_activation": "sigmoid",
            },
        },
        "system": {
            "name": "neus-system",
            "loss": {"lambda_rgb_mse": 10.0, "lambda_rgb_l1": 0.0, "lambda_eikonal": 0.1,
                     "lambda_sparsity": 0.01, "lambda_curvature": 0.0,
                     "lambda_distortion": 0.0, "lambda_distortion_bg": 0.0},
            "optimizer": {"name": "AdamW",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1.0e-15}},
        },
    }


def _grid(model):
    """Occupied where the scene SDF is below one cell diagonal."""
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, model.occ_spec))(jnp.asarray(binary))
    return {"grid": JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                          binary_dilated=dil, bricks=bricks)}


def _batch():
    rs = np.random.RandomState(1)
    eye = np.array([0.3, -2.4, 0.8], np.float32)
    d = -eye / np.linalg.norm(eye) + rs.randn(N_RAYS, 3).astype(np.float32) * 0.25
    return {
        "rays_o": np.broadcast_to(eye, (N_RAYS, 3)).copy(),
        "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
        "rgb": rs.rand(N_RAYS, 3).astype(np.float32),
        "fg_mask": np.ones(N_RAYS, np.float32),
        "background_color": rs.rand(N_RAYS, 3).astype(np.float32),
    }


def _close(got, ref, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-2 * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _perturbed(params, seed=0):
    """Random offsets on every leaf: non-zero biases, and no gradient zero by
    the NeuS sphere init (its first layer is zero beyond the xyz rows)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05) * np.asarray(rs.randn(*np.shape(a)), np.float32), params)


@pytest.mark.parametrize("model", ["nerf", "neus"])
def test_stacked_loss_and_gradients_match_jax(model):
    """One ``loss_fn`` forward and backward of the stacked NeRF (K13/K14
    plain versions against the stacked Pallas density kernels) and of the
    stacked NeuS (K11/K12 against the stacked Pallas jac kernels) on fixed
    rays (no jitter, a fixed random background; NeuS at step 50 of the
    cosine anneal), both packages with the same parameters and grid: the
    loss within 1e-3 relative, the live samples equal, every parameter
    gradient within 2.5e-2 of its largest reference value."""
    cfg = _nerf_cfg() if model == "nerf" else _neus_cfg()
    name = f"{model}-system"
    j_sys = j_reg.systems.make(name, j_config(copy.deepcopy(cfg)))
    t_sys = t_reg.systems.make(name, t_config(copy.deepcopy(cfg)), device="cpu")
    if model == "nerf":
        assert j_sys.model.geometry.encoding_with_network.fused
        ewn = t_sys.model.geometry.encoding_with_network
        assert ewn.fused and ewn.encoding.encoding.stack_scales
    else:
        j_sys.has_mask = t_sys.has_mask = False
        assert j_sys.model.geometry.use_jac and t_sys.model.geometry.use_jac
        assert t_sys.model.geometry.encoding.encoding.stack_scales
    params = _perturbed(j_sys.model.init(jax.random.PRNGKey(0)))
    if model == "neus":
        params["variance"]["variance"] = jnp.float32(0.3)
    j_occ = _grid(j_sys.model)
    batch = _batch()
    step = 0 if model == "nerf" else 50
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_sys.loss_fn(p, j_occ, b, None, jnp.int32(step)), has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))

    t_params = make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))
    occ = {"grid": occupancy_from_jax(j_occ["grid"], "cpu")}
    loss, metrics = t_sys.loss_fn(t_params, occ, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, step)
    assert loss.grad_fn is not None
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    assert int(metrics["train/num_samples"]) == int(j_metrics["train/num_samples"]) > 10 * N_RAYS
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(t_params):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, ref[key], key)
        assert float(t.grad.abs().max()) > 0, key


@pytest.mark.parametrize("model", ["nerf", "neus"])
def test_launcher_trains_stacked_config_on_cpu(tmp_path, model):
    """``python -m instant_nsr_pl_tpu_torch.launch --device cpu --train`` with
    the stacked config at full width (CP C=64, R=(129, 2049)), cut to a
    24x24 scene, 64 rays, 4,096 packed samples and two steps: a checkpoint,
    the CSV log and one validation view."""
    config = os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "configs",
                          f"{model}-cp-stacked-synthetic.yaml")
    exp = tmp_path / "exp"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "instant_nsr_pl_tpu_torch.launch", "--config", config,
           "--device", "cpu", "--exp_dir", str(exp), "--train",
           "dataset.size=24", "model.train_num_rays=64", "model.max_train_num_rays=64",
           "model.train_num_samples=4096", "model.eval_chunk_rays=1024",
           "model.eval_num_samples=65536", "model.grid_warmup_steps=1", "trainer.max_steps=2",
           "trainer.log_every_n_steps=1", "trainer.val_check_interval=2"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    name = f"{model}-cp-stacked-synthetic"
    (trial,) = os.listdir(exp / name)
    run = exp / name / trial
    assert sorted(os.listdir(run / "ckpt")) == ["step=2.ckpt"]
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("train/loss")]
    assert [r["step"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r["train/loss"])) for r in rows)
    assert "[val] view 0" in out.stdout
