"""NeuS with the hash grid (slice 7), port against the JAX package at small
widths (HashGrid of 5 levels, 2^12 rows: 3 dense and 2 hashed levels, with the
xyz prepended; the fp32 SDF MLP 13->32->13 with sphere init and weight norm;
the radiance MLP width 32): ``VolumeSDF`` on the hash grid's jac path
(``hashgrid_encode_with_jac``: the plain HG3 / HG4 here), with a
``ProgressiveBandHashGrid`` at a training step, the autodiff fallback and
finite differences with the progressive eps; one ``NeuSSystem.loss_fn``
forward and backward (the models' tap dedup on: the plain HG7 / HG8 on the
coarse levels); a NeRF density head on a ``ProgressiveBandHashGrid``;
and the repo's ``configs/neus-synthetic.yaml`` through the port's launcher
on the CPU (train, test, export) with size overrides.

The JAX side runs ``analytic_jac: true`` and a fused texture (the Pallas SH
head in interpret mode), as on the TPU. Tolerances: sdf, its gradient and
the features within 1e-4 of their largest value (the Laplacian 1e-3: 4 /
eps^2 amplifies last-ulp sdf differences); every parameter gradient within
2.5e-2 of its largest value (the JAX kernel tests' limit: bf16 radiance
operands, the JAX fast path's bf16 one-hot table gradient, sums in other
orders); the loss within 1e-3 relative."""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instant_nsr_pl_tpu.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu.models  # noqa: F401  (register)
import instant_nsr_pl_tpu.systems  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.datasets.synthetic import scene_sdf
from instant_nsr_pl_tpu.ops.marching import OccupancyGridState as JGrid
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.launch import main as launch_main
from instant_nsr_pl_tpu_torch.models.network_utils import (
    ProgressiveBandHashGrid,
    make_trainable,
    named_leaves,
)
from instant_nsr_pl_tpu_torch.utils.savers import load_obj
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
    port_layout,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIUS = 1.5
N_RAYS = 48
HASH = {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.6,
        "grad_mode": "fast", "include_xyz": True}
BAND = {**HASH, "otype": "ProgressiveBandHashGrid", "start_level": 2, "start_step": 10,
        "update_steps": 20}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the CPU run shares its cores among
    several pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geometry(encoding=HASH, grad_type="analytic", analytic_jac=True, eps=0.05):
    return {
        "name": "volume-sdf", "radius": RADIUS, "feature_dim": 13, "grad_type": grad_type,
        "analytic_jac": analytic_jac, "finite_difference_eps": eps,
        "xyz_encoding_config": dict(encoding),
        "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                               "output_activation": "none", "n_neurons": 32,
                               "n_hidden_layers": 1, "sphere_init": True,
                               "sphere_init_radius": 0.5, "weight_norm": True},
    }


def _close(got, ref, rel=2.5e-2, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _perturbed(params, seed=0):
    """Random offsets on every leaf (the hash table of order 0.05), so that
    no gradient is zero by the sphere init."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05) * np.asarray(rs.randn(*np.shape(a)), np.float32),
        params)


def _carry(params):
    return make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))


def _sdf_loss(out):
    sdf, grad, feat = out[:3]
    lib = torch if torch.is_tensor(sdf) else jnp
    norm = torch.linalg.norm(grad, dim=-1) if lib is torch else jnp.linalg.norm(grad, axis=-1)
    return ((norm - 1.0) ** 2).mean() + (feat ** 2).mean() + (sdf ** 2).mean()


MODES = {
    "jac": _geometry(),
    "jac-progressive": _geometry(BAND),
    "autodiff": _geometry(analytic_jac=False),
    "fd-progressive": _geometry(BAND, "finite_difference", eps="progressive"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_volume_sdf_on_hash_grid_matches_jax(mode):
    """VolumeSDF with a hash grid against the JAX package's at step 35 (the
    band's level 3 of 5): the jac path (the plain HG3 / HG4 against
    ``hashgrid_encode_with_jac``), with a ProgressiveBandHashGrid's mask, the
    autodiff fallback, and finite differences with the progressive eps and
    the Laplacian: sdf, gradient and features within 1e-4 of their largest
    value (the Laplacian 1e-3), and every parameter gradient of an eikonal +
    feature + sdf loss (second order on the analytic paths) within 2.5e-2."""
    cfg = MODES[mode]
    step = 35
    j_geo = j_reg.models.make("volume-sdf", j_config(copy.deepcopy(cfg)))
    t_geo = t_reg.models.make("volume-sdf", t_config(copy.deepcopy(cfg)))
    assert t_geo.use_jac == j_geo.use_jac == mode.startswith("jac")
    inner = t_geo.encoding.encoding
    assert isinstance(inner, ProgressiveBandHashGrid) == ("progressive" in mode)
    assert inner.grad_mode == ("autodiff" if mode == "autodiff" else "fast")
    params = _perturbed(j_geo.init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(1).uniform(-1.3, 1.3, (96, 3)).astype(np.float32)
    kw = {"with_laplace": True} if mode.startswith("fd") else {}
    jstep = jnp.int32(step)
    ref = jax.jit(lambda p, s: j_geo.apply(p, jnp.asarray(x), step=s, **kw))(params, jstep)
    g_ref = jax.jit(jax.grad(lambda p, s: _sdf_loss(j_geo.apply(p, jnp.asarray(x), step=s,
                                                                **kw))))(params, jstep)
    tp = _carry(params)
    out = t_geo.apply(tp, torch.from_numpy(x), step=step, **kw)
    for got, r, what in zip(out, ref, ("sdf", "grad", "feature", "laplace")):
        _close(got, r, rel=1e-3 if what == "laplace" else 1e-4, what=what)
    _sdf_loss(out).backward()
    g_ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    for key, t in named_leaves(tp):
        _close(t.grad, port_layout(key, g_ref[key]), what=key)
        assert float(t.grad.abs().max()) > 0, key
    with torch.no_grad():  # eval: the same values without autograd
        ev = t_geo.apply(tp, torch.from_numpy(x), step=step, **kw)
    for a, b in zip(ev, out):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-6)


def _cfg(size=32, rays=N_RAYS, capacity=16384, encoding=HASH):
    """configs/neus-synthetic.yaml's shape at narrow widths, 1024 samples
    per ray."""
    return {
        "name": "neus-hash-small",
        "seed": 3,
        "dataset": {"name": "synthetic", "size": size, "n_train": 8, "n_val": 1},
        "model": {
            "name": "neus", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": rays, "max_train_num_rays": rays, "train_num_samples": capacity,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_prune_occ_thre": 0.001, "grid_warmup_steps": 2,
            "cos_anneal_end": 200, "learned_background": False, "background_color": "random",
            "randomized": True, "variance": {"init_val": 0.3, "modulate": False},
            "geometry": _geometry(encoding),
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
                     "lambda_distortion": 0.01, "lambda_distortion_bg": 0.0},
            "optimizer": {"name": "AdamW",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1.0e-15}},
        },
        "trainer": {"max_steps": 4, "log_every_n_steps": 2, "val_check_interval": 4,
                    "limit_val_batches": 1},
    }


@pytest.mark.parametrize("encoding", ["hash", "progressive"])
def test_neus_hash_loss_and_gradients_match_jax(encoding):
    """One NeuSSystem.loss_fn forward and backward on fixed rays at step 35
    (no stratified jitter, a fixed random background) with the same
    parameters and a grid occupied where the scene SDF is below one cell
    diagonal, in both packages (each with the same tap-dedup spec, so the
    coarse levels read block lattices): the loss within 1e-3 relative, the
    sample count, inv_s and the training PSNR, and every parameter gradient
    within 2.5e-2 of its largest reference value."""
    cfg = _cfg(encoding=HASH if encoding == "hash" else BAND)
    cfg["model"]["randomized"] = False
    j_sys = j_reg.systems.make("neus-system", j_config(copy.deepcopy(cfg)))
    j_sys.has_mask = False
    model = j_sys.model
    params = _perturbed(model.init(jax.random.PRNGKey(0)))
    params["variance"]["variance"] = jnp.float32(0.3)
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, xg = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([xg, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, model.occ_spec))(jnp.asarray(binary))
    j_occ = {"grid": JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                           binary_dilated=dil, bricks=bricks)}
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
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_sys.loss_fn(p, j_occ, jax.tree_util.tree_map(jnp.asarray, batch), None,
                                jnp.int32(35)), has_aux=True))(params)

    t_sys = t_reg.systems.make("neus-system", t_config(copy.deepcopy(cfg)), device="cpu")
    t_sys.has_mask = False
    # both NeuS models configure the same tap-dedup spec for their jac path
    j_enc, t_enc = model.geometry.encoding.encoding, t_sys.model.geometry.encoding.encoding
    assert j_enc.dedup_spec is not None and t_enc.dedup_spec is not None
    assert t_enc.dedup_spec.dedup_group_sizes == j_enc.dedup_spec.dedup_group_sizes
    tp = _carry(params)
    occ = {"grid": occupancy_from_jax(j_occ["grid"], "cpu")}
    loss, metrics = t_sys.loss_fn(tp, occ, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, 35)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    assert int(metrics["train/num_samples"]) == int(j_metrics["train/num_samples"]) > 10 * N_RAYS
    assert float(metrics["train/inv_s"]) == pytest.approx(float(j_metrics["train/inv_s"]), rel=1e-6)
    assert float(metrics["train/psnr"]) == pytest.approx(float(j_metrics["train/psnr"]), abs=0.05)
    for key in ("train/loss_eikonal", "train/loss_sparsity", "train/loss_distortion"):
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]), rel=1e-3), key
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, port_layout(key, ref[key]), what=key)
        assert float(t.grad.abs().max()) > 0, key


def test_nerf_density_on_progressive_band_matches_jax():
    """VolumeDensity (a NeRF density head: the fast encode, HG1 on the card,
    then the bf16 MLP) on a ProgressiveBandHashGrid against the JAX package's
    at steps 0, 30 and 70 and without a step: density and features within
    1e-4 of their largest value, zero features on the masked levels."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "none",
           "n_neurons": 32, "n_hidden_layers": 1}
    band = {k: v for k, v in BAND.items() if k != "include_xyz"}
    cfg = {"name": "volume-density", "radius": RADIUS, "feature_dim": 16,
           "density_activation": "trunc_exp", "density_bias": -1,
           "xyz_encoding_config": band, "mlp_network_config": mlp}
    j_geo = j_reg.models.make("volume-density", j_config(copy.deepcopy(cfg)))
    t_geo = t_reg.models.make("volume-density", t_config(copy.deepcopy(cfg)))
    params = _perturbed(j_geo.init(jax.random.PRNGKey(0)))
    tp = _carry(params)
    x = np.random.RandomState(2).uniform(-1.4, 1.4, (200, 3)).astype(np.float32)
    j_apply = jax.jit(lambda p, s: j_geo.apply(p, jnp.asarray(x), step=s))
    enc = t_geo.encoding_with_network.encoding
    for step in (0, 30, 70, None):
        ref = j_apply(params, None if step is None else jnp.int32(step))
        with torch.no_grad():
            got = t_geo.apply(tp, torch.from_numpy(x), step=step)
            feats = enc.apply(tp["encoding"], torch.from_numpy(x) * 0.2 + 0.5, step=step)
        for g, r, what in zip(got, ref, ("density", "feature")):
            _close(g, r, rel=1e-4, what=f"{what} at step {step}")
        lvl = enc.encoding.current_level(step)
        assert not bool(feats[:, 2 * lvl:].any()) and bool(feats[:, :2 * lvl].any())


def test_launcher_runs_repo_neus_synthetic_config_on_cpu(tmp_path):
    """``configs/neus-synthetic.yaml`` of the repo, unmodified (the hash
    grid's analytic gradients through HG3 / HG4's plain versions, dynamic
    ray sampling), through the port's launcher on the CPU with size
    overrides (and no warmup: the first grid update is a slab, not every
    cell through the plain encode): --train (the automatic test and mesh),
    then --export of the last checkpoint: test/psnr logged, the test view
    and an OBJ with valid indices written."""
    exp = tmp_path / "exp"
    argv = ["--config", os.path.join(ROOT, "configs", "neus-synthetic.yaml"), "--device", "cpu",
            "--exp_dir", str(exp), "tag=t", "dataset.size=16", "dataset.n_train=2",
            "dataset.n_test=1", "model.train_num_rays=64", "model.max_train_num_rays=128",
            "model.train_num_samples=4096", "model.eval_chunk_rays=256",
            "model.eval_num_samples=16384", "trainer.max_steps=4",
            "trainer.val_check_interval=4", "trainer.log_every_n_steps=2",
            "model.geometry.isosurface.resolution=16", "model.grid_warmup_steps=0"]
    assert launch_main(argv + ["--train"]) == 0
    (trial,) = os.listdir(exp / "neus-synthetic")
    run = exp / "neus-synthetic" / trial
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["train/num_rays"] for r in rows if r.get("train/num_rays")][0] == "64.0"
    assert float([r for r in rows if r.get("train/inv_s")][-1]["train/inv_s"]) > 20.0
    assert float([r for r in rows if r.get("test/psnr")][-1]["test/psnr"]) > 0
    assert sorted(os.listdir(run / "save" / "it4-test"))[:2] == ["0.json", "0.png"]
    obj = run / "save" / "it4-neus.obj"
    assert obj.exists()
    obj.unlink()
    assert launch_main(argv + ["--export", "--resume", str(run / "ckpt" / "step=4.ckpt")]) == 0
    mesh = load_obj(str(obj))
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    assert v.shape[1:] == (3,) and f.shape[1:] == (3,)
    assert len(f) > 0 and f.min() >= 0 and f.max() < len(v)
