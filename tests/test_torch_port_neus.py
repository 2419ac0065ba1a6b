"""The NeuS slice end to end, port against the JAX package at narrow widths
(CP C=16, R=(16, 48), F=8 with the xyz prepended; the fp32 SDF MLP 35->32->13
with sphere init, weight norm and Softplus(100); the radiance MLP width 32).
The JAX side runs its kernels as on the TPU: ``grad_mode: fast``,
``analytic_jac: true`` and a fused texture, so the Pallas kernels
(``cp_product_jac_basis``, ``cp_product``, ``sh_mlp_apply``) run in
interpret mode.

Covered: ``VolumeSDF`` on the jac path (sdf, gradient, features and the
second-order gradients of an eikonal + feature + sdf loss), the autodiff
fallback and the finite-difference path with its Laplacian; one
``NeuSSystem.loss_fn`` forward and backward on fixed rays; a short CPU
training run; a JAX NeuS ``.npz`` loaded into the port; the launcher; and the
parts that raise, naming the slice that brings them.

Tolerances: values within 1e-4 relative (fp32 MLP, bf16-operand encodings
with the same roundings); gradients within 2.5e-2 of their largest reference
value, the JAX kernel tests' tolerance (bf16 operands, f32 sums in another
order)."""

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
import instant_nsr_pl_tpu.models  # noqa: F401  (register)
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
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIUS = 1.5
N_RAYS = 48


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


def _geometry(grad_type="analytic", analytic_jac=True):
    return {
        "name": "volume-sdf", "radius": RADIUS, "feature_dim": 13, "grad_type": grad_type,
        "analytic_jac": analytic_jac,
        "xyz_encoding_config": {"otype": "CP", "n_components": 16, "resolutions": [16, 48],
                                "n_features": 8, "include_xyz": True, "grad_mode": "fast"},
        "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                               "output_activation": "none", "n_neurons": 32,
                               "n_hidden_layers": 1, "sphere_init": True,
                               "sphere_init_radius": 0.5, "weight_norm": True},
    }


def _cfg(size=32, rays=N_RAYS, capacity=16384, grad_type="analytic"):
    """The bench NeuS's shape at narrow widths, 1024 samples per ray."""
    return {
        "name": "neus-cp-small",
        "seed": 3,
        "dataset": {"name": "synthetic", "size": size, "n_train": 8, "n_val": 1},
        "model": {
            "name": "neus", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": rays, "max_train_num_rays": rays, "train_num_samples": capacity,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_prune_occ_thre": 0.001, "grid_warmup_steps": 2,
            "cos_anneal_end": 200, "learned_background": False, "background_color": "random",
            "randomized": True, "variance": {"init_val": 0.3, "modulate": False},
            "geometry": _geometry(grad_type),
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
        "checkpoint": {"save_top_k": -1, "every_n_train_steps": 4},
        "trainer": {"max_steps": 4, "log_every_n_steps": 2, "val_check_interval": 4,
                    "limit_val_batches": 1},
    }


def _close(got, ref, rel=2.5e-2, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _perturbed(params, seed=0):
    """Random offsets on every leaf, so that no gradient is zero by the
    sphere init (its first layer is zero beyond the xyz rows)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05) * np.asarray(rs.randn(*np.shape(a)), np.float32),
        params)


def _carry(params):
    return make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))


def _pts(n=96, seed=1):
    return np.random.RandomState(seed).uniform(-1.3, 1.3, (n, 3)).astype(np.float32)


def _sdf_loss(out):
    sdf, grad, feat = out[:3]
    lib = torch if torch.is_tensor(sdf) else jnp
    norm = torch.linalg.norm(grad, dim=-1) if lib is torch else jnp.linalg.norm(grad, axis=-1)
    return ((norm - 1.0) ** 2).mean() + (feat ** 2).mean() + (sdf ** 2).mean()


@pytest.mark.parametrize("mode", ["jac", "autodiff", "finite_difference"])
def test_volume_sdf_matches_jax(mode):
    """VolumeSDF on the jac path (K9/K10 plain versions against the Pallas
    kernels), the autodiff fallback and finite differences with the
    Laplacian (K5/K6 plain versions against cp_product): sdf, gradient,
    features within 1e-4 of their largest reference value (the Laplacian
    1e-3),
    and every parameter gradient of an eikonal + feature + sdf loss (second
    order on the analytic paths) within 2.5e-2."""
    grad_type = "finite_difference" if mode == "finite_difference" else "analytic"
    cfg = _geometry(grad_type, analytic_jac=mode == "jac")
    # the stencil differences amplify the sdf's last-ulp differences by 1/eps
    # (gradient) and 1/eps^2 (Laplacian): at the default 1e-3 the f32
    # Laplacian is rounding noise in both packages, so compare at 0.05
    cfg["finite_difference_eps"] = 0.05
    j_geo = j_reg.models.make("volume-sdf", j_config(copy.deepcopy(cfg)))
    t_geo = t_reg.models.make("volume-sdf", t_config(copy.deepcopy(cfg)))
    assert t_geo.use_jac == j_geo.use_jac == (mode == "jac")
    assert t_geo.encoding.encoding.grad_mode == j_geo.encoding.encoding.grad_mode
    params = _perturbed(j_geo.init(jax.random.PRNGKey(0)))
    x = _pts()
    kw = {"with_laplace": True} if mode == "finite_difference" else {}
    # the jac path alone hits this XLA CPU build's missing bf16 x bf16 -> f32
    # dot under jit (inside the whole NeuS loss it does not): run it eagerly
    jit = (lambda f: f) if mode == "jac" else jax.jit
    ref = jit(lambda p: j_geo.apply(p, jnp.asarray(x), **kw))(params)
    g_ref = jit(jax.grad(lambda p: _sdf_loss(j_geo.apply(p, jnp.asarray(x), **kw))))(params)
    tp = _carry(params)
    out = t_geo.apply(tp, torch.from_numpy(x), **kw)
    for got, r, what in zip(out, ref, ("sdf", "grad", "feature", "laplace")):
        # the Laplacian's 4 / eps^2 = 1,600 turns last-ulp sdf differences
        # into ~1e-3 of its largest value
        _close(got, r, rel=1e-3 if what == "laplace" else 1e-4, what=what)
    _sdf_loss(out).backward()
    g_ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    for key, t in named_leaves(tp):
        _close(t.grad, g_ref[key], what=key)
        assert float(t.grad.abs().max()) > 0, key
    with torch.no_grad():  # eval: the same values without autograd
        ev = t_geo.apply(tp, torch.from_numpy(x), **kw)
    for a, b in zip(ev, out):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def carried():
    """JAX NeuS parameters (perturbed) and a grid occupied where the scene
    SDF is below one cell diagonal, plus their port copies."""
    model = j_reg.models.make("neus", j_config(_cfg())["model"])
    params = _perturbed(model.init(jax.random.PRNGKey(0)))
    params["variance"]["variance"] = jnp.float32(0.3)
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, model.occ_spec))(jnp.asarray(binary))
    jgrid = JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                  binary_dilated=dil, bricks=bricks)
    return {"j_params": params, "j_occ": {"grid": jgrid}}


def test_neus_loss_and_gradients_match_jax(carried):
    """One NeuSSystem.loss_fn forward and backward on fixed rays (no
    stratified jitter, a fixed random background, step 50 of the cosine
    anneal), both packages with the same parameters and grid: the loss within
    1e-3 relative, inv_s and the training PSNR, and every parameter gradient
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
    cfg["system"]["loss"]["lambda_distortion"] = 0.01
    j_sys = j_reg.systems.make("neus-system", j_config(copy.deepcopy(cfg)))
    j_sys.has_mask = False
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_sys.loss_fn(p, carried["j_occ"], jax.tree_util.tree_map(jnp.asarray, batch),
                                None, jnp.int32(50)), has_aux=True))(carried["j_params"])

    t_sys = t_reg.systems.make("neus-system", t_config(copy.deepcopy(cfg)), device="cpu")
    t_sys.has_mask = False
    params = _carry(carried["j_params"])
    occ = {"grid": occupancy_from_jax(carried["j_occ"]["grid"], "cpu")}
    loss, metrics = t_sys.loss_fn(params, occ, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, 50)
    assert loss.grad_fn is not None
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    assert int(metrics["train/num_samples"]) == int(j_metrics["train/num_samples"]) > 10 * N_RAYS
    assert float(metrics["train/inv_s"]) == pytest.approx(float(j_metrics["train/inv_s"]), rel=1e-6)
    assert float(metrics["train/psnr"]) == pytest.approx(float(j_metrics["train/psnr"]), abs=0.05)
    for key in ("train/loss_eikonal", "train/loss_sparsity", "train/loss_distortion"):
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]), rel=1e-3), key
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(params):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, ref[key], what=key)
        assert float(t.grad.abs().max()) > 0, key


def test_neus_trajectory_follows_jax(carried):
    """30 steps of NeuSSystem.loss_fn + AdamW (lr 0.01, eps 1e-15) in both
    packages from one transplanted state: fixed numpy batches (no jitter, a
    fixed random background, eyes around the scene), the grid held fixed,
    steps 50-79 of the cosine anneal. Per step the loss and inv_s agree within
    1e-2 relative, and every parameter leaf's distance to its JAX twin stays
    within 0.25 of the distance the JAX leaf has moved from the start (L2).

    Why these limits: each step's gradients agree within 2.5e-2 of their
    largest value (``test_neus_loss_and_gradients_match_jax``: bf16-operand
    kernels summing in another order), and Adam turns such differences into
    parameter differences that grow by about 2x every 5-6 steps. Over these
    30 steps the loss agrees to about 2e-3, inv_s to about 5e-3 and the
    worst leaf to about 0.1 of its movement; a port that departed from the
    JAX package (another update, a lost gradient term, inv_s falling in one
    package and rising in the other) exceeds them within a few steps."""
    import optax

    from instant_nsr_pl_tpu.systems.optimizers import make_optimizer as j_make_optimizer
    from instant_nsr_pl_tpu_torch.systems.optimizers import make_optimizer as t_make_optimizer

    steps, rs = 30, np.random.RandomState(7)
    batches = []
    for k in range(steps):
        ang = 2 * np.pi * k / steps
        eye = np.array([2.5 * np.cos(ang), 2.5 * np.sin(ang), 0.8], np.float32)
        d = -eye / np.linalg.norm(eye) + rs.randn(N_RAYS, 3).astype(np.float32) * 0.25
        batches.append({
            "rays_o": np.broadcast_to(eye, (N_RAYS, 3)).copy(),
            "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
            "rgb": rs.rand(N_RAYS, 3).astype(np.float32),
            "fg_mask": np.ones(N_RAYS, np.float32),
            "background_color": rs.rand(N_RAYS, 3).astype(np.float32),
        })
    cfg = _cfg()
    cfg["model"]["randomized"] = False
    j_sys = j_reg.systems.make("neus-system", j_config(copy.deepcopy(cfg)))
    j_sys.has_mask = False
    tx, _ = j_make_optimizer(j_config(copy.deepcopy(cfg)).system.optimizer, None,
                             carried["j_params"])

    @jax.jit
    def j_step(p, opt_state, batch, step):
        (loss, metrics), g = jax.value_and_grad(
            lambda p: j_sys.loss_fn(p, carried["j_occ"], batch, None, step), has_aux=True)(p)
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, metrics["train/inv_s"]

    t_sys = t_reg.systems.make("neus-system", t_config(copy.deepcopy(cfg)), device="cpu")
    t_sys.has_mask = False
    params = _carry(carried["j_params"])
    opt, _ = t_make_optimizer(t_config(copy.deepcopy(cfg)).system.optimizer, None, params)
    occ = {"grid": occupancy_from_jax(carried["j_occ"]["grid"], "cpu")}
    start = {key: t.detach().clone() for key, t in named_leaves(params)}
    jp, j_opt = carried["j_params"], tx.init(carried["j_params"])
    inv_s = []
    for k, batch in enumerate(batches):
        jp, j_opt, j_loss, j_inv_s = j_step(jp, j_opt, jax.tree_util.tree_map(jnp.asarray, batch),
                                            jnp.int32(50 + k))
        opt.zero_grad()
        loss, metrics = t_sys.loss_fn(params, occ,
                                      {kk: torch.from_numpy(v) for kk, v in batch.items()},
                                      None, 50 + k)
        loss.backward()
        opt.step(k)
        assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-2), k
        assert float(metrics["train/inv_s"]) == pytest.approx(float(j_inv_s), rel=1e-2), k
        ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jp)))
        for key, t in named_leaves(params):
            r = torch.from_numpy(np.asarray(ref[key], np.float32))
            moved = float((r - start[key]).norm())
            assert float((t.detach() - r).norm()) <= 0.25 * moved + 1e-6, (k, key)
        inv_s.append((float(metrics["train/inv_s"]), float(j_inv_s)))
    # in this window inv_s rises in both packages (the bench NeuS's falls after ~50 steps)
    assert inv_s[-1][0] > inv_s[0][0] and inv_s[-1][1] > inv_s[0][1]


def _system(cfg):
    dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    dm.setup("fit")
    system = t_reg.systems.make("neus-system", t_config(copy.deepcopy(cfg)), device="cpu")
    system.setup_data(dm.train)
    return system


def test_neus_train_step_cpu_run_learns():
    """40 steps of train_step on a 48x48 scene (128 rays, 8,192 packed
    samples, two warmup grid updates, then slab updates every 16 steps): the
    loss falls, the training PSNR rises, the grid prunes, and the val view
    renders finite normals."""
    cfg = _cfg(size=48, rays=128, capacity=8192)
    system = _system(cfg)
    state = system.init_state(seed=0)
    losses, psnrs = [], []
    for _ in range(40):
        state, metrics = system.train_step(state)
        losses.append(float(metrics["train/loss"]))
        psnrs.append(float(metrics["train/psnr"]))
    assert state["step"] == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert np.mean(psnrs[-10:]) > np.mean(psnrs[:10])
    grid = state["occ"]["grid"]
    assert 0 < int(grid.binary.sum()) < grid.binary.numel()
    res = system.evaluate_image(state, 0)
    assert res["images"]["comp_normal"].shape == (48, 48, 3)
    assert np.isfinite(res["images"]["comp_normal"]).all() and np.isfinite(res["psnr"])


def test_jax_neus_checkpoint_loads_into_port(tmp_path):
    """A JAX NeuS .npz train state with variance modulation (one extra
    leaf, prev_inv_s), written with random leaves, loaded into the port: the
    weight-normed layers, the variance scalar, the grid, extra, step and the
    Adam moments land where they belong; training continues."""
    cfg = _cfg(size=24)
    cfg["model"]["variance"] = {"init_val": 0.3, "modulate": True, "mod_start_steps": 100,
                                "reach_max_steps": 1000, "max_inv_s": 500.0}
    j_dm = j_reg.datasets.make("synthetic", j_config(copy.deepcopy(cfg))["dataset"])
    j_dm.setup("fit")
    j_sys = j_reg.systems.make("neus-system", j_config(copy.deepcopy(cfg)))
    j_sys.setup_data(j_dm.train)
    rs = np.random.RandomState(2)
    j_state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(rs.rand(*np.shape(a)), np.float32))
        if np.asarray(a).dtype == np.float32 else a, j_sys.init_state(seed=0))
    j_state["step"] = jnp.int32(37)
    path = str(tmp_path / "jax.ckpt.npz")
    j_save_checkpoint(path, j_state)

    system = _system(cfg)
    state = load_checkpoint(path, system.init_state(seed=0))
    assert state["step"] == 37
    assert float(state["extra"]["prev_inv_s"]) == float(j_state["extra"]["prev_inv_s"])
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_state["params"])))
    assert "geometry.network.layers.0.v" in ref and "variance.variance" in ref
    for key, t in named_leaves(state["params"]):
        np.testing.assert_array_equal(t.detach().numpy(), ref[key], err_msg=key)
    np.testing.assert_array_equal(state["occ"]["grid"].occs.numpy(),
                                  np.asarray(j_state["occ"]["grid"].occs))
    opt = state["optimizer"].optimizer
    inner = j_state["opt_state"].inner_states
    for group in opt.param_groups:
        adam = inner[group["name"]].inner_state[0]
        mu = [v for _, v in named_leaves(jax.tree_util.tree_map(np.asarray,
                                                                adam.mu[group["name"]]))]
        for p, m in zip(group["params"], mu):
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), m)
    state, metrics = system.train_step(state)
    assert state["step"] == 38 and np.isfinite(float(metrics["train/loss"]))


def test_launcher_trains_neus_on_cpu(tmp_path):
    """``python -m instant_nsr_pl_tpu_torch.launch --train --device cpu`` with
    a small NeuS config: four steps write checkpoints and CSV logs and
    validate once, then the automatic test renders the test view and
    exports the mesh (a 16^3 isosurface); --validate resumes the last
    checkpoint."""
    cfg = _cfg(size=24, rays=64, capacity=4096)
    cfg_path = tmp_path / "neus.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    exp = tmp_path / "exp"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "instant_nsr_pl_tpu_torch.launch", "--config", str(cfg_path),
           "--device", "cpu", "--exp_dir", str(exp), "dataset.n_test=1",
           "model.geometry.isosurface.resolution=16"]
    out = subprocess.run(cmd + ["--train"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (trial,) = os.listdir(exp / "neus-cp-small")
    run = exp / "neus-cp-small" / trial
    assert sorted(os.listdir(run / "ckpt")) == ["step=4.ckpt"]
    assert "[test] view 0: psnr=" in out.stdout
    assert (run / "save" / "it4-neus.obj").exists()
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows if r.get("train/loss")] == ["2", "4"]
    assert float([r for r in rows if r.get("train/inv_s")][-1]["train/inv_s"]) > 20.0
    assert "[val] view 0" in out.stdout
    out = subprocess.run(cmd + ["--validate", "--resume", str(run / "ckpt" / "step=4.ckpt")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[val] view 0" in out.stdout


@pytest.mark.parametrize("what", ["learned_background", "progressive_eps", "stack_scales",
                                  "lambda_distortion_bg"])
def test_later_slices_raise(what):
    """Options of later slices, now ported, on this config: the learned
    background (slice 9) builds its NeRF field and its 256^3 grid in
    contracted space, and ``lambda_distortion_bg`` without a background is
    ignored, as in the JAX package; ``stack_scales`` on this config's
    non-nested resolutions (16, 48) raises ValueError ("nested"), as the JAX
    package does; the progressive eps on this config's CP encoding raises
    ValueError naming the otype (the JAX package asserts when the eps is
    asked for)."""
    cfg = _cfg()
    if what == "learned_background":
        cfg["model"].update({
            "learned_background": True, "num_samples_per_ray_bg": 64,
            "geometry_bg": {"name": "volume-density", "radius": RADIUS, "feature_dim": 8,
                            "xyz_encoding_config": {"otype": "HashGrid", "n_levels": 4,
                                                    "n_features_per_level": 2,
                                                    "log2_hashmap_size": 12,
                                                    "base_resolution": 16,
                                                    "per_level_scale": 1.5},
                            "mlp_network_config": {"otype": "VanillaMLP", "n_neurons": 32,
                                                   "n_hidden_layers": 1,
                                                   "activation": "ReLU",
                                                   "output_activation": "none"}},
            "texture_bg": {"name": "volume-radiance", "input_feature_dim": 8,
                           "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
                           "mlp_network_config": {"otype": "VanillaMLP", "n_neurons": 32,
                                                  "n_hidden_layers": 1, "activation": "ReLU",
                                                  "output_activation": "Sigmoid"}}})
        model = t_reg.systems.make("neus-system", t_config(cfg), device="cpu").model
        assert model.learned_background and model.occ_spec_bg.resolution == 256
        assert model.occ_spec_bg.contraction_type.value == "un_bounded_sphere"
        return
    if what == "lambda_distortion_bg":
        cfg["system"]["loss"]["lambda_distortion_bg"] = 0.01
        assert not t_reg.systems.make("neus-system", t_config(cfg),
                                      device="cpu").model.learned_background
        return
    if what == "progressive_eps":  # ported in slice 7, for a ProgressiveBandHashGrid only
        cfg["model"]["geometry"] = _geometry("finite_difference")
        cfg["model"]["geometry"]["finite_difference_eps"] = "progressive"
        match = "ProgressiveBandHashGrid encoding, got otype 'CP'"
    else:
        cfg["model"]["geometry"]["xyz_encoding_config"]["stack_scales"] = True
        match = "nested"
    with pytest.raises(ValueError, match=match):
        t_reg.systems.make("neus-system", t_config(cfg), device="cpu")
