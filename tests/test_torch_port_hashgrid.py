"""The hash-grid slice end to end, port against the JAX package, at small
widths (HashGrid of 5 levels, 2^12 rows: 3 dense and 2 hashed levels; MLPs
32 wide): a hash NeRF's composited chunk and one training step's loss and
gradients from transplanted JAX parameters and an SDF occupancy grid; the
JAX ``.npz`` train state of a hash NeRF loaded into the port; the
finite-difference NeuS SDF and its gradients; the analytic and progressive
NeuS geometries on a hash grid built (slice 7; their values against JAX are
in ``test_torch_port_neus_hash.py``); and the repo's ``configs/nerf-synthetic.yaml`` through
the port's launcher on the CPU (train, test, export) with size overrides.

The JAX side runs ``grad_mode: fast`` (``hashgrid_encode_fast``, with the
dedup spec its NeRF configures) and texture ``fused: true`` (the Pallas SH
head in interpret mode), as on the TPU. Tolerances: chunk outputs and every
parameter gradient within 2.5e-2 of their largest reference value (the JAX
kernel tests' limit: bf16 MLP operands, and the JAX fast path's bf16 one-hot
table gradient, summed in other orders); the loss within 1e-3 relative; the
SDF, its finite-difference gradient and the features within 1e-4."""

import copy
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from instant_nsr_pl_tpu_torch.models.network_utils import (
    HashGridEncoding,
    ProgressiveBandHashGrid,
    make_trainable,
    named_leaves,
)
from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
    port_layout,
)
from instant_nsr_pl_tpu_torch.utils.savers import load_obj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADIUS = 1.5
N_RAYS = 48
HASH = {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.6,
        "grad_mode": "fast"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the CPU run shares its cores among
    several pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(size=24, rays=N_RAYS, capacity=16384):
    """The bench hash NeRF's shape at narrow widths, 1024 samples per ray."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "name": "nerf-hash-small",
        "seed": 3,
        "dataset": {"name": "synthetic", "size": size, "n_train": 4, "n_val": 1},
        "model": {
            "name": "nerf", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": rays, "max_train_num_rays": rays, "train_num_samples": capacity,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_warmup_steps": 16, "learned_background": False,
            "background_color": "random", "randomized": True,
            "geometry": {
                "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "xyz_encoding_config": dict(HASH),
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
        "trainer": {"max_steps": 4, "log_every_n_steps": 2, "val_check_interval": 4,
                    "limit_val_batches": 1},
    }


def _close(got, ref, what="", rel=2.5e-2):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


@pytest.fixture(scope="module")
def carried():
    """JAX hash-NeRF parameters (a table of order 1, biases non-zero) and a
    grid occupied where the scene SDF is below one cell diagonal."""
    model = j_reg.models.make("nerf", j_config(_cfg())["model"])
    params = model.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a, params)
    table = params["geometry"]["encoding"]["table"]
    params["geometry"]["encoding"]["table"] = jnp.asarray(
        (rs.rand(*table.shape).astype(np.float32) - 0.5) * 2.0)
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, model.occ_spec))(jnp.asarray(binary))
    jgrid = JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                  binary_dilated=dil, bricks=bricks)
    return {"j_params": params, "j_occ": {"grid": jgrid}, "j_model": model,
            "np_params": jax.tree_util.tree_map(np.asarray, params)}


def _rays(seed, n=N_RAYS):
    rs = np.random.RandomState(seed)
    eye = np.array([0.3, -2.4, 0.8], np.float32)
    d = -eye / np.linalg.norm(eye) + rs.randn(n, 3).astype(np.float32) * 0.25
    return (np.broadcast_to(eye, (n, 3)).copy(),
            (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32), rs)


def test_hash_nerf_chunk_and_training_step_match_jax(carried):
    """The model's eval forward of one chunk (comp_rgb, opacity, depth) and
    one NeRFSystem.loss_fn forward and backward on fixed rays, both packages
    with the same parameters and grid; the JAX NeRF's dedup spec and the
    port's agree."""
    cfg = _cfg()
    t_model = t_reg.models.make("nerf", t_config(copy.deepcopy(cfg))["model"])
    j_model = carried["j_model"]
    t_enc = t_model.geometry.encoding_with_network.encoding.encoding
    j_enc = j_model.geometry.encoding_with_network.encoding.encoding
    assert isinstance(t_enc, HashGridEncoding) and not t_model.geometry.encoding_with_network.fused
    assert j_enc.dedup_spec is not None and t_enc.dedup_spec is not None
    assert t_enc.dedup_spec.dedup_group_sizes == j_enc.dedup_spec.dedup_group_sizes
    tp = make_trainable(params_from_state_dict(params_from_jax(carried["np_params"]), "cpu"))
    occ = {"grid": occupancy_from_jax(carried["j_occ"]["grid"], "cpu")}

    rays_o, rays_d, rs = _rays(1)
    bg = np.ones(3, np.float32)
    ref = jax.jit(lambda p, o, dd: j_model.forward(
        p, carried["j_occ"], o, dd, background_color=bg, capacity=16384))(
        carried["j_params"], rays_o, rays_d)
    got = t_model.forward(tp, occ, torch.from_numpy(rays_o), torch.from_numpy(rays_d),
                          background_color=bg, capacity=16384)
    assert int(got["num_samples"]) == int(ref["num_samples"]) > 20 * N_RAYS
    for k in ("comp_rgb", "opacity", "depth"):
        _close(got[k], ref[k], k)
    assert 0.05 < float(got["opacity"].mean()) < 0.95  # the case is not trivial

    batch = {"rays_o": rays_o, "rays_d": rays_d, "rgb": rs.rand(N_RAYS, 3).astype(np.float32),
             "fg_mask": np.ones(N_RAYS, np.float32),
             "background_color": rs.rand(N_RAYS, 3).astype(np.float32)}
    cfg["model"]["randomized"] = False
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_sys.loss_fn(p, carried["j_occ"], b, None, jnp.int32(0)),
        has_aux=True))(carried["j_params"], jax.tree_util.tree_map(jnp.asarray, batch))
    t_sys = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    loss, metrics = t_sys.loss_fn(tp, occ, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  None, 0)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    assert float(metrics["train/psnr"]) == pytest.approx(float(j_metrics["train/psnr"]), abs=0.05)
    ref_g = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, port_layout(key, ref_g[key]), key)
        assert float(t.grad.abs().max()) > 0, key
    # the port's table is row-major (T, F), the JAX package's (F, T)
    table = tp["geometry"]["encoding"]["table"]
    assert tuple(table.shape) == (t_enc.spec.total_params, 2) and table.is_contiguous()
    np.testing.assert_array_equal(
        table.detach().numpy().T, np.asarray(carried["np_params"]["geometry"]["encoding"]["table"]))
    _close(table.grad.T, ref_g["geometry.encoding.table"], "table")


def _fill(tree, rs):
    def f(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return jnp.asarray(rs.rand(*a.shape).astype(np.float32))
        return a
    return jax.tree_util.tree_map(f, tree)


def test_jax_hash_checkpoint_loads_into_port(tmp_path):
    """A JAX .npz train state of a hash NeRF, written with random leaves:
    the table, the other parameters, the grid, the step and the AdamW
    moments land in the port's state; a training step follows."""
    cfg = _cfg(size=16)
    j_dm = j_reg.datasets.make("synthetic", j_config(copy.deepcopy(cfg))["dataset"])
    j_dm.setup("fit")
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    j_sys.setup_data(j_dm.train)
    j_state = _fill(j_sys.init_state(seed=0), np.random.RandomState(2))
    j_state["step"] = jnp.int32(11)
    inner = j_state["opt_state"].inner_states
    for key in ("geometry", "texture"):
        adam = inner[key].inner_state[0]
        inner[key] = inner[key]._replace(inner_state=(
            adam._replace(count=jnp.int32(11)), *inner[key].inner_state[1:]))
    path = str(tmp_path / "jax-hash.ckpt.npz")
    j_save_checkpoint(path, j_state)

    t_dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    t_dm.setup("fit")
    system = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    system.setup_data(t_dm.train)
    state = load_checkpoint(path, system.init_state(seed=0))
    assert state["step"] == 11
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_state["params"])))
    live = dict(named_leaves(state["params"]))
    assert "geometry.encoding.table" in live
    for key, t in live.items():
        np.testing.assert_array_equal(t.detach().numpy(), port_layout(key, ref[key]), err_msg=key)
    np.testing.assert_array_equal(live["geometry.encoding.table"].detach().numpy().T,
                                  ref["geometry.encoding.table"])  # (F, T) -> (T, F)
    opt = state["optimizer"].optimizer
    group = next(g for g in opt.param_groups if g["name"] == "geometry")
    adam = inner["geometry"].inner_state[0]
    mu = dict(named_leaves(jax.tree_util.tree_map(np.asarray, adam.mu["geometry"])))
    nu = dict(named_leaves(jax.tree_util.tree_map(np.asarray, adam.nu["geometry"])))
    table = state["params"]["geometry"]["encoding"]["table"]
    assert any(p is table for p in group["params"])
    np.testing.assert_array_equal(opt.state[table]["exp_avg"].numpy().T, mu["encoding.table"])
    np.testing.assert_array_equal(opt.state[table]["exp_avg_sq"].numpy().T, nu["encoding.table"])
    assert float(opt.state[table]["step"]) == 11
    state, metrics = system.train_step(state)
    assert state["step"] == 12 and np.isfinite(float(metrics["train/loss"]))


def _sdf_geometry(grad_type):
    return {
        "name": "volume-sdf", "radius": RADIUS, "feature_dim": 13, "grad_type": grad_type,
        "finite_difference_eps": 0.05,
        "xyz_encoding_config": {**HASH, "include_xyz": True},
        "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                               "output_activation": "none", "n_neurons": 32,
                               "n_hidden_layers": 1, "sphere_init": True,
                               "sphere_init_radius": 0.5, "weight_norm": True},
    }


def test_fd_neus_sdf_and_gradients_match_jax():
    """VolumeSDF with a hash grid and finite differences (the stencil through
    hashgrid_encode_fast: HG1/HG2 on the card, their plain versions here):
    sdf, its finite-difference gradient, the features and the Laplacian
    against the JAX package (1e-4 of their largest value, the Laplacian
    1e-3: 4 / eps^2 amplifies last-ulp sdf differences), and every
    parameter gradient of an eikonal + feature + sdf loss within 2.5e-2."""
    cfg = _sdf_geometry("finite_difference")
    j_geo = j_reg.models.make("volume-sdf", j_config(copy.deepcopy(cfg)))
    t_geo = t_reg.models.make("volume-sdf", t_config(copy.deepcopy(cfg)))
    assert isinstance(t_geo.encoding.encoding, HashGridEncoding)
    assert t_geo.encoding.encoding.grad_mode == "fast"
    rs = np.random.RandomState(3)
    params = j_geo.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05) * rs.randn(*np.shape(a)).astype(np.float32), params)
    x = rs.uniform(-1.3, 1.3, (96, 3)).astype(np.float32)

    def loss(out):
        sdf, grad, feat = out[:3]
        lib = torch if torch.is_tensor(sdf) else jnp
        norm = torch.linalg.norm(grad, dim=-1) if lib is torch else jnp.linalg.norm(grad, axis=-1)
        return ((norm - 1.0) ** 2).mean() + (feat ** 2).mean() + (sdf ** 2).mean()

    ref = jax.jit(lambda p: j_geo.apply(p, jnp.asarray(x), with_laplace=True))(params)
    g_ref = jax.jit(jax.grad(lambda p: loss(j_geo.apply(p, jnp.asarray(x)))))(params)
    tp = make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))
    out = t_geo.apply(tp, torch.from_numpy(x), with_laplace=True)
    for got, r, what in zip(out, ref, ("sdf", "grad", "feature", "laplace")):
        _close(got, r, what, rel=1e-3 if what == "laplace" else 1e-4)
    loss(t_geo.apply(tp, torch.from_numpy(x))).backward()
    g_ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    for key, t in named_leaves(tp):
        _close(t.grad, port_layout(key, g_ref[key]), key)
        assert float(t.grad.abs().max()) > 0, key


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_analytic_neus_with_hash_grid_is_refused(device):
    """No longer refused since slice 7 (the test keeps its name): a HashGrid
    SDF with analytic gradients builds on the jac path by default
    (``use_jac``, the encoding in its fast mode: HG3 / HG4 on the card), with
    ``analytic_jac: false`` in the autodiff mode, and finite differences with
    ``finite_difference_eps: progressive`` build with a
    ProgressiveBandHashGrid (its eps shrinks as the levels unmask); building
    a geometry touches no device, and on the CPU its parameters
    initialise."""
    geo = t_reg.models.make("volume-sdf", t_config(_sdf_geometry("analytic")))
    assert geo.use_jac and geo.encoding.has_jac
    assert isinstance(geo.encoding.encoding, HashGridEncoding)
    assert geo.encoding.encoding.grad_mode == "fast"
    cfg = {**_sdf_geometry("analytic"), "analytic_jac": False}
    auto = t_reg.models.make("volume-sdf", t_config(cfg))
    assert not auto.use_jac and auto.encoding.encoding.grad_mode == "autodiff"
    cfg = _sdf_geometry("finite_difference")
    cfg["finite_difference_eps"] = "progressive"
    cfg["xyz_encoding_config"] = {**cfg["xyz_encoding_config"],
                                  "otype": "ProgressiveBandHashGrid", "start_level": 2,
                                  "start_step": 0, "update_steps": 10}
    band = t_reg.models.make("volume-sdf", t_config(cfg))
    assert isinstance(band.encoding.encoding, ProgressiveBandHashGrid)
    assert float(band.finite_difference_eps(0)) > float(band.finite_difference_eps(None))
    fd = t_reg.models.make("volume-sdf", t_config(_sdf_geometry("finite_difference")))
    if device == "cpu":
        for g in (geo, auto, band, fd):
            assert g.init(torch.Generator().manual_seed(0), "cpu")["encoding"]["table"].numel()


def test_launcher_runs_repo_nerf_synthetic_config_on_cpu(tmp_path):
    """``configs/nerf-synthetic.yaml`` of the repo, unmodified, through the
    port's launcher on the CPU with size overrides (and no warmup: the
    first grid update is a slab of 128^3 / 8 cells, not all 2M through the
    plain hash encoding): --train (MultiStepLR, dynamic ray sampling from 64
    rays, the automatic test and mesh), then
    --export of the last checkpoint: test/psnr logged, the test view and an
    OBJ with valid indices written (after 4 steps the density may lie below
    the threshold everywhere: the card's run checks a non-empty mesh)."""
    exp = tmp_path / "exp"
    argv = ["--config", os.path.join(ROOT, "configs", "nerf-synthetic.yaml"), "--device", "cpu",
            "--exp_dir", str(exp), "tag=t", "dataset.size=16", "dataset.n_train=2",
            "dataset.n_test=1", "model.train_num_rays=64", "model.max_train_num_rays=128",
            "model.train_num_samples=4096", "model.eval_chunk_rays=256",
            "model.eval_num_samples=16384", "trainer.max_steps=4",
            "trainer.val_check_interval=4", "trainer.log_every_n_steps=2",
            "model.geometry.isosurface.resolution=16", "model.grid_warmup_steps=0"]
    assert launch_main(argv + ["--train"]) == 0
    (trial,) = os.listdir(exp / "nerf-synthetic")
    run = exp / "nerf-synthetic" / trial
    with open(run / "csv_logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["train/num_rays"] for r in rows if r.get("train/num_rays")][0] == "64.0"
    assert float([r for r in rows if r.get("test/psnr")][-1]["test/psnr"]) > 0
    assert sorted(os.listdir(run / "save" / "it4-test")) == ["0.json", "0.png"]
    obj = run / "save" / "it4-nerf.obj"
    assert obj.exists()
    obj.unlink()
    assert launch_main(argv + ["--export", "--resume", str(run / "ckpt" / "step=4.ckpt")]) == 0
    mesh = load_obj(str(obj))
    v, f = mesh["v_pos"], mesh["t_pos_idx"]
    assert v.shape[1:] == (3,) and f.shape[1:] == (3,)
    assert len(f) == 0 or (f.min() >= 0 and f.max() < len(v))
