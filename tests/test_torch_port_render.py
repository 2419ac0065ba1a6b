"""The render slice end to end, port against the JAX package: a small CP
NeRF (the bench model's shape at narrow widths) with transplanted parameters
and occupancy grid. The march must agree exactly; the composited outputs, a
rendered 32x32 synthetic view and its PSNR within the bf16 tolerance. The
JAX model runs its fused Pallas kernels in interpret mode
(grad_mode: fast, texture fused: true)."""

import copy

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
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
)

RADIUS = 1.5


def _cfg(size=32, chunk=1024, capacity=32768):
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "dataset": {"name": "synthetic", "size": size, "n_train": 1, "n_val": 1},
        "model": {
            "name": "nerf", "radius": RADIUS, "num_samples_per_ray": 1024,
            "eval_chunk_rays": chunk, "eval_num_samples": capacity,
            "grid_prune": True, "learned_background": False,
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
            "name": "nerf-system", "loss": {"lambda_rgb": 1.0},
            "optimizer": {"name": "AdamW", "args": {"lr": 0.01, "eps": 1.0e-15}},
        },
    }


@pytest.fixture(scope="module")
def carried():
    """JAX parameters (random, with non-zero biases) and a grid occupied
    where the scene SDF is below one cell diagonal, plus their port copies."""
    model = j_reg.models.make("nerf", j_config(_cfg())["model"])
    params = model.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a,
        params,
    )
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    binary = scene_sdf(pts) < np.sqrt(3.0) * 2 * RADIUS / res
    spec = model.occ_spec
    dil, bricks = jax.jit(lambda b: j_postprocess(b, spec))(jnp.asarray(binary))
    jgrid = JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                  binary_dilated=dil, bricks=bricks)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return {
        "j_params": params, "j_occ": {"grid": jgrid},
        "t_params": params_from_state_dict(params_from_jax(np_params), "cpu"),
        "t_occ": {"grid": occupancy_from_jax(jgrid, "cpu")},
        "binary": binary,
    }


def test_dilation_matches(carried):
    from instant_nsr_pl_tpu_torch.ops.marching import OccGridSpec, _postprocess_binary

    dil = _postprocess_binary(torch.from_numpy(carried["binary"]), OccGridSpec(128, RADIUS))
    np.testing.assert_array_equal(dil.numpy(), np.asarray(carried["j_occ"]["grid"].binary_dilated))


def test_nerf_forward_matches_jax(carried):
    rs = np.random.RandomState(1)
    n = 64
    eye = np.array([0.3, -2.4, 0.8], np.float32)
    d = -eye / np.linalg.norm(eye) + rs.randn(n, 3).astype(np.float32) * 0.25
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays_o = np.broadcast_to(eye, (n, 3)).copy()
    bg = np.ones(3, np.float32)

    t_model = t_reg.models.make("nerf", t_config(_cfg())["model"])
    ro, rd = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    # a capacity that keeps every ray: the live slots at the full budget
    full, *_ = t_model.march(carried["t_occ"], ro, rd, n * 1024)
    capacity = -(-int(full.ray_ends[-1]) // 512) * 512
    assert 0 < capacity < n * 1024

    j_model = j_reg.models.make("nerf", j_config(_cfg())["model"])
    ref = jax.jit(lambda p, o, dd: j_model.forward(
        p, carried["j_occ"], o, dd, background_color=bg, capacity=capacity, train=True,
    ))(carried["j_params"], rays_o, rays_d)
    got = t_model.forward(carried["t_params"], carried["t_occ"], ro, rd,
                          background_color=bg, capacity=capacity)
    samples, _, _, t_mid, grp = t_model.march(carried["t_occ"], ro, rd, capacity)
    assert grp == 8
    np.testing.assert_array_equal(samples.ray_indices.numpy(), np.asarray(ref["ray_indices"]))
    np.testing.assert_array_equal(samples.valid.numpy(), np.asarray(ref["sample_valid"]))
    np.testing.assert_array_equal(t_mid.numpy(), np.asarray(ref["points"]))
    np.testing.assert_array_equal((samples.t_ends - samples.t_starts).numpy(),
                                  np.asarray(ref["intervals"]))
    np.testing.assert_array_equal(got["rays_kept"].numpy(), np.asarray(ref["rays_kept"]))
    assert got["rays_kept"].all() and int(got["num_samples"]) == int(ref["num_samples"])
    assert int(got["num_samples"]) > 20 * n
    for k in ("comp_rgb", "opacity", "depth"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, atol=2e-2 * np.abs(r).max(), err_msg=k)
    assert 0.05 < float(got["opacity"].mean()) < 0.95  # the case is not trivial


def test_evaluate_image_matches_jax(carried):
    """NeRFSystem.evaluate_image on a 32x32 synthetic view, both packages."""
    cfg = _cfg()
    j_dm = j_reg.datasets.make("synthetic", j_config(copy.deepcopy(cfg))["dataset"])
    j_dm.setup("validate")
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    j_sys.setup_data(j_dm.val)
    state = j_sys.init_state(seed=0)
    state["params"] = carried["j_params"]
    state["occ"] = carried["j_occ"]
    ref = j_sys.evaluate_image(state, 0)

    t_dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    t_dm.setup("validate")
    t_sys = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    t_sys.setup_data(t_dm.val)
    np.testing.assert_array_equal(t_sys.data["images"].numpy(), np.asarray(j_sys.data["images"]))
    t_state = {"params": carried["t_params"], "occ": carried["t_occ"]}
    got = t_sys.evaluate_image(t_state, 0)

    assert t_sys.last_render_stats["rays_kept"] == 32 * 32
    for k in ("comp_rgb", "opacity", "depth"):
        r = ref["images"][k]
        assert got["images"][k].shape == r.shape == (32, 32, r.shape[-1])
        np.testing.assert_allclose(got["images"][k], r, atol=2e-2 * np.abs(r).max(), err_msg=k)
    assert abs(got["psnr"] - ref["psnr"]) < 0.1
    assert abs(got["ssim"] - ref["ssim"]) < 1e-2


def test_system_defaults_to_cuda():
    cfg = t_config(_cfg())
    if torch.cuda.is_available():
        assert t_reg.systems.make("nerf-system", cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_reg.systems.make("nerf-system", cfg)
