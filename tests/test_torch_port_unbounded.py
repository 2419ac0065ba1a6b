"""Unbounded scenes (slice 9), port against the JAX package at small sizes:
the sphere contraction and its inverse, the cone-angle sample schedule and
the march through a 32^3 grid in contracted space, one occupancy update of
such a grid, the NeRF with ``learned_background`` and NeuS with its NeRF
background (loss and gradients against ``jax.grad``), and a JAX NeuS train
state with both grids loaded into the port.

No test updates a 256^3 grid: after both packages build a model, each gets
the same 32^3 grid spec in place of its 256^3 one (a test-only swap; neither
package has a knob for it). The hash grids are 4 levels of 2^12 rows.

Tolerances. The port's schedule rounds its affine parts as the JAX
package's compiled code does (fused multiply-adds: equal to the bit) and its
power ``(1 + c) ** k`` correctly; XLA's float32 ``pow`` is not correctly
rounded, so the distances agree within 3e-7 relative (one float32 ulp) and
the packed counts and ray offsets are compared exactly. The contraction
agrees within 4e-7 of the [0, 1] output (a few ulps: XLA rounds ``(2 -
1/|x|) / |x|`` its own way). Renders and losses within 1e-4 of their
largest value (the distortion loss, float32 prefix sums over t up to 1e4,
within 1e-3 relative); parameter gradients within 2.5e-2 of their largest
value (bf16 MLP operands, sums in other orders), as in the other slices.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instant_nsr_pl_tpu.models  # noqa: F401  (register)
import instant_nsr_pl_tpu.systems  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.datasets.synthetic import scene_sdf
from instant_nsr_pl_tpu.ops import contraction as j_con
from instant_nsr_pl_tpu.ops import marching as j_march
from instant_nsr_pl_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.ops import contraction as t_con
from instant_nsr_pl_tpu_torch.ops import marching as t_march
from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
    port_layout,
)

J_UNB = j_con.ContractionType.UN_BOUNDED_SPHERE
T_UNB = t_con.ContractionType.UN_BOUNDED_SPHERE
RES = 32  # the tests' grid in place of the models' 256^3
HASH = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 16, "per_level_scale": 1.447269237440378}
N_RAYS = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _far_points(rs, n):
    """Directions times radii log-uniform in [0.01, 1e4]."""
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * np.exp(rs.uniform(np.log(0.01), np.log(1e4), n))[:, None]).astype(np.float32)


@pytest.mark.parametrize("radius", [1.0, 0.6])
def test_sphere_contraction_and_inverse_match_jax(radius):
    """contract_to_unisphere, contract_coords and uncontract_from_unisphere
    (UN_BOUNDED_SPHERE) against the JAX package's jitted ones: within 4e-7 of
    the output's scale, the same 256^3 cell for all but 1e-4 of the points,
    and the inverse finite at the outermost cells (2 - |c| clamped at 1e-6)."""
    rs = np.random.RandomState(0)
    x = _far_points(rs, 20000)
    ref = np.asarray(jax.jit(lambda a: j_con.contract_to_unisphere(a, radius, J_UNB))(x))
    got = t_con.contract_to_unisphere(_t(x), radius, T_UNB).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-7)
    assert got.min() >= 0.0 and got.max() <= 1.0
    ref_c = jax.jit(lambda a, b, c: j_con.contract_coords(a, b, c, radius, J_UNB))(
        x[:, 0], x[:, 1], x[:, 2])
    got_c = t_con.contract_coords(_t(x[:, 0]), _t(x[:, 1]), _t(x[:, 2]), radius, T_UNB)
    for g, r in zip(got_c, ref_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=4e-7)
        assert (np.floor(g.numpy() * 256) != np.floor(np.asarray(r) * 256)).mean() <= 1e-4
    # the inverse, cell centres included the outermost ones
    u = rs.rand(20000, 3).astype(np.float32)
    u[:100] = (np.array([255.5, 128.0, 0.5]) / 256.0).astype(np.float32)
    u[100:200] = np.float32(1.0) - np.float32(2.0 ** -24)  # 1 - 1 ulp on every axis
    ref_u = np.asarray(jax.jit(lambda a: j_con.uncontract_from_unisphere(a, radius, J_UNB))(u))
    got_u = t_con.uncontract_from_unisphere(_t(u), radius, T_UNB).numpy()
    assert np.isfinite(got_u).all() and np.abs(got_u).max() < 2e6 * radius
    np.testing.assert_allclose(got_u, ref_u, rtol=1e-5, atol=1e-6)
    inner = np.linalg.norm(u * 4.0 - 2.0, axis=1) < 1.9  # the ball the inverse maps onto
    inner[:200] = False
    back = t_con.contract_to_unisphere(_t(got_u[inner]), radius, T_UNB).numpy()
    np.testing.assert_allclose(back, u[inner], rtol=0, atol=2e-4)


def test_cone_angle_schedule_matches_jax():
    """``t_schedule`` at nerf-colmap.yaml's cone angle (2,048 samples, far
    1e4, base step 0.01) against JAX ``_t_schedule`` under jit: the linear
    part equal to the bit, all of it within 3e-7 relative, the uniform
    schedule (cone angle 0) equal to the bit."""
    S, s = 2048, 0.01
    c = 10.0 ** (np.log10(1e4) / S) - 1.0
    rs = np.random.RandomState(1)
    t_min = np.concatenate([np.full(8, 0.2, np.float32),
                            rs.uniform(0.0, 8.0, 56).astype(np.float32)])
    for cone in (c, 0.0):
        ref = np.asarray(jax.jit(lambda t: j_march._t_schedule(t, s, cone, S))(t_min))
        got = t_march.t_schedule(_t(t_min), s, cone, S).numpy()
        if cone == 0.0:
            np.testing.assert_array_equal(got, ref)
            continue
        n_lin = np.ceil(np.maximum(np.float32(s / c) - t_min, 0) / np.float32(s))
        lin = np.arange(S + 1)[None, :] <= n_lin[:, None]
        np.testing.assert_array_equal(got[lin], ref[lin])
        np.testing.assert_allclose(got, ref, rtol=3e-7, atol=0)
        assert ref[:, -1].max() > 1e3 and (got[:, 1:] > got[:, :-1]).all()


def _unbounded_grid(rs, res=RES, radius=1.0, p=0.25):
    binary = rs.rand(res**3) < p
    j_spec = j_march.OccGridSpec(res, radius, J_UNB)
    t_spec = t_march.OccGridSpec(res, radius, T_UNB)
    return binary, j_spec, t_spec


def _rays(rs, n, dist=0.9):
    o = rs.randn(n, 3).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * dist
    d = -o + rs.randn(n, 3).astype(np.float32) * 0.8
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("jitter", [False, True])
def test_unbounded_march_matches_jax(jitter):
    """The cone-angle march through a 32^3 grid in contracted space (one
    probe per sample), with and without stratified jitter given as draws:
    the live count, the kept rays, the ray offsets and the packed slots'
    ray indices equal, the packed distances within 3e-7 relative."""
    rs = np.random.RandomState(2)
    binary, j_spec, t_spec = _unbounded_grid(rs)
    o, d = _rays(rs, N_RAYS)
    S, s = 2048, 0.01
    c = 10.0 ** (np.log10(1e4) / S) - 1.0
    t0 = np.full(N_RAYS, 0.2, np.float32)
    t1 = np.full(N_RAYS, 1e4, np.float32)
    u = rs.rand(N_RAYS).astype(np.float32)
    cap = N_RAYS * 256
    kw = dict(render_step_size=s, max_samples=S, capacity=cap, cone_angle=c)

    def j_fn(o, d, t0, t1, occ, u):
        if jitter:  # the JAX march's own draw, replaced by the same numbers
            t0 = t0 + u * s
        return j_march.march_rays(o, d, t0, t1, occ_binary=occ, occ_spec=j_spec, **kw)

    ref = jax.jit(j_fn)(o, d, t0, t1, binary, u)
    got = t_march.march_rays(_t(o), _t(d), _t(t0), _t(t1), occ_binary=_t(binary),
                             occ_spec=t_spec, jitter=_t(u) if jitter else None, **kw)
    assert int(got.num_valid) == int(ref.num_valid) > 20 * N_RAYS
    for name in ("ray_kept", "ray_ends", "valid", "ray_indices"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=3e-7, atol=0, err_msg=name)
    with pytest.raises(ValueError, match="AABB grid and uniform steps"):
        t_march.march_rays(_t(o), _t(d), _t(t0), _t(t1), occ_binary=_t(binary),
                           occ_spec=t_spec, occ_dilated=_t(binary), occ_stride=4, **kw)


def _field(w, xp):
    """An occupancy field of world points (float32, in numpy-like ``xp``):
    a soft ball and a far shell (radius 40), finite out to the outermost
    cells' ~1e6."""
    r = xp.sqrt((w * w).sum(-1))
    return 0.05 * xp.exp(-8.0 * (r - 0.6) ** 2) + 0.03 * xp.exp(-((r - 40.0) / 10.0) ** 2)


@pytest.mark.parametrize("mode", ["warmup", "slab"])
def test_unbounded_occupancy_update_matches_jax(mode):
    """One update of a 32^3 grid in contracted space from the same cell
    draws in both packages (every cell while warming up, else a slab):
    the points placed by the inverse contraction finite, the EMA within
    1e-6, the binary field and its dilation equal."""
    rs = np.random.RandomState(5)
    occs0 = (rs.rand(RES**3) * 0.02).astype(np.float32)
    binary0 = occs0 > 0.015
    _, j_spec, t_spec = _unbounded_grid(rs)
    state_j = _j_grid(binary0, j_spec)._replace(occs=jnp.asarray(occs0))
    key = jax.random.PRNGKey(7)
    warmup = mode == "warmup"
    phase = None if warmup else 5
    seen = []
    ref = jax.jit(lambda st: j_march.occupancy_grid_update(
        st, j_spec, key, lambda w: _field(w, jnp), occ_thre=0.01, warmup=warmup,
        phase=phase))(state_j)
    n = RES**3
    _, _, k_jit = jax.random.split(key, 3)
    draws = {"jitter": _t(jax.random.uniform(k_jit, (n if warmup else n // 8, 3)))}

    def fn(w):
        seen.append(w.numpy())
        return _field(w, torch)

    state_t = t_march.OccupancyGridState(_t(occs0), _t(binary0),
                                         t_march._postprocess_binary(_t(binary0), t_spec))
    got = t_march.occupancy_grid_update(state_t, t_spec, fn, draws=draws, occ_thre=0.01,
                                        warmup=warmup, phase=phase)
    assert np.isfinite(seen[0]).all() and np.abs(seen[0]).max() > 1e3
    np.testing.assert_allclose(got.occs.numpy(), np.asarray(ref.occs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.binary.numpy(), np.asarray(ref.binary))
    np.testing.assert_array_equal(got.binary_dilated.numpy(), np.asarray(ref.binary_dilated))
    assert got.binary.any() and (got.occs.numpy() != occs0).mean() > (0.5 if warmup else 0.05)


# ---------------------------------------------------------------------------
# the models and systems
# ---------------------------------------------------------------------------


def _init(model, seed=0):
    """The JAX model's parameters (one compiled init) plus random offsets,
    as numpy arrays, so that no gradient is zero by construction."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05) * np.asarray(rs.randn(*np.shape(a)), np.float32), params)


def _carry(params):
    return make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))


def _density(feature_dim, mlp="FullyFusedMLP", base=16):
    return {"name": "volume-density", "radius": 1.0, "feature_dim": feature_dim,
            "density_activation": "trunc_exp", "density_bias": -1,
            "xyz_encoding_config": {**HASH, "base_resolution": base},
            "mlp_network_config": {"otype": mlp, "activation": "ReLU",
                                   "output_activation": "none", "n_neurons": 32,
                                   "n_hidden_layers": 1}}


def _radiance(feature_dim, mlp="FullyFusedMLP", color_activation=None):
    cfg = {"name": "volume-radiance", "input_feature_dim": feature_dim,
           "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
           "mlp_network_config": {"otype": mlp, "activation": "ReLU",
                                  "output_activation": "Sigmoid" if color_activation is None
                                  else "none", "n_neurons": 32, "n_hidden_layers": 2}}
    if color_activation:
        cfg["color_activation"] = color_activation
    return cfg


def _nerf_cfg():
    """configs/nerf-colmap.yaml's model at narrow widths."""
    return {
        "name": "nerf-unbounded-small", "seed": 3,
        "model": {"name": "nerf", "radius": 1.0, "num_samples_per_ray": 2048,
                  "train_num_rays": N_RAYS, "max_train_num_rays": N_RAYS,
                  "train_num_samples": N_RAYS * 256, "eval_chunk_rays": 256,
                  "eval_num_samples": 65536, "grid_prune": True, "randomized": False,
                  "learned_background": True, "background_color": "random",
                  "geometry": _density(16), "texture": _radiance(16)},
        "system": {"name": "nerf-system",
                   "loss": {"lambda_rgb": 1.0, "lambda_distortion": 0.002},
                   "optimizer": {"name": "AdamW",
                                 "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15}}},
    }


def _neus_cfg():
    """configs/neus-colmap.yaml's model at narrow widths (radius 0.6, the
    VanillaMLP heads, the background's 64 samples per ray)."""
    return {
        "name": "neus-bg-small", "seed": 3,
        "model": {
            "name": "neus", "radius": 0.6, "num_samples_per_ray": 1024,
            "train_num_rays": N_RAYS, "max_train_num_rays": N_RAYS, "train_num_samples": 16384,
            "num_samples_per_ray_bg": 64, "train_num_samples_bg": 2048,
            "eval_chunk_rays": 256, "eval_num_samples": 65536, "eval_num_samples_bg": 16384,
            "grid_prune": True, "grid_prune_occ_thre": 0.001, "cos_anneal_end": 200,
            "learned_background": True, "background_color": "random", "randomized": False,
            "variance": {"init_val": 0.3, "modulate": False},
            "geometry": {
                "name": "volume-sdf", "radius": 0.6, "feature_dim": 13, "grad_type": "analytic",
                "analytic_jac": True,
                "xyz_encoding_config": {**HASH, "base_resolution": 32,
                                        "per_level_scale": 1.3195079107728942,
                                        "include_xyz": True},
                "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                       "output_activation": "none", "n_neurons": 32,
                                       "n_hidden_layers": 1, "sphere_init": True,
                                       "sphere_init_radius": 0.5, "weight_norm": True}},
            "texture": _radiance(16, "VanillaMLP", "sigmoid"),
            "geometry_bg": {**_density(8, "VanillaMLP", 32), "radius": 0.6},
            "texture_bg": _radiance(8, "VanillaMLP", "sigmoid"),
        },
        "system": {
            "name": "neus-system",
            "loss": {"lambda_rgb_mse": 10.0, "lambda_rgb_l1": 1.0, "lambda_eikonal": 0.1,
                     "lambda_distortion": 0.0, "lambda_distortion_bg": 0.01},
            "optimizer": {"name": "AdamW",
                          "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15},
                          "params": {"geometry": {"lr": 0.01}, "texture": {"lr": 0.01},
                                     "geometry_bg": {"lr": 0.01}, "texture_bg": {"lr": 0.01},
                                     "variance": {"lr": 0.001}}},
        },
    }


def _small_bg_grid(model, attr):
    """Swap the model's 256^3 grid spec for the tests' 32^3 one."""
    setattr(model, attr, dataclasses.replace(getattr(model, attr), resolution=RES))


def _j_grid(binary, spec):
    dil, bricks = jax.jit(lambda b: j_march._postprocess_binary(b, spec))(binary)
    return j_march.OccupancyGridState(jnp.asarray(binary, jnp.float32), jnp.asarray(binary),
                                      dil, bricks)


def _batch(rs, o, d):
    return {"rays_o": o, "rays_d": d, "rgb": rs.rand(len(o), 3).astype(np.float32),
            "fg_mask": np.ones(len(o), np.float32),
            "background_color": rs.rand(len(o), 3).astype(np.float32)}


def _compare_loss(j_sys, t_sys, params, j_occ, t_occ, batch, step, keys):
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_sys.loss_fn(p, j_occ, jax.tree_util.tree_map(jnp.asarray, batch), None,
                                jnp.int32(step)), has_aux=True))(params)
    tp = _carry(params)
    loss, metrics = t_sys.loss_fn(tp, t_occ, {k: _t(v) for k, v in batch.items()}, None, step)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-4)
    assert int(metrics["train/num_samples"]) == int(j_metrics["train/num_samples"])
    for key in keys:
        assert float(metrics[key]) == pytest.approx(float(j_metrics[key]), rel=1e-3), key
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, port_layout(key, ref[key]), 2.5e-2, key)
    return tp, metrics


def test_nerf_learned_background_matches_jax():
    """The NeRF with ``learned_background`` (sphere contraction, cone-angle
    march from 0.2 to 1e4, one probe per sample, no tap dedup) on a 32^3
    grid: one ``NeRFSystem.loss_fn`` with the distortion loss (t up to 1e4):
    the loss within 1e-4 relative, the live-sample count equal, the rgb and
    distortion terms and the PSNR within 1e-3, every parameter gradient
    within 2.5e-2."""
    cfg = _nerf_cfg()
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    t_sys = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    for m in (j_sys.model, t_sys.model):
        assert (m.occupancy_grid_res, m.occ_stride, m.render_step_size) == (256, 1, 0.01)
        assert m.packed_group(N_RAYS * 256) == 1
        _small_bg_grid(m, "occ_spec")
    assert t_sys.model.cone_angle == j_sys.model.cone_angle > 0
    rs = np.random.RandomState(3)
    binary = rs.rand(RES**3) < 0.3
    j_occ = {"grid": _j_grid(binary, j_sys.model.occ_spec)}
    t_occ = {"grid": occupancy_from_jax(j_occ["grid"], "cpu")}
    params = _init(j_sys.model)
    o, d = _rays(rs, N_RAYS)
    tp, metrics = _compare_loss(j_sys, t_sys, params, j_occ, t_occ, _batch(rs, o, d), 10,
                                ("train/loss_rgb", "train/loss_distortion", "train/psnr"))
    assert int(metrics["train/num_samples"]) > 20 * N_RAYS
    # the eval forward (no autograd) marches the same samples
    with torch.no_grad():
        got = t_sys.forward_eval(tp, t_occ, _t(o), _t(d), torch.ones(3), step=10)
    assert bool(got["rays_kept"].all()) and float(got["opacity"].max()) > 0.5


def _neus_systems():
    cfg = _neus_cfg()
    j_sys = j_reg.systems.make("neus-system", j_config(copy.deepcopy(cfg)))
    t_sys = t_reg.systems.make("neus-system", t_config(copy.deepcopy(cfg)), device="cpu")
    for s in (j_sys, t_sys):
        s.has_mask = False
        _small_bg_grid(s.model, "occ_spec_bg")
    return cfg, j_sys, t_sys


def test_neus_learned_background_matches_jax():
    """NeuS with its NeRF background (the fg hash SDF on HG3 / HG4's plain
    versions, the bg density on a 32^3 contracted grid marched from the far
    AABB intersection): the background's capacities, then one
    ``NeuSSystem.loss_fn`` with the background distortion loss: the loss
    within 1e-4 relative, the merged sample count equal, the rgb, eikonal and
    background distortion terms within 1e-3, every parameter gradient
    (``geometry_bg`` and ``texture_bg`` included, the bg table carried
    transposed) within 2.5e-2; the eval forward's colour is its foreground
    over its background."""
    cfg, j_sys, t_sys = _neus_systems()
    assert (t_sys.train_capacity_bg, t_sys.eval_capacity_bg) == (2048, 16384)
    assert (j_sys.train_capacity_bg, j_sys.eval_capacity_bg) == (2048, 16384)
    model = j_sys.model
    params = _init(model)
    params["variance"]["variance"] = np.float32(0.3)
    res, r = 128, 0.6
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * r - r
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    fg = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3) * 2.5) < 0.1
    rs = np.random.RandomState(4)
    bg_binary = rs.rand(RES**3) < 0.3
    j_occ = {"grid": _j_grid(fg, model.occ_spec), "grid_bg": _j_grid(bg_binary, model.occ_spec_bg)}
    t_occ = {k: occupancy_from_jax(v, "cpu") for k, v in j_occ.items()}
    o, d = _rays(rs, N_RAYS, dist=0.9)
    tp, metrics = _compare_loss(
        j_sys, t_sys, params, j_occ, t_occ, _batch(rs, o, d), 35,
        ("train/loss_rgb_mse", "train/loss_eikonal", "train/loss_distortion_bg"))
    assert float(metrics["train/loss_distortion_bg"]) > 0
    # the eval forward (no autograd): the foreground over the background
    with torch.no_grad():
        got = t_sys.forward_eval(tp, t_occ, _t(o), _t(d), torch.ones(3), step=35)
    torch.testing.assert_close(
        got["comp_rgb"], got["comp_rgb_fg"] + got["comp_rgb_bg"] * (1.0 - got["opacity"]))
    specs = t_sys.image_grid_specs({"images": {k: v.numpy() for k, v in got.items()},
                                    "gt": got["comp_rgb"].numpy()})
    assert len(specs) == 6 and specs[2]["img"] is not None


def test_jax_neus_background_state_loads_with_both_grids(tmp_path):
    """A JAX NeuS-with-background train state (random leaves, both grids,
    AdamW moments) saved as ``.npz``: ``load_checkpoint`` puts both grids,
    every parameter (hash tables transposed, ``geometry_bg`` and
    ``texture_bg`` included) and the Adam moments into the port's state,
    equal to the bit."""
    cfg, j_sys, t_sys = _neus_systems()
    rs = np.random.RandomState(6)

    def rand_leaf(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return jnp.asarray(np.asarray(rs.rand(*a.shape), np.float32) - np.float32(0.5))
        if a.dtype == bool:
            return jnp.asarray(np.asarray(rs.rand(*a.shape)) < 0.5)
        return a

    j_state = jax.tree_util.tree_map(rand_leaf, jax.jit(lambda: j_sys.init_state(seed=0))())
    assert sorted(j_state["occ"]) == ["grid", "grid_bg"]
    path = str(tmp_path / "jax-neus-bg.ckpt.npz")
    j_save_checkpoint(path, j_state)
    state = load_checkpoint(path, t_sys.init_state(seed=0))
    for name in ("grid", "grid_bg"):
        for leaf in ("occs", "binary", "binary_dilated"):
            np.testing.assert_array_equal(getattr(state["occ"][name], leaf).numpy(),
                                          np.asarray(getattr(j_state["occ"][name], leaf)),
                                          err_msg=f"{name}.{leaf}")
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_state["params"])))
    live = dict(named_leaves(state["params"]))
    assert {k for k in live if k.startswith(("geometry_bg.", "texture_bg."))}
    for key, t in live.items():
        np.testing.assert_array_equal(t.detach().numpy(), port_layout(key, ref[key]),
                                      err_msg=key)
    opt = state["optimizer"].optimizer
    table = state["params"]["geometry_bg"]["encoding"]["table"]
    adam = j_state["opt_state"].inner_states["geometry_bg"].inner_state[0]
    np.testing.assert_array_equal(opt.state[table]["exp_avg"].numpy().T,
                                  np.asarray(adam.mu["geometry_bg"]["encoding"]["table"]))
    np.testing.assert_array_equal(opt.state[table]["exp_avg_sq"].numpy().T,
                                  np.asarray(adam.nu["geometry_bg"]["encoding"]["table"]))
    assert state["step"] == int(j_state["step"])
