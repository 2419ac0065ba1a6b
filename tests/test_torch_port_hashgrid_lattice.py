"""The hash grid's tap dedup (the 27-point lattice of the coarse levels,
``instant_nsr_pl_tpu_torch/ops/hashgrid.py``: the plain versions of HG5-HG8)
against the JAX package's (``instant_nsr_pl_tpu/ops/hashgrid.py:221-455``),
fed the same seeded numpy inputs: aligned uniform-step blocks as the
group-compacted march packs them (``_blocks``), at 6 levels, base 4, scale
1.5, ``dedup_group`` 8, step 0.01 (block sizes 8 / 8 / 8 / 4 / 4 and one
per-sample level), with 2^14 rows (every dedup level dense) and 2^10 rows
(two hashed dedup levels); and at ``dedup_group`` 6 with 2^10 rows (block
sizes 6 / 6 / 6 / 6, the last hashed: a march stride of 6, from 768 samples
a ray, where no power-of-two tile of samples is a multiple of g).

Tolerances: the lattice indices, anchors and rows equal; each plain lattice
function's values within 1e-5 x max|ref| of the JAX function's (both
float32, the sums in other orders). The whole encodes (dedup spec in both
packages): features within 1e-5 x max|ref|, d x within 1e-4 x max|ref|
(float32 sums of terms of order scale x table value in other orders); the
table gradient within 8e-3 x max|ref| of the JAX custom VJPs, whose small
levels go through bf16 one-hot matmuls (``hashgrid.py:558-567``), and within
1e-5 x max|ref| of the autograd gradient of the port's float32
per-sample encode (``hashgrid_encode``, held against the JAX package's in
``tests/test_torch_port_hashgrid_ops.py``), the same function. The models: loss within 1e-3
relative and every gradient within 2.5e-2 x max|ref|, the limits of
``tests/test_torch_port_hashgrid.py`` and ``tests/test_torch_port_neus_hash.py``."""

import copy
import dataclasses
import functools

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
from instant_nsr_pl_tpu.ops import hashgrid as jh
from instant_nsr_pl_tpu.ops.marching import OccupancyGridState as JGrid
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.ops import hashgrid as th
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
    port_layout,
)
from tests.test_torch_port_hashgrid_ops import _blocks, _pt

BASE = dict(n_levels=6, n_features_per_level=2, base_resolution=4, per_level_scale=1.5,
            dedup_group=8, dedup_step=0.01)
SPECS = {"dense": dict(BASE, log2_hashmap_size=14), "hashed": dict(BASE, log2_hashmap_size=10),
         "group6": dict(BASE, log2_hashmap_size=10, dedup_group=6)}
GROUPS = {"dense": (8, 8, 8, 4, 4, 0), "hashed": (8, 8, 8, 4, 4, 0), "group6": (6, 6, 6, 6, 0, 0)}
FUNCTIONS = ("gather", "feat", "bwd", "feat_jac", "jac_bwd")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(name):
    js, ts = jh.HashGridSpec(**SPECS[name]), th.HashGridSpec(**SPECS[name])
    assert ts.dedup_group_sizes == js.dedup_group_sizes == GROUPS[name]
    return js, ts


def _within(got, ref, rel, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert scale > 0 and err <= rel * scale, (what, err, rel * scale)


def _case(js, seed=6):
    """``_blocks``' runs, then an all-identical padding block, blocks on the
    box's faces and corners (positions at 0 and 1: clamped rows), and blocks
    whose first sample is grid-aligned at level 0 (as JAX
    tests/test_hashgrid_jac.py:207): table of order 0.1, both cotangents."""
    g = js.dedup_group
    s0 = js.scales[0]
    aligned = ((np.arange(1, 3, dtype=np.float64) - 0.5) / s0).astype(np.float32)
    step = np.arange(g, dtype=np.float32)[:, None] * np.float32(0.002)
    extra = [np.repeat(np.float32([[0.31, 0.62, 0.47]]), g, 0),  # padding block
             np.zeros((g, 3), np.float32), np.ones((g, 3), np.float32),
             np.clip(np.float32([[0.0, 1.0, 0.5]]) + step * np.float32([[-1, 1, 1]]), 0, 1),
             np.clip(np.float32([[1.0, 0.0, 0.2]]) + step * np.float32([[1, 1, -1]]), 0, 1)]
    for k in aligned:
        extra.append(np.float32([[k, k, 0.37]]) + step * np.float32([[1, 0, 0]]))
        extra.append(np.float32([[k, 0.37, k]]) + step * np.float32([[0, 1, 0]]))
    x = np.concatenate([_blocks(js, g=g, seed=seed)] + extra).astype(np.float32)
    pos = x[-4 * g::g] * np.float32(s0) + np.float32(0.5)
    assert np.abs(pos[:, 0] - np.round(pos[:, 0])).max() < 1e-5  # grid-aligned at level 0
    rs = np.random.RandomState(seed + 1)
    table = ((rs.rand(js.n_features_per_level, js.total_params) - 0.5) * 0.2).astype(np.float32)
    ct_f = rs.randn(x.shape[0], js.n_output_dims).astype(np.float32)
    ct_j = rs.randn(3, x.shape[0], js.n_output_dims).astype(np.float32)
    return x, table, ct_f, ct_j


def _jax_lattice(js, fn, table, xt, ct_f, ct_j):
    """JAX's ``_level_lattice_<fn>`` on every dedup level of ``js``, in one
    jit: per level (gather outputs, fn's outputs)."""
    f = js.n_features_per_level

    def run(t, a, cf, cj):
        outs = []
        for level, g in enumerate(js.dedup_group_sizes):
            if not g:
                continue
            idx, vals, _, anchor = jh._level_lattice_gather(t, a, js, level, g)
            ctl, ctj = cf[:, level * f:(level + 1) * f], cj[:, :, level * f:(level + 1) * f]
            res = {"feat": lambda: jh._level_lattice_feat(t, a, js, level, g)[0],
                   "feat_jac": lambda: jh._level_lattice_feat_jac(t, a, js, level, g)[:2],
                   "bwd": lambda: jh._level_lattice_bwd(js, a, level, g, idx, vals, anchor,
                                                        ctl),
                   "jac_bwd": lambda: jh._level_lattice_jac_bwd(js, a, level, g, idx, vals,
                                                                anchor, ctl, ctj),
                   "gather": lambda: ()}[fn]()
            outs.append(((idx, vals, anchor), res))
        return outs
    return jax.jit(run)(table, xt, ct_f, ct_j)


@pytest.mark.parametrize("name", ["dense", "hashed"])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_lattice_function_matches_jax(fn, name):
    """Each plain lattice function against its JAX counterpart on every dedup
    level: ``level_lattice_gather``'s rows, anchors and gathered values
    equal; the feat, bwd, feat_jac and jac_bwd values within 1e-5 x
    max|ref| (the update rows of the bwd functions equal)."""
    js, ts = _specs(name)
    x, table, ct_f, ct_j = _case(js)
    xt = np.ascontiguousarray(x.T)
    t_table, t_xt = _pt(table), torch.from_numpy(xt)
    f = js.n_features_per_level
    refs = iter(_jax_lattice(js, fn, table, xt, ct_f, ct_j))
    for level, g in enumerate(ts.dedup_group_sizes):
        if not g:
            continue
        (j_idx, j_vals, j_a), ref = next(refs)
        idx, vals, _, a = th.level_lattice_gather(t_table, t_xt, ts, level, g)
        ctl = torch.from_numpy(ct_f[:, level * f:(level + 1) * f])
        ctj = torch.from_numpy(ct_j[:, :, level * f:(level + 1) * f])
        tag = f"level {level} g {g}"
        if fn == "gather":
            np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx), err_msg=tag)
            np.testing.assert_array_equal(a.numpy(), np.asarray(j_a), err_msg=tag)
            np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals).transpose(2, 1, 0))
        elif fn == "feat":
            _within(th.level_lattice_feat(t_table, t_xt, ts, level, g)[0], ref, 1e-5, tag)
        elif fn == "feat_jac":
            feat, jac, _ = th.level_lattice_feat_jac(t_table, t_xt, ts, level, g)
            _within(feat, ref[0], 1e-5, tag + " feat")
            _within(jac, ref[1], 1e-5, tag + " jac")
        else:
            got = (th.level_lattice_bwd(ts, t_xt, level, g, idx, vals, a, ctl) if fn == "bwd"
                   else th.level_lattice_jac_bwd(ts, t_xt, level, g, idx, vals, a, ctl, ctj))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), err_msg=tag)
            _within(got[1], ref[1], 1e-5, tag + " updates")
            _within(got[2], ref[2], 1e-5, tag + " d x")


@functools.lru_cache(maxsize=None)
def _jax_encodes(name):
    """jit of the JAX fast encode's and jac encode's outputs with their VJPs
    for one spec, each a function of (table, x, mask, cotangents...): one
    compile each per spec (no mask is a mask of ones)."""
    js = _specs(name)[0]

    def fast(t, a, m, ct):
        out, vjp = jax.vjp(lambda t, a: jh.hashgrid_encode_fast(t, a, js, m), t, a)
        return out, vjp(ct)

    def with_jac(t, a, m, cf, cj):
        out, vjp = jax.vjp(lambda t, a: jh.hashgrid_encode_with_jac(t, a, js, m), t, a)
        return out, vjp((cf, cj))

    return jax.jit(fast), jax.jit(with_jac)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["hashed", "group6"])
def test_dedup_encodes_match_jax(name, masked):
    """``hashgrid_encode_fast`` and ``hashgrid_encode_with_jac`` with the
    dedup spec (the plain HG1 + HG5 / HG2 + HG6 and HG3 + HG7 / HG4 + HG8)
    against the JAX package's with the same spec, on ``_case``'s blocks
    (padding, clamped and grid-aligned ones included), with and without a
    level mask holding a 0.5 and a 0: features, Jacobian, d x, and the table
    gradient against the JAX custom VJP and against the autograd gradient of
    the port's per-sample float32 encode. Both specs hold dense and hashed
    dedup levels. The dedup levels really take the lattice: the
    spec's lattice premise holds, and a per-sample spec gives other bits."""
    js, ts = _specs(name)
    x, table, ct_f, ct_j = _case(js, seed=8)
    assert th.lattice_cover_ok(ts, torch.from_numpy(x))
    mask = np.float32([1.0, 0.5, 1.0, 0.0, 1.0, 1.0] if masked else [1.0] * 6)
    tm = torch.from_numpy(mask) if masked else None
    fast, with_jac = _jax_encodes(name)
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    (th.hashgrid_encode(t, a, ts, tm) * torch.from_numpy(ct_f)).sum().backward()
    jt_plain, jx_plain = t.grad.T, a.grad

    ref, (jt, jx) = fast(table, x, mask, ct_f)
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    out = th.hashgrid_encode_fast(t, a, ts, tm)
    (out * torch.from_numpy(ct_f)).sum().backward()
    _within(out, ref, 1e-5, "features")
    per_sample = th.hashgrid_encode_fast(_pt(table), torch.from_numpy(x),
                                         dataclasses.replace(ts, dedup_group=0))
    assert not torch.equal(out.detach(), per_sample)  # the lattice levels ran
    _within(a.grad, jx, 1e-4, "d x")
    _within(a.grad, jx_plain, 1e-4, "d x against the per-sample encode")
    _within(t.grad.T, jt, 8e-3, "d table")
    _within(t.grad.T, jt_plain, 1e-5, "d table against the per-sample encode")

    (rf, rj), (jt, jx) = with_jac(table, x, mask, ct_f, ct_j)
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    feat, jac = th.hashgrid_encode_with_jac(t, a, ts, tm)
    ((feat * torch.from_numpy(ct_f)).sum() + (jac * torch.from_numpy(ct_j)).sum()).backward()
    assert torch.equal(feat.detach(), out.detach())  # HG3 + HG7's features are HG1 + HG5's
    _within(feat, rf, 1e-5, "jac path features")
    _within(jac, rj, 1e-5, "Jacobian")
    _within(a.grad, jx, 1e-4, "jac path d x")
    _within(t.grad.T, jt, 8e-3, "jac path d table")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_lattice_cover_premise(name):
    """``lattice_cover_ok`` holds on the march's aligned blocks and fails on a
    block whose span reaches 2 cells of a dedup level, and on a sample count
    that the block size does not divide."""
    js, ts = _specs(name)
    g = js.dedup_group
    x = _blocks(js, g=g, seed=9)
    assert th.lattice_cover_ok(ts, torch.from_numpy(x))
    assert th.lattice_cover_ok(dataclasses.replace(ts, dedup_group=0), torch.from_numpy(x[:5]))
    assert not th.lattice_cover_ok(ts, torch.from_numpy(x[:-3]))
    wide = x.copy()
    wide[g:2 * g, 0] = np.linspace(0.1, 0.1 + 2.0 / js.scales[0], g, dtype=np.float32)
    assert not th.lattice_cover_ok(ts, torch.from_numpy(wide))


RADIUS = 1.5
N_RAYS = 16
HASH = {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
        "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.6,
        "grad_mode": "fast"}
MLP = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}


def _model_cfg(kind):
    """A hash NeRF or a NeuS on the analytic jac path (the JAX package's
    ``grad_mode: fast``, ``analytic_jac: true``), 1024 samples a ray (k = 8:
    each of the grid's 3 levels a dedup level of 8), narrow MLPs."""
    texture = {"name": "volume-radiance", "input_feature_dim": 16, "fused": False,
               "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
               "mlp_network_config": {**MLP, "n_hidden_layers": 2,
                                      "output_activation": "Sigmoid" if kind == "nerf"
                                      else "none"}}
    model = {"name": kind, "radius": RADIUS, "num_samples_per_ray": 1024,
             "train_num_rays": N_RAYS, "max_train_num_rays": N_RAYS, "train_num_samples": 8192,
             "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
             "grid_prune": True, "grid_warmup_steps": 2, "learned_background": False,
             "background_color": "random", "randomized": False, "texture": texture}
    if kind == "nerf":
        model["geometry"] = {
            "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
            "density_activation": "trunc_exp", "density_bias": -1,
            "xyz_encoding_config": dict(HASH),
            "mlp_network_config": {**MLP, "output_activation": "none", "n_hidden_layers": 1}}
        system = {"name": "nerf-system", "loss": {"lambda_rgb": 1.0, "lambda_distortion": 0.0}}
    else:
        model.update({"grid_prune_occ_thre": 0.001, "cos_anneal_end": 200,
                      "variance": {"init_val": 0.3, "modulate": False}})
        texture["color_activation"] = "sigmoid"
        model["geometry"] = {
            "name": "volume-sdf", "radius": RADIUS, "feature_dim": 13, "grad_type": "analytic",
            "analytic_jac": True, "xyz_encoding_config": {**HASH, "include_xyz": True},
            "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                   "output_activation": "none", "n_neurons": 32,
                                   "n_hidden_layers": 1, "sphere_init": True,
                                   "sphere_init_radius": 0.5, "weight_norm": True}}
        system = {"name": "neus-system",
                  "loss": {"lambda_rgb_mse": 10.0, "lambda_rgb_l1": 0.0, "lambda_eikonal": 0.1,
                           "lambda_sparsity": 0.01, "lambda_curvature": 0.0,
                           "lambda_distortion": 0.01, "lambda_distortion_bg": 0.0}}
    system["optimizer"] = {"name": "AdamW",
                           "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1.0e-15}}
    return {"name": f"{kind}-lattice", "seed": 3,
            "dataset": {"name": "synthetic", "size": 16, "n_train": 2, "n_val": 1},
            "model": model, "system": system,
            "trainer": {"max_steps": 2, "log_every_n_steps": 1, "val_check_interval": 2}}


def _inner_encoding(model):
    geo = model.geometry
    enc = geo.encoding_with_network.encoding if hasattr(geo, "encoding_with_network") \
        else geo.encoding
    return enc.encoding


@pytest.mark.parametrize("kind", ["nerf", "neus"])
def test_models_with_lattice_match_jax(kind):
    """The port's NeRF and NeuS against the JAX package's, one transplanted
    state: equal dedup specs (each of the small grid's 3 levels a block of 8),
    then one loss_fn forward and backward on fixed rays at step 35 with a
    grid occupied where the scene SDF is below one cell diagonal: the loss
    within 1e-3 relative, the sample count equal, and every parameter
    gradient within 2.5e-2 x max|ref|. The port's step launches the lattice
    path (its grouped calls take the dedup spec)."""
    cfg = _model_cfg(kind)
    j_sys = j_reg.systems.make(f"{kind}-system", j_config(copy.deepcopy(cfg)))
    t_sys = t_reg.systems.make(f"{kind}-system", t_config(copy.deepcopy(cfg)), device="cpu")
    j_sys.has_mask = t_sys.has_mask = False
    j_enc, t_enc = _inner_encoding(j_sys.model), _inner_encoding(t_sys.model)
    assert j_enc.dedup_spec is not None and t_enc.dedup_spec is not None
    assert t_enc.dedup_spec.dedup_group_sizes == j_enc.dedup_spec.dedup_group_sizes == (8,) * 3
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda v: v + np.float32(0.05) * np.asarray(rs.randn(*np.shape(v)), np.float32),
        j_sys.model.init(jax.random.PRNGKey(0)))
    if kind == "neus":
        params["variance"]["variance"] = jnp.float32(0.3)
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, xg = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([xg, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, j_sys.model.occ_spec))(jnp.asarray(binary))
    j_occ = {"grid": JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                           binary_dilated=dil, bricks=bricks)}
    eye = np.array([0.3, -2.4, 0.8], np.float32)
    d = -eye / np.linalg.norm(eye) + rs.randn(N_RAYS, 3).astype(np.float32) * 0.25
    batch = {"rays_o": np.broadcast_to(eye, (N_RAYS, 3)).copy(),
             "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
             "rgb": rs.rand(N_RAYS, 3).astype(np.float32),
             "fg_mask": np.ones(N_RAYS, np.float32),
             "background_color": rs.rand(N_RAYS, 3).astype(np.float32)}
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_sys.loss_fn(p, j_occ, jax.tree_util.tree_map(jnp.asarray, batch), None,
                                jnp.int32(35)), has_aux=True))(params)
    tp = make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))
    occ = {"grid": occupancy_from_jax(j_occ["grid"], "cpu")}
    spec_of = t_enc._spec_for
    picked = []
    t_enc._spec_for = lambda a, grouped: picked.append(spec_of(a, grouped)) or picked[-1]
    try:
        loss, metrics = t_sys.loss_fn(tp, occ, {k: torch.from_numpy(v) for k, v in
                                                batch.items()}, None, 35)
    finally:
        del t_enc._spec_for
    assert any(s is t_enc.dedup_spec for s in picked)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    assert int(metrics["train/num_samples"]) == int(j_metrics["train/num_samples"]) > 10 * N_RAYS
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    for key, t in named_leaves(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _within(t.grad, port_layout(key, ref[key]), 2.5e-2, key)
