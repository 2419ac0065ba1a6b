"""The port's VM and VanillaFrequency encodings against the JAX package's, fed
the same seeded numpy inputs at ``VMSpec(C=4, plane 16, line 32, 2 scales)``
(``tests/test_vm.py:17``): the dense segment sum; the plain forward
(``vm_encode``) and the fast op's forward on CPU tensors; the plain backward
(``vm_backward_plain``, VM2's plain version) against ``jax.vjp`` of
``vm_encode_fast``, its table gradients and ``d x``, with samples at u = 0
and u = 1 exactly; a second-order (eikonal-style) gradient of the composed
``autodiff`` encoding against ``jax.grad``; ``VanillaFrequency`` with and
without its mask; the factory; the NeuS SDF on a VM encoding (the analytic
gradient switches VM to ``autodiff``, as in the JAX package); one loss and
gradient step of a tiny VM NeRF carried from JAX parameters; a JAX ``.npz``
train state of a VM NeRF loaded into the port; and the port's
``configs/nerf-vm-synthetic.yaml`` through the launcher on the CPU, cut.

Tolerances: the segment sum and the forward within 1e-5
(``tests/test_vm.py``'s 1e-6 forward parity is between two JAX functions of
one expression); table gradients within rtol 2e-4 / atol 2e-5 and ``d x``
within rtol 2e-4 / atol 1e-4 (``tests/test_vm.py:69, 80``); the second-order
gradients and the NeRF's within 2.5e-2 of their largest value (the JAX
kernel tests' limit: the NeRF's bf16 MLP); the mask and frequency features
within 1e-6."""

import copy
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
from instant_nsr_pl_tpu.models import network_utils as j_nu
from instant_nsr_pl_tpu.ops import segment as j_segment
from instant_nsr_pl_tpu.ops import vm as j_vm
from instant_nsr_pl_tpu.ops.marching import OccupancyGridState as JGrid
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.launch import main as launch_main
from instant_nsr_pl_tpu_torch.models import network_utils as t_nu
from instant_nsr_pl_tpu_torch.models.network_utils import make_trainable, named_leaves
from instant_nsr_pl_tpu_torch.ops import segment as t_segment
from instant_nsr_pl_tpu_torch.ops import vm as t_vm
from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(n_components=4, plane_resolution=16, line_resolution=32, n_scales=2)
VM = {"otype": "VectorMatrix", **SPEC}
RADIUS = 1.5
N_RAYS = 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the CPU run shares its cores among
    several pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rel=2.5e-2, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _numpy_tree(tree):
    """A port parameter tree (nested dicts and lists of tensors) as nested
    numpy arrays: the JAX package's pytree, same keys and layouts (no hash
    table here, so nothing to transpose)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().numpy().copy()


def _perturbed_init(model, seed=0):
    """Parameters drawn by the port's init (JAX's eager init compiles every
    op: seconds), every leaf moved by 0.05 N(0, 1), as numpy."""
    gen = torch.Generator().manual_seed(seed)
    tree = model.init(gen, "cpu")
    return _numpy_tree(jax.tree_util.tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=gen), tree))


def _case(n=64, seed=0, edges=True):
    """Numpy tables of order 1 (lines near 1, as the init), points in [0, 1]
    with, if ``edges``, samples at exactly 0 and 1 on some axes, and a
    cotangent."""
    rs = np.random.RandomState(seed)
    j_spec = j_vm.VMSpec(**SPEC)
    params = {}
    for s in range(j_spec.n_scales):
        rp = j_spec.plane_res(s)
        for k in range(3):
            params[f"plane_{s}_{k}"] = rs.randn(rp * rp, 4).astype(np.float32)
            params[f"line_{s}_{k}"] = (1.0 + 0.3 * rs.randn(32, 4)).astype(np.float32)
    x = rs.rand(n, 3).astype(np.float32)
    if edges:
        x[:6] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.25, 0.0],
                 [0.5, 1.0, 1.0], [1 / 15, 0.5, 1.0]]
    ct = rs.randn(n, j_spec.n_output_dims).astype(np.float32)
    return j_spec, params, x, ct


@pytest.mark.parametrize("feature_major", [False, True])
def test_segment_sum_matches_jax(feature_major):
    """``segment_sum_dense_sorted``: the port's ``index_add_`` against the
    JAX two-sort sum, with empty rows, within 1e-5."""
    rs = np.random.RandomState(0)
    rows = rs.randint(0, 50, size=(300,)).astype(np.int32)
    rows[:3] = 49
    vals = rs.randn(300, 3).astype(np.float32)
    ref = j_segment.segment_sum_dense_sorted(jnp.asarray(rows), jnp.asarray(vals), 53,
                                             feature_major=feature_major)
    got = t_segment.segment_sum_dense_sorted(torch.from_numpy(rows), torch.from_numpy(vals), 53,
                                             feature_major=feature_major)
    assert tuple(got.shape) == tuple(ref.shape) == ((3, 53) if feature_major else (53, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_vm_spec_and_init():
    """``VMSpec`` field for field (its plane resolutions, the output width),
    the JAX factory's config defaults, and ``vm_init``'s leaves: the JAX
    names and shapes, planes of spread 0.1 about 0 and lines about 1."""
    for cfg in ({}, SPEC, {**SPEC, "n_scales": 3, "scale_factor": 3.0, "plane_resolution": 40}):
        j_spec, t_spec = j_vm.VMSpec.from_config(cfg), t_vm.VMSpec.from_config(cfg)
        assert {f: getattr(t_spec, f) for f in ("n_components", "plane_resolution",
                                                 "line_resolution", "n_scales", "scale_factor")} \
            == {f: getattr(j_spec, f) for f in ("n_components", "plane_resolution",
                                                 "line_resolution", "n_scales", "scale_factor")}
        assert [t_spec.plane_res(s) for s in range(4)] == [j_spec.plane_res(s) for s in range(4)]
        assert t_spec.n_output_dims == j_spec.n_output_dims
        assert t_spec.AXES == j_spec.AXES
    spec = t_vm.VMSpec(**SPEC)
    params = t_vm.vm_init(torch.Generator().manual_seed(0), spec)
    ref = jax.eval_shape(lambda k: j_vm.vm_init(k, j_vm.VMSpec(**SPEC)), jax.random.PRNGKey(0))
    assert sorted(params) == sorted(ref) == sorted(spec.keys())
    for k, t in params.items():
        assert tuple(t.shape) == tuple(ref[k].shape) and t.dtype == torch.float32, k
        mean = 1.0 if k.startswith("line") else 0.0
        assert abs(float(t.mean()) - mean) < 0.05 and 0.07 < float(t.std()) < 0.13, k


def test_vm_forward_matches_jax():
    """The plain forward and the fast op's forward on CPU tensors (the
    plain version) against JAX ``vm_encode`` within 1e-5, samples at u = 0
    and 1 included, for a batch of any shape."""
    j_spec, params, x, _ = _case()
    ref = np.asarray(j_vm.vm_encode(params, jnp.asarray(x), j_spec))
    spec = t_vm.VMSpec(**SPEC)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got = t_vm.vm_encode(tp, torch.from_numpy(x), spec)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    fast = t_vm.vm_encode_fast(tp, torch.from_numpy(x).reshape(4, 16, 3), spec)
    assert tuple(fast.shape) == (4, 16, spec.n_output_dims)
    assert torch.equal(fast.reshape(64, -1), got)
    assert t_vm.vm_forward.launches == 0  # the CPU runs no kernel


@jax.jit
def _jax_vjp(params, x, ct):
    """``jax.vjp`` of JAX ``vm_encode_fast`` at SPEC (compiled once for the
    cases that share the shapes)."""
    spec = j_vm.VMSpec(**SPEC)
    return jax.vjp(lambda p, xx: j_vm.vm_encode_fast(p, xx, spec), params, x)[1](ct)


@pytest.mark.parametrize("points", ["uniform", "interior"])
def test_vm_backward_plain_matches_jax_vjp(points):
    """VM2's plain version (and the fast op's backward on CPU tensors)
    against ``jax.vjp`` of JAX ``vm_encode_fast``: every table gradient
    within rtol 2e-4 / atol 2e-5, ``d x`` within rtol 2e-4 / atol 1e-4; on
    uniform points with samples at u = 0 and 1 (the masks drop them), and on
    points clipped to [0.02, 0.98] (``tests/test_vm.py:77``)."""
    j_spec, params, x, ct = _case(edges=points == "uniform")
    if points == "interior":
        x = np.clip(x, 0.02, 0.98)
    ref_p, ref_x = _jax_vjp(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                            jnp.asarray(ct))
    spec = t_vm.VMSpec(**SPEC)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    dparams, dx = t_vm.vm_backward_plain(tp, torch.from_numpy(x), torch.from_numpy(ct), spec,
                                         with_dx=True)
    for k in spec.keys():
        np.testing.assert_allclose(dparams[k].numpy(), np.asarray(ref_p[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_x), rtol=2e-4, atol=1e-4)
    if points == "uniform":  # the masks: no d x along an axis at exactly 0 or 1
        assert np.all(dx.numpy()[:2] == 0.0) and dx[2, 0] == 0 and dx[2, 1] == 0
    # through the autograd Function: the same gradients; d x only when asked
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_vm.vm_encode_fast(leaves, xt, spec) * torch.from_numpy(ct)).sum().backward()
    for k in spec.keys():
        torch.testing.assert_close(leaves[k].grad, dparams[k], rtol=0, atol=0)
    torch.testing.assert_close(xt.grad, dx, rtol=0, atol=0)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x)
    (t_vm.vm_encode_fast(leaves, xt, spec) * torch.from_numpy(ct)).sum().backward()
    assert xt.grad is None and all(leaves[k].grad is not None for k in spec.keys())
    # float64 sums (the card's reference for VM2's atomics)
    d64, _ = t_vm.vm_backward_plain(tp, torch.from_numpy(x), torch.from_numpy(ct), spec,
                                    accumulate=torch.float64)
    for k in spec.keys():
        assert d64[k].dtype == torch.float64
        torch.testing.assert_close(d64[k].float(), dparams[k], rtol=1e-5, atol=1e-6)


def test_vm_autodiff_second_order_matches_jax():
    """The composed ``autodiff`` encoding differentiated twice, as the NeuS
    eikonal loss does: the table gradient of ``sum(|d f / d x|^2)`` with
    ``f = sum(vm_encode(x) * ct)``, against ``jax.grad`` of the same, within
    2.5e-2 of the largest value; and the first-order ``d x`` within 1e-4."""
    j_spec, params, x, ct = _case(edges=False)
    x = np.clip(x, 0.02, 0.98)

    def j_loss(p):
        gx = jax.grad(lambda xx: (j_vm.vm_encode(p, xx, j_spec) * ct).sum())(jnp.asarray(x))
        return (gx ** 2).sum(), gx

    (_, j_gx), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    spec = t_vm.VMSpec(**SPEC)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    f = (t_vm.vm_encode(tp, xt, spec) * torch.from_numpy(ct)).sum()
    (gx,) = torch.autograd.grad(f, xt, create_graph=True)
    _close(gx, j_gx, rel=1e-4, what="d x")
    (gx ** 2).sum().backward()
    for k in spec.keys():
        _close(tp[k].grad, j_g[k], what=k)
        assert float(tp[k].grad.abs().max()) > 0, k


@pytest.mark.parametrize("n_masking_step,step", [(0, None), (0, 7), (100, None), (100, 0),
                                                 (100, 33), (100, 80), (100, 250)])
def test_vanilla_frequency_matches_jax(n_masking_step, step):
    """``VanillaFrequency``'s mask and features against the JAX module at
    steps before, inside and after the coarse-to-fine window (and with no
    masking), within 1e-6 (sin / cos of 2^5 x rounded in float32)."""
    cfg = {"otype": "VanillaFrequency", "n_frequencies": 6, "n_masking_step": n_masking_step}
    j_enc = j_nu.VanillaFrequency(3, cfg)
    t_enc = t_nu.VanillaFrequency(3, cfg)
    assert t_enc.n_output_dims == j_enc.n_output_dims == 36
    j_step = None if step is None else jnp.int32(step)
    np.testing.assert_allclose(t_enc.mask(step).numpy(), np.asarray(j_enc.mask(j_step)),
                               rtol=0, atol=1e-6)
    x = np.random.RandomState(0).rand(40, 3).astype(np.float32)
    ref = np.asarray(j_enc.apply({}, jnp.asarray(x), j_step))
    got = t_enc.apply({}, torch.from_numpy(x), step)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_factory_builds_vm_and_frequency_encodings():
    """``get_encoding`` builds ``VanillaFrequency``, ``VectorMatrix`` and
    ``VM`` with and without ``include_xyz``, at the JAX factory's widths and
    values; a VM ``grad_mode`` other than fast / autodiff raises, as CP's."""
    x = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    for cfg in ({**VM, "n_scales": 1}, {**VM, "otype": "VM"},
                {"otype": "VanillaFrequency", "n_frequencies": 4, "n_masking_step": 10}):
        for include_xyz in (False, True):
            c = {**cfg, "include_xyz": include_xyz}
            j_enc = j_nu.get_encoding(3, c)
            t_enc = t_nu.get_encoding(3, c)
            assert t_enc.n_output_dims == j_enc.n_output_dims
            params = _numpy_tree(t_enc.init(torch.Generator().manual_seed(0)))
            ref = np.asarray(j_enc.apply(params, jnp.asarray(x), step=jnp.int32(5)))
            got = t_enc.apply(params_from_state_dict(params_from_jax(params)),
                              torch.from_numpy(x), step=5)
            assert tuple(got.shape) == ref.shape == (8, t_enc.n_output_dims)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
            assert not t_enc.has_jac
    inner = t_nu.get_encoding(3, VM).encoding
    assert isinstance(inner, t_nu.VectorMatrixEncoding) and inner.grad_mode == "fast"
    with pytest.raises(ValueError, match="grad_mode"):
        t_nu.get_encoding(3, {**VM, "grad_mode": "sort"})
    with pytest.raises(ValueError, match="no CUDA instantiation"):
        t_vm.check_instantiated(t_vm.VMSpec(n_components=6))


def _sdf_loss(out):
    sdf, grad, feat = out[:3]
    lib = torch if torch.is_tensor(sdf) else jnp
    norm = torch.linalg.norm(grad, dim=-1) if lib is torch else jnp.linalg.norm(grad, axis=-1)
    return ((norm - 1.0) ** 2).mean() + (feat ** 2).mean() + (sdf ** 2).mean()


def test_neus_sdf_on_vm_matches_jax():
    """VolumeSDF on a VM encoding with analytic gradients: VM has no
    Jacobian path, so both packages switch it to ``autodiff`` (its second
    order against JAX is the test above); sdf, gradient and features within
    1e-4 of their largest value, and every parameter gets a finite,
    non-zero gradient from an eikonal + feature + sdf loss."""
    cfg = {"name": "volume-sdf", "radius": RADIUS, "feature_dim": 13, "grad_type": "analytic",
           "xyz_encoding_config": {**VM, "include_xyz": True},
           "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                  "output_activation": "none", "n_neurons": 32,
                                  "n_hidden_layers": 1, "sphere_init": True,
                                  "sphere_init_radius": 0.5, "weight_norm": True}}
    j_geo = j_reg.models.make("volume-sdf", j_config(copy.deepcopy(cfg)))
    t_geo = t_reg.models.make("volume-sdf", t_config(copy.deepcopy(cfg)))
    assert not t_geo.use_jac and not j_geo.use_jac
    assert t_geo.encoding.encoding.grad_mode == j_geo.encoding.encoding.grad_mode == "autodiff"
    params = _perturbed_init(t_geo)
    x = np.random.RandomState(1).uniform(-1.3, 1.3, (96, 3)).astype(np.float32)
    ref = jax.jit(lambda p: j_geo.apply(p, jnp.asarray(x)))(params)
    tp = make_trainable(params_from_state_dict(params_from_jax(params), "cpu"))
    out = t_geo.apply(tp, torch.from_numpy(x))
    for got, r, what in zip(out, ref, ("sdf", "grad", "feature")):
        _close(got, r, rel=1e-4, what=what)
    _sdf_loss(out).backward()
    for key, t in named_leaves(tp):
        assert torch.isfinite(t.grad).all() and float(t.grad.abs().max()) > 0, key


def _cfg(size=24, rays=N_RAYS, capacity=16384):
    """The VM NeRF's shape (configs/nerf-vm-synthetic.yaml) at narrow
    widths, 1024 samples per ray."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "name": "nerf-vm-small",
        "seed": 3,
        "dataset": {"name": "synthetic", "size": size, "n_train": 4, "n_val": 1},
        "model": {
            "name": "nerf", "radius": RADIUS, "num_samples_per_ray": 1024,
            "train_num_rays": rays, "max_train_num_rays": rays, "train_num_samples": capacity,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_warmup_steps": 16, "learned_background": False,
            "background_color": "random", "randomized": False,
            "geometry": {
                "name": "volume-density", "radius": RADIUS, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "xyz_encoding_config": {**VM, "grad_mode": "fast"},
                "mlp_network_config": {**mlp, "output_activation": "none", "n_hidden_layers": 1},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16, "fused": False,
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


def test_vm_nerf_training_step_matches_jax():
    """One NeRFSystem.loss_fn forward and backward of a tiny VM NeRF on
    fixed rays and a grid from the scene SDF, both packages on one set of
    numpy parameters, carried to the port by ``utils/transplant.py`` (the VM
    leaves copied: (rows, C) in both packages): the loss
    within 1e-3 relative, every parameter gradient within 2.5e-2 (the VM
    tables through VM2's plain version, JAX through its two-sort custom
    VJP)."""
    cfg = _cfg()
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    t_sys = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    t_enc = t_sys.model.geometry.encoding_with_network.encoding.encoding
    assert isinstance(t_enc, t_nu.VectorMatrixEncoding) and t_enc.grad_mode == "fast"
    params = _perturbed_init(t_sys.model)
    rs = np.random.RandomState(0)
    # a grid occupied where the scene SDF is below one cell diagonal
    res = 128
    c = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 * RADIUS - RADIUS
    z, y, x = np.meshgrid(c, c, c, indexing="ij")  # flattened x-fastest
    binary = scene_sdf(np.stack([x, y, z], -1).reshape(-1, 3)) < np.sqrt(3.0) * 2 * RADIUS / res
    dil, bricks = jax.jit(lambda b: j_postprocess(b, j_sys.model.occ_spec))(jnp.asarray(binary))
    j_occ = {"grid": JGrid(occs=jnp.asarray(binary, jnp.float32), binary=jnp.asarray(binary),
                           binary_dilated=dil, bricks=bricks)}
    tp = make_trainable(params_from_state_dict(params_from_jax(params), "cpu"))
    t_occ = {"grid": occupancy_from_jax(j_occ["grid"], "cpu")}
    eye = np.array([0.3, -2.4, 0.8], np.float32)
    d = -eye / np.linalg.norm(eye) + rs.randn(N_RAYS, 3).astype(np.float32) * 0.25
    batch = {"rays_o": np.broadcast_to(eye, (N_RAYS, 3)).copy(),
             "rays_d": (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
             "rgb": rs.rand(N_RAYS, 3).astype(np.float32),
             "fg_mask": np.ones(N_RAYS, np.float32),
             "background_color": rs.rand(N_RAYS, 3).astype(np.float32)}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_sys.loss_fn(p, j_occ, b, None, jnp.int32(0)), has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    loss, _ = t_sys.loss_fn(tp, t_occ, {k: torch.from_numpy(v) for k, v in batch.items()},
                            None, 0)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-3)
    ref_g = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_grads)))
    keys = [k for k, _ in named_leaves(tp)]
    assert sum(k.startswith("geometry.encoding.vm.") for k in keys) == 12
    for key, t in named_leaves(tp):
        assert t.grad is not None and torch.isfinite(t.grad).all(), key
        _close(t.grad, ref_g[key], what=key)
        assert float(t.grad.abs().max()) > 0, key


def test_jax_vm_checkpoint_loads_into_port(tmp_path):
    """A JAX .npz train state of a VM NeRF with random leaves: the VM tables
    (copied, not transposed) and their AdamW moments land in the port's
    state; a training step follows."""
    cfg = _cfg(size=16)
    j_dm = j_reg.datasets.make("synthetic", j_config(copy.deepcopy(cfg))["dataset"])
    j_dm.setup("fit")
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    j_sys.setup_data(j_dm.train)
    rs = np.random.RandomState(2)
    j_state = jax.tree_util.tree_map(  # the state's structure, traced, not run
        lambda a: jnp.asarray(rs.rand(*a.shape).astype(np.float32)) if a.dtype == np.float32
        else jnp.zeros(a.shape, a.dtype), jax.eval_shape(lambda: j_sys.init_state(seed=0)))
    j_state["step"] = jnp.int32(11)
    inner = j_state["opt_state"].inner_states
    for key in ("geometry", "texture"):
        adam = inner[key].inner_state[0]
        inner[key] = inner[key]._replace(inner_state=(
            adam._replace(count=jnp.int32(11)), *inner[key].inner_state[1:]))
    path = str(tmp_path / "jax-vm.ckpt.npz")
    j_save_checkpoint(path, j_state)

    t_dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    t_dm.setup("fit")
    system = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    system.setup_data(t_dm.train)
    state = load_checkpoint(path, system.init_state(seed=0))
    assert state["step"] == 11
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_state["params"])))
    for key, t in named_leaves(state["params"]):
        np.testing.assert_array_equal(t.detach().numpy(), ref[key], err_msg=key)
    opt = state["optimizer"].optimizer
    adam = inner["geometry"].inner_state[0]
    mu = dict(named_leaves(jax.tree_util.tree_map(np.asarray, adam.mu["geometry"])))
    nu = dict(named_leaves(jax.tree_util.tree_map(np.asarray, adam.nu["geometry"])))
    plane = state["params"]["geometry"]["encoding"]["vm"]["plane_1_2"]
    assert tuple(plane.shape) == (64, 4)
    np.testing.assert_array_equal(opt.state[plane]["exp_avg"].numpy(), mu["encoding.vm.plane_1_2"])
    np.testing.assert_array_equal(opt.state[plane]["exp_avg_sq"].numpy(),
                                  nu["encoding.vm.plane_1_2"])
    assert float(opt.state[plane]["step"]) == 11
    state, metrics = system.train_step(state)
    assert state["step"] == 12 and np.isfinite(float(metrics["train/loss"]))


def test_launcher_runs_vm_config_on_cpu(tmp_path):
    """``instant_nsr_pl_tpu_torch/configs/nerf-vm-synthetic.yaml`` through
    the launcher on the CPU with size cuts (train, the automatic test and
    mesh): its encoding is the JAX package's VM variant
    (``scripts/ab_encodings.py:44-48``) and the run writes a mesh."""
    from instant_nsr_pl_tpu_torch.config import load_config

    path = os.path.join(ROOT, "instant_nsr_pl_tpu_torch", "configs", "nerf-vm-synthetic.yaml")
    enc = load_config(path).to_dict()["model"]["geometry"]["xyz_encoding_config"]
    assert enc == {"otype": "VectorMatrix", "n_components": 16, "plane_resolution": 512,
                   "line_resolution": 2048, "n_scales": 2}
    exp = tmp_path / "exp"
    argv = ["--config", path, "--device", "cpu", "--exp_dir", str(exp), "tag=t",
            "dataset.size=16", "dataset.n_train=2", "dataset.n_test=1",
            "model.train_num_rays=64", "model.max_train_num_rays=64",
            "model.train_num_samples=4096", "model.eval_chunk_rays=256",
            "model.eval_num_samples=16384", "trainer.max_steps=2",
            "trainer.val_check_interval=2", "model.geometry.isosurface.resolution=16",
            "model.grid_warmup_steps=0"]
    assert launch_main(argv + ["--train"]) == 0
    (trial,) = os.listdir(exp / "nerf-vm-synthetic")
    obj = exp / "nerf-vm-synthetic" / trial / "save" / "it2-nerf.obj"
    assert obj.exists()
