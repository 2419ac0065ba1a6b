"""The port's CUDA kernels on the card, each against its plain PyTorch
version (the backwards fed the same training-mode residuals), a small NeRF
forward on the card against the same forward on the CPU, and gradients
flowing through a training step on the card. Skipped without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import hashlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu_torch.config import config_from_dict
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cp_mlp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import cp_stacked as t_cps
from instant_nsr_pl_tpu_torch.ops import sh_mlp as t_sh_mlp
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, rel=2e-2):
    """Tolerance of the JAX kernel tests: bf16 operands, f32 accumulation
    (2e-2 of the largest value for forwards, 2.5e-2 for gradients, whose
    f32 sums also run in another order, with atomics)."""
    ref = ref.cpu()
    torch.testing.assert_close(got.cpu(), ref, rtol=0,
                               atol=rel * max(float(ref.abs().max()), 1e-3))


def _biased(layers, gen, device):
    return [{"w": l["w"].to(device), "b": (0.1 * torch.randn(l["b"].shape, generator=gen)).to(device)}
            for l in layers]


@pytest.mark.parametrize("n_hidden,n", [(1, 515), (1, 4096), (2, 1001)])
def test_cp_mlp_kernel_matches_plain(cuda_device, n_hidden, n):
    gen = torch.Generator().manual_seed(n)
    cp_spec = CPSpec(16, (24, 64), 8)
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    cp_params = cp_init(gen, cp_spec, cuda_device)
    layers = _biased(mlp_init(gen, mlp_spec), gen, cuda_device)
    x = torch.rand((n, 3), generator=gen) * 1.2 - 0.1
    x[:4] = torch.tensor([[0.0, 1.0, 0.5], [1 / 23, 5 / 63, 1.0], [-0.1, 1.1, 0.0], [1.0, 1.0, 1.0]])
    args = (cp_params, layers, x.to(cuda_device), cp_spec, mlp_spec)
    before = t_cp_mlp.cp_mlp_forward.launches
    got = t_cp_mlp.cp_mlp_forward(*args)
    torch.cuda.synchronize()
    assert t_cp_mlp.cp_mlp_forward.launches == before + 1
    _close(got, t_cp_mlp.cp_mlp_forward_plain(*args))


@pytest.mark.parametrize("n_post", [0, 3])
def test_sh_mlp_kernel_matches_plain(cuda_device, n_post):
    gen = torch.Generator().manual_seed(n_post)
    n_feat = 16 + n_post
    spec = MLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=32, n_hidden_layers=2)
    layers = _biased(mlp_init(gen, spec), gen, cuda_device)
    feats = torch.randn((1001, n_feat), generator=gen).to(cuda_device)
    dirs = torch.nn.functional.normalize(torch.randn((1001, 3), generator=gen), dim=-1)
    args = (layers, feats, dirs.to(cuda_device), spec, 4, 16)
    before = t_sh_mlp.sh_mlp_forward.launches
    got = t_sh_mlp.sh_mlp_forward(*args)
    torch.cuda.synchronize()
    assert t_sh_mlp.sh_mlp_forward.launches == before + 1
    _close(got, t_sh_mlp.sh_mlp_forward_plain(*args))


def test_unsupported_shape_raises(cuda_device):
    gen = torch.Generator().manual_seed(0)
    cp_spec = CPSpec(32, (24, 64), 8)  # no instantiation for C=32
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=1)
    args = (cp_init(gen, cp_spec, cuda_device), mlp_init(gen, mlp_spec, cuda_device),
            torch.rand((64, 3), device=cuda_device), cp_spec, mlp_spec)
    with pytest.raises(ValueError, match="no CUDA instantiation"):
        t_cp_mlp.cp_mlp_forward(*args)


def test_nerf_forward_cuda_matches_cpu(cuda_device):
    import instant_nsr_pl_tpu_torch.models  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState, _postprocess_binary
    from instant_nsr_pl_tpu_torch.registry import models

    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    cfg = config_from_dict({
        "name": "nerf", "radius": 1.5, "num_samples_per_ray": 1024,
        "geometry": {
            "name": "volume-density", "radius": 1.5, "feature_dim": 16,
            "density_bias": -1,
            "xyz_encoding_config": {"otype": "CP", "n_components": 16,
                                    "resolutions": [24, 64], "n_features": 8},
            "mlp_network_config": {**mlp, "n_hidden_layers": 1},
        },
        "texture": {
            "name": "volume-radiance", "input_feature_dim": 16,
            "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
            "mlp_network_config": {**mlp, "output_activation": "Sigmoid", "n_hidden_layers": 2},
        },
    })
    model = models.make("nerf", cfg)
    outs = {}
    for dev in ("cpu", cuda_device):
        params = model.init(torch.Generator().manual_seed(0), dev)
        rs = np.random.RandomState(0)
        binary = torch.as_tensor(rs.rand(128**3) < 0.05, device=dev)
        occ = {"grid": OccupancyGridState(binary.float(), binary,
                                          _postprocess_binary(binary, model.occ_spec))}
        d = torch.as_tensor((rs.randn(256, 3) * 0.3 + [0, 0, 1]).astype(np.float32))
        rays_d = torch.nn.functional.normalize(d, dim=-1).to(dev)
        rays_o = torch.tensor([0.0, 0.0, -2.5]).expand(256, 3).contiguous().to(dev)
        outs[str(dev)] = model.forward(params, occ, rays_o, rays_d,
                                       background_color=torch.ones(3, device=dev),
                                       capacity=256 * 1024)
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    assert torch.equal(cpu["rays_kept"], gpu["rays_kept"].cpu())
    assert int(cpu["num_samples"]) == int(gpu["num_samples"]) > 0
    for k in ("comp_rgb", "opacity", "depth"):
        _close(gpu[k], cpu[k])


@pytest.mark.parametrize("n_hidden,n", [(1, 515), (1, 4096), (2, 1001)])
def test_cp_mlp_backward_kernel_matches_plain(cuda_device, n_hidden, n):
    """K2 against its plain version from the residuals of one K1 training
    launch; the residuals equal the plain forward's."""
    gen = torch.Generator().manual_seed(10 + n)
    cp_spec = CPSpec(16, (24, 64), 8)
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    cp_params = cp_init(gen, cp_spec, cuda_device)
    layers = _biased(mlp_init(gen, mlp_spec), gen, cuda_device)
    x = (torch.rand((n, 3), generator=gen) * 1.2 - 0.1).to(cuda_device)
    dout = torch.randn((n, 16), generator=gen).to(cuda_device)
    ops = t_cp_mlp.cp_mlp_operands(cp_params, layers, cp_spec, mlp_spec)
    out, vsave, hsave = t_cp_mlp.cp_mlp_launch(ops, x, cp_spec, mlp_spec, train=True)
    ref_out, ref_v, ref_h = t_cp_mlp.cp_mlp_forward_plain(cp_params, layers, x, cp_spec,
                                                          mlp_spec, save_residuals=True)
    _close(out, ref_out)
    assert torch.equal(vsave, ref_v)
    _close(hsave.float(), ref_h.float())
    _, basis, ws, _ = ops
    before = t_cp_mlp.cp_mlp_backward.launches
    got = t_cp_mlp.cp_mlp_backward(x, vsave, hsave, dout, basis, ws, cp_spec, mlp_spec)
    torch.cuda.synchronize()
    assert t_cp_mlp.cp_mlp_backward.launches == before + 1
    ref = t_cp_mlp.cp_mlp_backward_plain(x, vsave, hsave, dout, basis, ws, cp_spec, mlp_spec)
    for a, b in zip([*got[0], *got[1:]], [*ref[0], *ref[1:]]):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


@pytest.mark.parametrize("n_post", [0, 3])
def test_sh_mlp_backward_kernel_matches_plain(cuda_device, n_post):
    """K4 against its plain version from the residual of one K3 training
    launch, without and with extras (fpad 16 and 24)."""
    gen = torch.Generator().manual_seed(20 + n_post)
    n_feat = 16 + n_post
    spec = MLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=32, n_hidden_layers=2)
    layers = _biased(mlp_init(gen, spec), gen, cuda_device)
    feats = torch.randn((1001, n_feat), generator=gen).to(cuda_device)
    dirs = torch.nn.functional.normalize(torch.randn((1001, 3), generator=gen), dim=-1)
    dirs = dirs.to(cuda_device)
    dout = torch.randn((1001, 3), generator=gen).to(cuda_device)
    ops = t_sh_mlp.pack_sh_mlp(layers, spec, 4, 16, n_feat)
    out, hsave = t_sh_mlp.sh_mlp_launch(ops, feats, dirs, spec, 4, train=True)
    _close(out, t_sh_mlp.sh_mlp_forward_plain(layers, feats, dirs, spec, 4, 16))
    ws, _, fpad = ops
    before = t_sh_mlp.sh_mlp_backward.launches
    got = t_sh_mlp.sh_mlp_backward(feats, dirs, hsave, dout, ws, fpad, spec, 4)
    torch.cuda.synchronize()
    assert t_sh_mlp.sh_mlp_backward.launches == before + 1
    ref = t_sh_mlp.sh_mlp_backward_plain(feats, dirs, hsave, dout, ws, fpad, spec, 4)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


def test_train_step_cuda_gradients_flow(cuda_device):
    """A small NeRF system on the card: every parameter gets a finite,
    non-zero gradient through K1-K4, and train_step launches all four."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    cfg = config_from_dict({
        "dataset": {"name": "synthetic", "size": 32, "n_train": 4, "n_val": 1},
        "model": {
            "name": "nerf", "radius": 1.5, "num_samples_per_ray": 1024, "train_num_rays": 256,
            "max_train_num_rays": 256, "train_num_samples": 32768, "dynamic_ray_sampling": False,
            "grid_warmup_steps": 16,
            "geometry": {
                "name": "volume-density", "radius": 1.5, "feature_dim": 16, "density_bias": -1,
                "xyz_encoding_config": {"otype": "CP", "n_components": 16,
                                        "resolutions": [24, 64], "n_features": 8},
                "mlp_network_config": {**mlp, "n_hidden_layers": 1},
            },
            "texture": {
                "name": "volume-radiance", "input_feature_dim": 16,
                "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
                "mlp_network_config": {**mlp, "output_activation": "Sigmoid", "n_hidden_layers": 2},
            },
        },
        "system": {"name": "nerf-system", "loss": {"lambda_rgb": 1.0},
                   "optimizer": {"name": "AdamW", "args": {"lr": 0.01, "eps": 1.0e-15}}},
    })
    dm = datasets.make("synthetic", cfg.dataset)
    dm.setup("fit")
    system = systems.make("nerf-system", cfg)
    system.setup_data(dm.train)
    state = system.init_state(seed=0)
    counters = (t_cp_mlp.cp_mlp_forward, t_cp_mlp.cp_mlp_backward,
                t_sh_mlp.sh_mlp_forward, t_sh_mlp.sh_mlp_backward)
    before = [c.launches for c in counters]
    state, metrics = system.train_step(state)  # warmup grid update, then the step
    torch.cuda.synchronize()
    assert all(c.launches > b for c, b in zip(counters, before))
    assert torch.isfinite(metrics["train/loss"])
    params = state["params"]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rays_o, rays_d, rgb, _ = system._sample_rays(system.data, gen, 256)
    batch = {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb,
             "background_color": torch.ones(3, device=cuda_device)}
    loss, _ = system.loss_fn(params, state["occ"], batch, gen, 1)
    loss.backward()
    for key, t in named_leaves(params):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), key
        assert bool((t.grad != 0).any()), key


def _product_inputs(gen, c, res, n, device):
    """Three (R, C) line tables and (3, N) coordinates with out-of-range
    values, exact 0 and 1, and every knot."""
    lines = [0.1 * torch.randn((res, c), generator=gen) for _ in range(3)]
    u3 = torch.rand((3, n), generator=gen) * 1.2 - 0.1
    knots = torch.arange(res, dtype=torch.float32) / (res - 1)
    special = torch.cat([torch.tensor([0.0, 1.0, -0.05, 1.05]), knots])[: n]
    u3[0, : special.numel()] = special
    u3[1, : special.numel()] = special.flip(0)
    u3[2, : special.numel()] = special.roll(3)
    return [t.to(device) for t in lines], u3.to(device)


@pytest.mark.parametrize("c,res,n", [(16, 24, 515), (16, 64, 4096), (64, 2048, 3001),
                                     (128, 4096, 3001)])
def test_cp_product_kernels_match_plain(cuda_device, c, res, n):
    """K5 (eval and training mode) and K6 against their plain versions: the
    residual bit for bit, prod within 2e-2 and the gradients within 2.5e-2
    of the largest plain value (the backward sums with atomics)."""
    gen = torch.Generator().manual_seed(30 + n)
    lines, u3 = _product_inputs(gen, c, res, n, cuda_device)
    stack = t_cpp.line_stack(*lines)
    before = t_cpp.cp_product.launches
    prod, vsave = t_cpp.cp_product_launch(stack, u3, res, train=True)
    prod_eval, none = t_cpp.cp_product_launch(stack, u3, res)
    torch.cuda.synchronize()
    assert t_cpp.cp_product.launches == before + 2 and none is None
    ref, ref_v = t_cpp.cp_product_plain(stack, u3, res, save_residuals=True)
    assert torch.equal(vsave, ref_v)
    assert torch.equal(prod, prod_eval)
    _close(prod, ref)
    dprod = torch.randn((c, n), generator=gen).to(cuda_device)
    before = t_cpp.cp_product_backward.launches
    got = t_cpp.cp_product_backward(stack, u3, vsave, dprod, res)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_backward.launches == before + 1
    for a, b in zip(got, t_cpp.cp_product_backward_plain(stack, u3, vsave, dprod, res)):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)
    outside = (u3 < 0) | (u3 > 1)
    assert bool((got[1][outside] == 0).all())


@pytest.mark.parametrize("c,f,res,n", [(16, 8, 24, 515), (16, 8, 64, 4096), (64, 16, 2048, 3001),
                                       (128, 16, 512, 3001)])
def test_cp_jac_basis_kernels_match_plain(cuda_device, c, f, res, n):
    """K9 (eval and training mode) and K10 against their plain versions."""
    gen = torch.Generator().manual_seed(40 + n)
    lines, u3 = _product_inputs(gen, c, res, n, cuda_device)
    stack = t_cpp.line_stack(*lines)
    basis = (torch.randn((c, f), generator=gen) / c**0.5).to(torch.bfloat16).to(cuda_device)
    before = t_cpp.cp_product_jac_basis.launches
    enc, jac, vsave, gdsave = t_cpp.cp_product_jac_basis_launch(stack, basis, u3, res, train=True)
    enc_e, jac_e, v_e, g_e = t_cpp.cp_product_jac_basis_launch(stack, basis, u3, res)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_jac_basis.launches == before + 2 and v_e is None and g_e is None
    ref = t_cpp.cp_product_jac_basis_plain(stack, basis, u3, res, save_residuals=True)
    assert torch.equal(vsave, ref[2]) and torch.equal(gdsave, ref[3])
    assert torch.equal(enc, enc_e) and torch.equal(jac, jac_e)
    _close(enc, ref[0])
    _close(jac, ref[1])
    denc = torch.randn((f, n), generator=gen).to(cuda_device)
    djac = torch.randn((3, f, n), generator=gen).to(cuda_device)
    before = t_cpp.cp_product_jac_basis_backward.launches
    got = t_cpp.cp_product_jac_basis_backward(u3, vsave, gdsave, denc, djac, basis, res)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_jac_basis_backward.launches == before + 1
    plain = t_cpp.cp_product_jac_basis_backward_plain(u3, vsave, gdsave, denc, djac, basis, res)
    for a, b in zip(got, plain):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


@pytest.mark.parametrize("c,res,n", [(16, 24, 515), (16, 64, 4096), (64, 2048, 3001),
                                     (64, 128, 262107), (128, 64, 3001)])
def test_cp_product_jac_kernels_match_plain(cuda_device, c, res, n):
    """K7 (eval and training mode) and K8 against their plain versions: the
    residuals bit for bit, prod and jac within 2e-2 and the gradients within
    2.5e-2 of the largest plain value; d u is zero outside [0, 1]."""
    gen = torch.Generator().manual_seed(50 + n)
    lines, u3 = _product_inputs(gen, c, res, n, cuda_device)
    stack = t_cpp.line_stack(*lines)
    before = t_cpp.cp_product_jac.launches
    prod, jac, vsave, gdsave = t_cpp.cp_product_jac_launch(stack, u3, res, train=True)
    prod_e, jac_e, v_e, g_e = t_cpp.cp_product_jac_launch(stack, u3, res)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_jac.launches == before + 2 and v_e is None and g_e is None
    ref = t_cpp.cp_product_jac_plain(stack, u3, res, save_residuals=True)
    assert torch.equal(vsave, ref[2]) and torch.equal(gdsave, ref[3])
    assert torch.equal(prod, prod_e) and torch.equal(jac, jac_e)
    _close(prod, ref[0])
    _close(jac, ref[1])
    dprod = torch.randn((c, n), generator=gen).to(cuda_device)
    djac = torch.randn((3, c, n), generator=gen).to(cuda_device)
    before = t_cpp.cp_product_jac_backward.launches
    got = t_cpp.cp_product_jac_backward(u3, vsave, gdsave, dprod, djac, res)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_jac_backward.launches == before + 1
    plain = t_cpp.cp_product_jac_backward_plain(u3, vsave, gdsave, dprod, djac, res)
    for a, b in zip(got, plain):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)
    outside = (u3 < 0) | (u3 > 1)
    assert bool((got[1][outside] == 0).all())


def test_neus_train_step_cuda_gradients_flow(cuda_device):
    """A small NeuS system on the card (analytic gradients on the jac path):
    train_step launches K3, K4, K9 and K10 and, in its warmup grid update,
    K5; after that first update every parameter gets a finite, non-zero
    gradient; with the raw products (no basis) K7 and K8 run once per scale;
    with finite differences K5 and K6 run on every step."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    def make(grad_type, n_features=8):
        cfg = config_from_dict({
            "dataset": {"name": "synthetic", "size": 32, "n_train": 4, "n_val": 1},
            "model": {
                "name": "neus", "radius": 1.5, "num_samples_per_ray": 1024,
                "train_num_rays": 256, "max_train_num_rays": 256, "train_num_samples": 32768,
                "dynamic_ray_sampling": False, "grid_warmup_steps": 2,
                "grid_prune_occ_thre": 0.001, "variance": {"init_val": 0.3},
                "geometry": {
                    "name": "volume-sdf", "radius": 1.5, "feature_dim": 13, "grad_type": grad_type,
                    "xyz_encoding_config": {"otype": "CP", "n_components": 16,
                                            "resolutions": [24, 64],
                                            "n_features": n_features, "include_xyz": True},
                    "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                           "n_neurons": 32, "n_hidden_layers": 1,
                                           "sphere_init": True, "weight_norm": True},
                },
                "texture": {
                    "name": "volume-radiance", "input_feature_dim": 16,
                    "dir_encoding_config": {"otype": "SphericalHarmonics", "degree": 4},
                    "mlp_network_config": {"otype": "FullyFusedMLP", "activation": "ReLU",
                                           "n_neurons": 32, "n_hidden_layers": 2},
                    "color_activation": "sigmoid",
                },
            },
            "system": {"name": "neus-system",
                       "loss": {"lambda_rgb_mse": 10.0, "lambda_eikonal": 0.1,
                                "lambda_sparsity": 0.01},
                       "optimizer": {"name": "AdamW", "args": {"lr": 0.01, "eps": 1.0e-15}}},
        })
        dm = datasets.make("synthetic", cfg.dataset)
        dm.setup("fit")
        system = systems.make("neus-system", cfg)
        system.setup_data(dm.train)
        return system

    system = make("analytic")
    state = system.init_state(seed=0)
    counters = (t_sh_mlp.sh_mlp_forward, t_sh_mlp.sh_mlp_backward, t_cpp.cp_product,
                t_cpp.cp_product_jac_basis, t_cpp.cp_product_jac_basis_backward)
    before = [c.launches for c in counters]
    state, metrics = system.train_step(state)  # warmup grid update, then the step
    torch.cuda.synchronize()
    assert all(c.launches > b for c, b in zip(counters, before))
    assert torch.isfinite(metrics["train/loss"])
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rays_o, rays_d, rgb, _ = system._sample_rays(system.data, gen, 256)
    batch = {"rays_o": rays_o, "rays_d": rays_d, "rgb": rgb,
             "background_color": torch.ones(3, device=cuda_device)}
    loss, _ = system.loss_fn(state["params"], state["occ"], batch, gen, 1)
    loss.backward()
    for key, t in named_leaves(state["params"]):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), key
        assert bool((t.grad != 0).any()), key

    # the raw products (n_features: 0): K7/K8 in place of K9/K10
    raw = make("analytic", n_features=0)
    state = raw.init_state(seed=0)
    counters = (t_cpp.cp_product_jac, t_cpp.cp_product_jac_backward)
    before = [c.launches for c in counters]
    state, metrics = raw.train_step(state)
    torch.cuda.synchronize()
    assert all(c.launches == b + 2 for c, b in zip(counters, before))  # one per scale
    assert torch.isfinite(metrics["train/loss"])

    fd = make("finite_difference")
    state = fd.init_state(seed=0)
    before = [t_cpp.cp_product.launches, t_cpp.cp_product_backward.launches]
    for _ in range(2):
        state, metrics = fd.train_step(state)
    torch.cuda.synchronize()
    assert t_cpp.cp_product.launches >= before[0] + 2 * 4
    assert t_cpp.cp_product_backward.launches >= before[1] + 2 * 4
    assert torch.isfinite(metrics["train/loss"])


@pytest.mark.parametrize("n_hidden,n", [(1, 515), (1, 4096), (2, 1001)])
def test_cp_mlp_stacked_kernels_match_plain(cuda_device, n_hidden, n):
    """K13 (eval and training mode) and K14 against their plain versions at
    the small nested spec (C=16, R=(17, 65), F=8): the same output in both
    modes, vsave bit for bit, hsave and out within 2e-2, every gradient
    (the fine table, the basis blocks, dW, db) within 2.5e-2."""
    gen = torch.Generator().manual_seed(50 + n)
    cp_spec = CPSpec(16, (17, 65), 8)
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    cp_params = cp_init(gen, cp_spec, cuda_device)
    layers = _biased(mlp_init(gen, mlp_spec), gen, cuda_device)
    x = torch.rand((n, 3), generator=gen) * 1.2 - 0.1
    x[:4] = torch.tensor([[0.0, 1.0, 0.5], [1 / 16, 5 / 64, 1.0], [-0.1, 1.1, 0.0], [1.0, 1.0, 1.0]])
    x = x.to(cuda_device)
    dout = torch.randn((n, 16), generator=gen).to(cuda_device)
    ops = t_cp_mlp.cp_mlp_stacked_operands(cp_params, layers, cp_spec, mlp_spec)
    before = t_cp_mlp.cp_mlp_stacked_forward.launches
    out, vsave, hsave = t_cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, mlp_spec, train=True)
    out_eval, none, _ = t_cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, mlp_spec)
    torch.cuda.synchronize()
    assert t_cp_mlp.cp_mlp_stacked_forward.launches == before + 2 and none is None
    assert torch.equal(out, out_eval)
    ref_out, ref_v, ref_h = t_cp_mlp.cp_mlp_stacked_forward_plain(
        cp_params, layers, x, cp_spec, mlp_spec, save_residuals=True)
    _close(out, ref_out)
    assert torch.equal(vsave, ref_v)
    _close(hsave.float(), ref_h.float())
    _, basis, ws, _ = ops
    before = t_cp_mlp.cp_mlp_stacked_backward.launches
    got = t_cp_mlp.cp_mlp_stacked_backward(x, vsave, hsave, dout, basis, ws, cp_spec, mlp_spec)
    torch.cuda.synchronize()
    assert t_cp_mlp.cp_mlp_stacked_backward.launches == before + 1
    ref = t_cp_mlp.cp_mlp_stacked_backward_plain(x, vsave, hsave, dout, basis, ws, cp_spec,
                                                 mlp_spec)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


@pytest.mark.parametrize("c,f,res,n", [(16, 8, (17, 65), 515), (16, 8, (17, 65), 4096),
                                       (64, 16, (129, 2049), 3001)])
def test_cp_jac_stacked_kernels_match_plain(cuda_device, c, f, res, n):
    """K11 (eval and training mode) and K12 against their plain versions:
    the residuals bit for bit, enc and jac within 2e-2, the fine-table, d u
    and basis gradients within 2.5e-2; d u is zero outside [0, 1]."""
    gen = torch.Generator().manual_seed(60 + n)
    cp_spec = CPSpec(c, res, f)
    cp_params = cp_init(gen, cp_spec, cuda_device)
    rmax = max(res)
    _, u3 = _product_inputs(gen, c, rmax, n, cuda_device)
    lines = t_cps.stack_lines_fine(cp_params, cp_spec)
    basis = t_cps.basis_stack(cp_params, cp_spec)
    before = t_cps.cp_jac_basis_stacked.launches
    enc, jac, vsave, gdsave = t_cps.cp_jac_basis_stacked_launch(lines, basis, u3, rmax, train=True)
    enc_e, jac_e, v_e, g_e = t_cps.cp_jac_basis_stacked_launch(lines, basis, u3, rmax)
    torch.cuda.synchronize()
    assert t_cps.cp_jac_basis_stacked.launches == before + 2 and v_e is None and g_e is None
    ref = t_cps.cp_jac_basis_stacked_plain(lines, basis, u3, rmax, save_residuals=True)
    assert torch.equal(vsave, ref[2]) and torch.equal(gdsave, ref[3])
    assert torch.equal(enc, enc_e) and torch.equal(jac, jac_e)
    _close(enc, ref[0])
    _close(jac, ref[1])
    e = len(res) * f
    denc = torch.randn((e, n), generator=gen).to(cuda_device)
    djac = torch.randn((3, e, n), generator=gen).to(cuda_device)
    before = t_cps.cp_jac_basis_stacked_backward.launches
    got = t_cps.cp_jac_basis_stacked_backward(u3, vsave, gdsave, denc, djac, basis, rmax)
    torch.cuda.synchronize()
    assert t_cps.cp_jac_basis_stacked_backward.launches == before + 1
    plain = t_cps.cp_jac_basis_stacked_backward_plain(u3, vsave, gdsave, denc, djac, basis, rmax)
    for a, b in zip(got, plain):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)
    outside = (u3 < 0) | (u3 > 1)
    assert bool((got[1][outside] == 0).all())


def test_cp_mlp_cp_big_kernels_match_plain(cuda_device):
    """K1 (training mode) and K2 at bench.py --encoding cp_big's head: C=128,
    R=(64, 512, 4096), F=16, MLP 48->64->16 (K2 reduces d basis over two
    64-component tiles): vsave bit for bit, the output within 2e-2 and the
    gradients within 2.5e-2 of the largest plain value."""
    gen = torch.Generator().manual_seed(7)
    cp_spec = CPSpec(128, (64, 512, 4096), 16)
    mlp_spec = MLPSpec(dim_in=48, dim_out=16, n_neurons=64, n_hidden_layers=1)
    cp_params = cp_init(gen, cp_spec, cuda_device)
    layers = _biased(mlp_init(gen, mlp_spec), gen, cuda_device)
    x = (torch.rand((3001, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    ops = t_cp_mlp.cp_mlp_operands(cp_params, layers, cp_spec, mlp_spec)
    out, vsave, hsave = t_cp_mlp.cp_mlp_launch(ops, x, cp_spec, mlp_spec, train=True)
    torch.cuda.synchronize()
    ref, ref_v, _ = t_cp_mlp.cp_mlp_forward_plain(cp_params, layers, x, cp_spec, mlp_spec,
                                                  save_residuals=True)
    assert torch.equal(vsave, ref_v)
    _close(out, ref)
    dout = torch.randn((3001, 16), generator=gen).to(cuda_device)
    args = (x, vsave, hsave, dout, ops[1], ops[2], cp_spec, mlp_spec)
    got = t_cp_mlp.cp_mlp_backward_launch(*args)
    torch.cuda.synchronize()
    plain = t_cp_mlp.cp_mlp_backward_plain(*args)
    for a, b in zip([*got[0], *got[1:]], [*plain[0], *plain[1:]]):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


def _bench_hash():
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    return HashGridSpec(n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
                        base_resolution=16, per_level_scale=1.447269237440378)


@pytest.mark.parametrize("masked", [False, True])
def test_hashgrid_kernels_match_plain(cuda_device, masked):
    """HG1 and HG2 at the bench hash shape (16 levels, F=2, 2^19 rows) on a
    ragged N: the forward equal to the plain version's (both round x*s+0.5
    and the corner sum as fused multiply-adds; limit rtol 1e-5), the table
    gradient within 1e-5 x max|plain| per level (float32 atomics sum in
    another order each run), the position gradient within 1e-4 x max|plain|;
    each launch counted once."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = _bench_hash()
    gen = torch.Generator().manual_seed(11)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(cuda_device)
    x = torch.rand((20011, 3), generator=gen)
    x[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0]])
    x = x.to(cuda_device)
    ct = torch.randn((20011, 32), generator=gen).to(cuda_device)
    mask = torch.linspace(1.0, 0.0, 16).to(cuda_device) if masked else None
    before = hg.hashgrid_forward.launches
    got = hg.hashgrid_forward(table, x, spec, mask)
    torch.cuda.synchronize()
    assert hg.hashgrid_forward.launches == before + 1
    ref = hg.hashgrid_encode(table, x, spec, mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    before = hg.hashgrid_backward.launches
    dt, dx = hg.hashgrid_backward(table, x, ct, spec, mask, with_dx=True)
    torch.cuda.synchronize()
    assert hg.hashgrid_backward.launches == before + 1
    rt, rx = hg.hashgrid_backward_plain(table, x, ct, spec, mask, with_dx=True)
    for lv in range(spec.n_levels):
        sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
        _close(dt[sl], rt[sl], rel=1e-5)
    _close(dx, rx, rel=1e-4)
    # through the autograd op: the table gradient, and none for x
    t = table.clone().requires_grad_(True)
    hg.hashgrid_encode_fast(t, x, spec, mask).backward(ct)
    _close(t.grad, rt, rel=1e-5)


def test_probe_kernels_match_numpy(cuda_device):
    """Each gather / scatter probe P1a-P1g and P2 (tools/microbench_gather.py)
    at a reduced M against the numpy result of the JAX scripts and its plain
    version: gathers to the bit, sums within 1e-6 of their summed
    magnitudes."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    mb.reset_launches()
    errs = mb.check_all(1 << 16, 1 << 16, cuda_device, seed=3)
    assert len(errs) == 11
    assert all(v >= 1 for v in mb.launch_counts().values())


def _onehot_inputs(m, rows, kind, seed):
    rs = np.random.RandomState(seed)
    if kind == "uniform":
        idx = rs.randint(0, rows, m)
    elif kind == "all_equal":  # one hot row: every atomic on one address
        idx = np.full(m, rows // 3 + 7)
    else:  # "ends": only the first and the last row
        idx = np.where(rs.rand(m) < 0.5, 0, rows - 1)
    return idx.astype(np.int32), (rs.randn(m, 2) * 3.0).astype(np.float32)


def _onehot_check(got, idx, upd, rows):
    """P1g against its plain version on the CPU, within 1e-6 x the largest
    summed magnitude (+1e-6): f32 sums whose order the atomics change from
    run to run."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    ref = mb.plain_onehot_grad(torch.from_numpy(idx), torch.from_numpy(upd), rows)
    mag = mb.plain_onehot_grad(torch.from_numpy(idx), torch.from_numpy(np.abs(upd)), rows)
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = float((got.cpu().double() - ref.double()).abs().max()) if ref.numel() else 0.0
    tol = 1e-6 * float(mag.abs().max()) + 1e-6
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("m,rows,kind", [
    (0, 1 << 19, "uniform"), (1, 1 << 19, "uniform"), (1023, 1 << 19, "uniform"),
    (1 << 16, 1 << 19, "uniform"), (1 << 16, 1 << 19, "all_equal"), (4099, 1 << 19, "ends"),
    (5003, 1536, "uniform"), (1 << 16, 1 << 20, "uniform"), (4096, 1536, "all_equal")])
def test_onehot_grad_edges_match_plain(cuda_device, m, rows, kind):
    """P1g (the scatter design of csrc/gather_probes.cu) at no update, one, a
    ragged count, 2^16, every index equal, indices on the first and last
    rows only, and tables of other than 2^19 rows; one launch counted."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    idx, upd = _onehot_inputs(m, rows, kind, seed=m + rows)
    before = mb.onehot_grad.launches
    got = mb.onehot_grad(torch.from_numpy(idx).to(cuda_device),
                         torch.from_numpy(upd).to(cuda_device), rows)
    torch.cuda.synchronize()
    assert mb.onehot_grad.launches == before + 1
    assert got.shape == (rows // 512, 1024)
    _onehot_check(got, idx, upd, rows)


@pytest.mark.parametrize("rows", [1, 5, 32768])
def test_sublane_gather_edges_match_plain(cuda_device, rows):
    """P1e (a 32-column slice of the table per block, rows in groups of 8) on
    one row, a ragged five and 32,768 rows: equal to torch.gather on the CPU
    to the bit."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    rs = np.random.RandomState(rows)
    idx = rs.randint(0, 512, (rows, 128)).astype(np.int32)
    idx[0, :4] = [0, 511, 0, 511]
    table = rs.randn(512, 128).astype(np.float32)
    before = mb.sublane_gather.launches
    got = mb.sublane_gather(torch.from_numpy(idx).to(cuda_device),
                            torch.from_numpy(table).to(cuda_device))
    torch.cuda.synchronize()
    assert mb.sublane_gather.launches == before + 1
    ref = mb.plain_sublane_gather(torch.from_numpy(idx), torch.from_numpy(table))
    assert torch.equal(got.cpu(), ref)


_PROBE_EDGES = [
    (0, 1 << 19, "uniform"), (1, 1 << 19, "uniform"), (2053, 1 << 19, "uniform"),
    (1 << 16, 1 << 19, "uniform"), (1 << 16, 1 << 19, "all_equal"), (4099, 1 << 19, "ends"),
    (2053, 1000, "uniform"), (4096, 1000, "all_equal")]


@pytest.mark.parametrize("m,rows,kind", _PROBE_EDGES)
def test_scalar_gather_unroll8_edges_match_plain(cuda_device, m, rows, kind):
    """P1a unroll 8 (warps over chunks of 256 consecutive indices, a
    persistent grid) at no index, one, a ragged 2,053 (not a multiple of 4,
    8 or 256), 2^16, every index on one row, indices on the first and last
    rows only, and a table of 1,000 rows: equal to table[idx] on the CPU to
    the bit; one launch counted."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    idx, _ = _onehot_inputs(m, rows, kind, seed=m + rows)
    table = np.random.RandomState(rows).randn(rows, 2).astype(np.float32)
    before = mb.scalar_gather.launches[8]
    got = mb.scalar_gather(torch.from_numpy(idx).to(cuda_device),
                           torch.from_numpy(table).to(cuda_device), 8)
    torch.cuda.synchronize()
    assert mb.scalar_gather.launches[8] == before + 1
    ref = mb.plain_gather(torch.from_numpy(idx), torch.from_numpy(table))
    assert got.shape == ref.shape == (m, 2)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("m,rows,kind", _PROBE_EDGES)
def test_scatter_add_edges_match_plain(cuda_device, m, rows, kind):
    """P1f (one 8-byte vector atomic per update into the zeroed output) at
    the edge cases of the P1a test (every index on one row: every atomic on
    one address), against index_add_ on the CPU within 1e-6 x the largest
    summed magnitude (+1e-6); one launch counted."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    idx, upd = _onehot_inputs(m, rows, kind, seed=m + rows)
    before = mb.scatter_add.launches
    got = mb.scatter_add(torch.from_numpy(idx).to(cuda_device),
                         torch.from_numpy(upd).to(cuda_device), rows)
    torch.cuda.synchronize()
    assert mb.scatter_add.launches == before + 1
    ref = mb.plain_scatter_add(torch.from_numpy(idx), torch.from_numpy(upd), rows)
    mag = mb.plain_scatter_add(torch.from_numpy(idx), torch.from_numpy(np.abs(upd)), rows)
    assert got.shape == ref.shape == (rows, 2) and got.dtype == torch.float32
    err = float((got.cpu().double() - ref.double()).abs().max())
    tol = 1e-6 * float(mag.max()) + 1e-6
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("m,rows,kind", _PROBE_EDGES)
def test_vector_gather_edges_match_plain(cuda_device, m, rows, kind):
    """P1b (a block per 8,192-index chunk, its warps in P1a unroll 8's
    coalesced steps) at the edge cases of the P1a test, and on a ragged
    3 x 8,192 + 1,001 indices: equal to table[idx] on the CPU to the bit;
    one launch counted."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    for n in (m, 3 * 8192 + 1001):
        idx, _ = _onehot_inputs(n, rows, kind, seed=n + rows)
        table = np.random.RandomState(rows).randn(rows, 2).astype(np.float32)
        before = mb.vector_gather.launches
        got = mb.vector_gather(torch.from_numpy(idx).to(cuda_device),
                               torch.from_numpy(table).to(cuda_device))
        torch.cuda.synchronize()
        assert mb.vector_gather.launches == before + 1
        ref = mb.plain_gather(torch.from_numpy(idx), torch.from_numpy(table))
        assert got.shape == ref.shape == (n, 2)
        assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("kind", ["one_chunk", "one_row", "ends", "one_bank_group",
                                  "five_chunks", "2^20"])
def test_chunk_row_sum_edges(cuda_device, kind):
    """P2a / P2b (the table in shared-memory slabs, each chunk's indices
    prefetched into L2 once) and P2c (only the rows its output keeps) at
    one chunk, every index on one row, the first and last rows only, rows of
    one 4-bank group (the most bank conflicts), five chunks, and 2^20 random
    indices: P2a / P2b equal to the bit to the emulated order
    (chunk_row_sum_emulated) and within 1e-6 x the summed magnitude of the
    float64 sum on random rows (P2_F32_SUM_BOUND on repeated ones), P2c
    equal to numpy to the bit; one launch each."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    rs = np.random.RandomState(len(kind))
    table = rs.randn(mb.P2_T, 128).astype(np.float32)
    if kind == "2^20":
        idx = rs.randint(0, mb.P2_T, 1 << 20).astype(np.int32)
    else:
        idx = mb.p2_edge_indices(kind, rs)
    before = dict(mb.chunk_row_sum.launches)
    errs = mb.check_p2(idx, table, cuda_device, f" ({kind})")
    torch.cuda.synchronize()
    assert mb.chunk_row_sum.launches == {k: v + 1 for k, v in before.items()}
    assert errs["P2c_rows_to_scratch"] == 0.0
    if kind in ("one_chunk", "one_bank_group", "five_chunks", "2^20"):  # random rows
        x = {"p2_idx": idx, "p2_table": table}
        for variant, name in enumerate(mb.P2_NAMES[:2]):
            got = mb.chunk_row_sum(torch.from_numpy(idx).to(cuda_device),
                                   torch.from_numpy(table).to(cuda_device), variant)
            mb.check(name, got.cpu().numpy(), x, 1e-6)


def test_probe_redesigns_repeat(cuda_device):
    """P1g, P1e, P1b and P2 a / b / c called twice on the same inputs: P1e,
    P1b and P2 equal to the bit both times (P2a / P2b sum in a fixed order),
    P1g within its tolerance both times (atomics reorder its sums), two
    launches each."""
    from instant_nsr_pl_tpu_torch.tools import microbench_gather as mb

    idx, upd = _onehot_inputs(1 << 18, 1 << 19, "uniform", seed=5)
    rs = np.random.RandomState(6)
    sidx = torch.from_numpy(rs.randint(0, 512, (2048, 128)).astype(np.int32)).to(cuda_device)
    table = torch.from_numpy(rs.randn(512, 128).astype(np.float32)).to(cuda_device)
    di, du = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(upd).to(cuda_device)
    vtable = torch.from_numpy(rs.randn(1 << 19, 2).astype(np.float32)).to(cuda_device)
    pidx = torch.from_numpy(rs.randint(0, mb.P2_T, 1 << 18).astype(np.int32)).to(cuda_device)
    ptable = torch.from_numpy(rs.randn(mb.P2_T, 128).astype(np.float32)).to(cuda_device)
    g0, s0, v0 = mb.onehot_grad.launches, mb.sublane_gather.launches, mb.vector_gather.launches
    p0 = dict(mb.chunk_row_sum.launches)

    def calls():
        return (mb.onehot_grad(di, du), mb.sublane_gather(sidx, table),
                mb.vector_gather(di, vtable), *(mb.chunk_row_sum(pidx, ptable, v)
                                                for v in range(3)))

    first, second = calls(), calls()
    torch.cuda.synchronize()
    assert (mb.onehot_grad.launches, mb.sublane_gather.launches,
            mb.vector_gather.launches) == (g0 + 2, s0 + 2, v0 + 2)
    assert mb.chunk_row_sum.launches == {k: v + 2 for k, v in p0.items()}
    for got in (first[0], second[0]):
        _onehot_check(got, idx, upd, 1 << 19)
    ref = mb.plain_sublane_gather(sidx.cpu(), table.cpu())
    assert torch.equal(first[1].cpu(), ref) and torch.equal(second[1].cpu(), ref)
    assert torch.equal(first[2].cpu(), mb.plain_gather(di.cpu(), vtable.cpu()))
    for a, b in zip(first[2:], second[2:]):
        assert torch.equal(a.cpu(), b.cpu())


# -- the fused backward kernels K2 (and K14, cp_big) and K4 at every
# instantiation: sizes around the 64-sample tile, no samples, every sample at
# one point, ray-ordered against shuffled samples, and repeated calls

# (label, C, resolutions, F, width, hidden layers, stacked)
_CP_SHAPES = [
    ("cp", 64, (128, 2048), 16, 64, 1, False),
    ("cp_big", 128, (64, 512, 4096), 16, 64, 1, False),
    ("small1", 16, (24, 64), 8, 32, 1, False),
    ("small2", 16, (24, 64), 8, 32, 2, False),
    ("stacked", 64, (129, 2049), 16, 64, 1, True),
    ("stacked_small1", 16, (17, 65), 8, 32, 1, True),
    ("stacked_small2", 16, (17, 65), 8, 32, 2, True),
]
# (label, feature columns, width): SH degree 4, two hidden layers, D = 3
_SH_SHAPES = [("bench", 16, 64), ("small", 16, 32), ("extras", 19, 32)]
_SIZES = [1, 15, 127, 129, 515, 4096]


def _cp_backward_case(shape, x, gen, device):
    """K1/K13 training-mode residuals at positions x, and (launch, plain,
    args, counter) of the matching backward."""
    _, c, res, f, w, nh, stacked = shape
    cp_spec = CPSpec(c, res, f)
    mlp_spec = MLPSpec(dim_in=f * len(res), dim_out=16, n_neurons=w, n_hidden_layers=nh)
    cp_params = cp_init(gen, cp_spec, device)
    layers = _biased(mlp_init(gen, mlp_spec), gen, device)
    dout = torch.randn((x.shape[0], 16), generator=gen).to(device)
    if stacked:
        ops = t_cp_mlp.cp_mlp_stacked_operands(cp_params, layers, cp_spec, mlp_spec)
        _, vsave, hsave = t_cp_mlp.cp_mlp_stacked_launch(ops, x, cp_spec, mlp_spec, train=True)
        fns = (t_cp_mlp.cp_mlp_stacked_backward_launch, t_cp_mlp.cp_mlp_stacked_backward_plain,
               t_cp_mlp.cp_mlp_stacked_backward)
    else:
        ops = t_cp_mlp.cp_mlp_operands(cp_params, layers, cp_spec, mlp_spec)
        _, vsave, hsave = t_cp_mlp.cp_mlp_launch(ops, x, cp_spec, mlp_spec, train=True)
        fns = (t_cp_mlp.cp_mlp_backward_launch, t_cp_mlp.cp_mlp_backward_plain,
               t_cp_mlp.cp_mlp_backward)
    return (*fns, [x, vsave, hsave, dout, ops[1], ops[2], cp_spec, mlp_spec])


def _sh_backward_case(shape, feats, dirs, gen, device):
    _, n_feat, w = shape
    spec = MLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=w, n_hidden_layers=2)
    layers = _biased(mlp_init(gen, spec), gen, device)
    ops = t_sh_mlp.pack_sh_mlp(layers, spec, 4, 16, n_feat)
    _, hsave = t_sh_mlp.sh_mlp_launch(ops, feats, dirs, spec, 4, train=True)
    dout = torch.randn((feats.shape[0], 3), generator=gen).to(device)
    ws, _, fpad = ops
    return [feats, dirs, hsave, dout, ws, fpad, spec, 4]


def _flat(grads):
    return [*grads[0], *grads[1:]] if isinstance(grads[0], list) else list(grads)


def _sh_inputs(gen, n, n_feat, device):
    feats = torch.randn((n, n_feat), generator=gen).to(device)
    dirs = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen), dim=-1)
    return feats, dirs.to(device)


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("shape", _CP_SHAPES, ids=[s[0] for s in _CP_SHAPES])
def test_cp_backward_sizes_match_plain(cuda_device, shape, n):
    """K2 / K14 at every instantiation and at sizes around the 64-sample tile
    (one sample, part of a tile, one tile and a few more): every gradient
    within 2.5e-2 of the largest plain value, one launch counted."""
    gen = torch.Generator().manual_seed(100 + n)
    x = (torch.rand((n, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    launch, plain, op, args = _cp_backward_case(shape, x, gen, cuda_device)
    before = op.launches
    got = launch(*args)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    for a, b in zip(_flat(got), _flat(plain(*args))):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


@pytest.mark.parametrize("n", _SIZES)
@pytest.mark.parametrize("shape", _SH_SHAPES, ids=[s[0] for s in _SH_SHAPES])
def test_sh_backward_sizes_match_plain(cuda_device, shape, n):
    """K4 at every instantiation and at sizes around the 64-sample tile: dW,
    db and d features within 2.5e-2 of the largest plain value."""
    gen = torch.Generator().manual_seed(200 + n)
    args = _sh_backward_case(shape, *_sh_inputs(gen, n, shape[1], cuda_device), gen, cuda_device)
    before = t_sh_mlp.sh_mlp_backward.launches
    got = t_sh_mlp.sh_mlp_backward_launch(*args)
    torch.cuda.synchronize()
    assert t_sh_mlp.sh_mlp_backward.launches == before + 1
    for a, b in zip(got, t_sh_mlp.sh_mlp_backward_plain(*args)):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)


@pytest.mark.parametrize("shape", _CP_SHAPES + _SH_SHAPES,
                         ids=[s[0] for s in _CP_SHAPES] + ["sh_" + s[0] for s in _SH_SHAPES])
def test_fused_backward_no_samples(cuda_device, shape):
    """N = 0: zero gradients of the right shapes, and no launch."""
    gen = torch.Generator().manual_seed(5)
    if len(shape) == 7:
        launch, plain, op, args = _cp_backward_case(shape, torch.zeros((0, 3), device=cuda_device),
                                                    gen, cuda_device)
    else:
        op, plain, launch = (t_sh_mlp.sh_mlp_backward, t_sh_mlp.sh_mlp_backward_plain,
                             t_sh_mlp.sh_mlp_backward_launch)
        args = _sh_backward_case(shape, *_sh_inputs(gen, 0, shape[1], cuda_device), gen,
                                 cuda_device)
    before = op.launches
    got = launch(*args)
    torch.cuda.synchronize()
    assert op.launches == before
    for a, b in zip(_flat(got), _flat(plain(*args))):
        assert a.shape == b.shape and not bool(a.any())


@pytest.mark.parametrize("shape", _CP_SHAPES + _SH_SHAPES,
                         ids=[s[0] for s in _CP_SHAPES] + ["sh_" + s[0] for s in _SH_SHAPES])
def test_fused_backward_one_point(cuda_device, shape):
    """Every one of 4,096 samples at the same position (and direction): the
    worst case for the row merge and the atomics; gradients within 2.5e-2."""
    gen = torch.Generator().manual_seed(6)
    n = 4096
    if len(shape) == 7:
        x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(n, 1).to(cuda_device)
        launch, plain, _, args = _cp_backward_case(shape, x, gen, cuda_device)
    else:
        feats, dirs = _sh_inputs(gen, 1, shape[1], cuda_device)
        args = _sh_backward_case(shape, feats.repeat(n, 1), dirs.repeat(n, 1), gen, cuda_device)
        launch, plain = t_sh_mlp.sh_mlp_backward_launch, t_sh_mlp.sh_mlp_backward_plain
    got = launch(*args)
    torch.cuda.synchronize()
    for a, b in zip(_flat(got), _flat(plain(*args))):
        _close(a, b, rel=2.5e-2)


@pytest.mark.parametrize("shape", _CP_SHAPES + _SH_SHAPES,
                         ids=[s[0] for s in _CP_SHAPES] + ["sh_" + s[0] for s in _SH_SHAPES])
def test_fused_backward_order_and_repeat(cuda_device, shape):
    """Ray-ordered samples (8 rays of 512) and a shuffled copy of the same
    samples: every gradient of the two within 2.5e-2 of the largest plain
    value, the plain version's within the same limit, K4's d features equal
    after the permutation; and a repeated call gives bit-equal dW, db and
    d basis (their second-pass sum runs in block order)."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(8)
    n = 4096
    perm = torch.randperm(n, generator=gen).to(cuda_device)
    x = positions(gen, "ray", n).to(cuda_device)
    if len(shape) == 7:
        launch, plain, _, args = _cp_backward_case(shape, x, gen, cuda_device)
        shuffled = list(args)
        shuffled[0] = x[perm].contiguous()
        shuffled[1] = args[1][:, :, perm].contiguous()  # vsave (3, S*C, N)
        shuffled[2] = args[2][:, :, perm].contiguous()  # hsave (NH, W, N)
        shuffled[3] = args[3][perm].contiguous()
        exact = slice(1, None)  # d basis, dW, db (the line tables come from atomics)
    else:
        feats, _ = _sh_inputs(gen, n, shape[1], cuda_device)
        dirs = torch.nn.functional.normalize(x - 0.5, dim=-1)
        args = _sh_backward_case(shape, feats, dirs, gen, cuda_device)
        launch, plain = t_sh_mlp.sh_mlp_backward_launch, t_sh_mlp.sh_mlp_backward_plain
        shuffled = list(args)
        shuffled[0], shuffled[1] = feats[perm].contiguous(), dirs[perm].contiguous()
        shuffled[2] = args[2][:, :, perm].contiguous()
        shuffled[3] = args[3][perm].contiguous()
        exact = slice(0, 2)  # dW, db
    got = launch(*args)
    again = launch(*args)
    got_shuffled = launch(*shuffled)
    torch.cuda.synchronize()
    ref = plain(*args)
    if len(shape) == 7:
        for a, b in zip(got[exact], again[exact]):
            assert torch.equal(a, b)
    else:
        for a, b in zip(got[exact], again[exact]):
            assert torch.equal(a, b)
        assert torch.equal(got_shuffled[2], got[2][perm])
    ref_shuffled = _flat(ref)
    if len(shape) != 7:  # K4's d features follow the samples' order
        ref_shuffled[2] = ref_shuffled[2][perm]
    for a, b, r, rs in zip(_flat(got), _flat(got_shuffled), _flat(ref), ref_shuffled):
        _close(a, r, rel=2.5e-2)
        _close(b, rs, rel=2.5e-2)


# ---------------------------------------------------------------------------
# K10 / K12 / cp_big K10 (csrc/cp_jac_basis_bwd.cu) and HG2 (csrc/hashgrid_bwd.cu)
# ---------------------------------------------------------------------------

# (label, C, F, scales, R): every instantiation of the K10 / K12 template
_JAC_SHAPES = [
    ("jac", 64, 16, 1, 2048),
    ("jac_coarse", 64, 16, 1, 128),
    ("jac_cp_big", 128, 16, 1, 4096),
    ("jac_small", 16, 8, 1, 64),
    ("jac_stacked", 64, 16, 2, 2049),
    ("jac_stacked_small", 16, 8, 2, 65),
]
_JAC_IDS = [s[0] for s in _JAC_SHAPES]


def _jac_backward_case(shape, x, gen, device):
    """K9 / K11 training-mode residuals at positions x (n, 3), and (launch,
    plain, counter, args) of the matching backward."""
    _, c, f, s_count, r = shape
    u3 = x.T.contiguous()
    n = u3.shape[1]
    if s_count == 1:
        lines = t_cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
        basis = (torch.randn((c, f), generator=gen) / c**0.5).to(torch.bfloat16)
        lines, basis = lines.to(device), basis.to(device)
        _, _, vsave, gdsave = t_cpp.cp_product_jac_basis_launch(lines, basis, u3, r, train=True)
        fns = (t_cpp.cp_product_jac_basis_backward_launch,
               t_cpp.cp_product_jac_basis_backward_plain, t_cpp.cp_product_jac_basis_backward)
    else:
        spec = CPSpec(c, ((r - 1) // 16 + 1, r), f)
        params = cp_init(gen, spec, device)
        lines, basis = t_cps.stack_lines_fine(params, spec), t_cps.basis_stack(params, spec)
        _, _, vsave, gdsave = t_cps.cp_jac_basis_stacked_launch(lines, basis, u3, r, train=True)
        fns = (t_cps.cp_jac_basis_stacked_backward_launch,
               t_cps.cp_jac_basis_stacked_backward_plain, t_cps.cp_jac_basis_stacked_backward)
    denc = torch.randn((s_count * f, n), generator=gen).to(device)
    djac = torch.randn((3, s_count * f, n), generator=gen).to(device)
    return (*fns, [u3, vsave, gdsave, denc, djac, basis, r])


def _check_jac(launch, plain, args):
    got = launch(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _close(a, b, rel=2.5e-2)
    return got, ref


@pytest.mark.parametrize("n", [1, 15, 63, 65, 127, 129, 515, 4096])
@pytest.mark.parametrize("shape", _JAC_SHAPES, ids=_JAC_IDS)
def test_jac_backward_sizes_match_plain(cuda_device, shape, n):
    """K10 / K12 at every instantiation and at sizes around the 64-sample
    tile, on positions in [-0.05, 1.05]: d lines, d u and d basis within
    2.5e-2 of the largest plain value, one launch counted."""
    gen = torch.Generator().manual_seed(300 + n)
    x = (torch.rand((n, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    launch, plain, op, args = _jac_backward_case(shape, x, gen, cuda_device)
    before = op.launches
    _check_jac(launch, plain, args)
    assert op.launches == before + 1


@pytest.mark.parametrize("shape", _JAC_SHAPES, ids=_JAC_IDS)
def test_jac_backward_no_samples(cuda_device, shape):
    """N = 0: zero gradients of the right shapes, an empty d u, no launch."""
    gen = torch.Generator().manual_seed(9)
    launch, plain, op, args = _jac_backward_case(shape, torch.zeros((0, 3), device=cuda_device),
                                                 gen, cuda_device)
    before = op.launches
    got = launch(*args)
    torch.cuda.synchronize()
    assert op.launches == before
    for a, b in zip(got, plain(*args)):
        assert a.shape == b.shape and not bool(a.any())


@pytest.mark.parametrize("shape", _JAC_SHAPES, ids=_JAC_IDS)
def test_jac_backward_one_point(cuda_device, shape):
    """Every one of 4,096 samples at the same position: each tile's scatter
    merges all its samples into two rows per axis; gradients within 2.5e-2."""
    gen = torch.Generator().manual_seed(10)
    x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(4096, 1).to(cuda_device)
    launch, plain, _, args = _jac_backward_case(shape, x, gen, cuda_device)
    _check_jac(launch, plain, args)


@pytest.mark.parametrize("shape", _JAC_SHAPES, ids=_JAC_IDS)
def test_jac_backward_edges(cuda_device, shape):
    """u exactly 0 and exactly 1 on each axis in turn (the last tent row,
    d clip(u)/du = 0.5) and out of range: gradients within 2.5e-2, d u zero
    outside [0, 1]."""
    gen = torch.Generator().manual_seed(12)
    n = 515
    x = torch.rand((n, 3), generator=gen)
    for a in range(3):
        x[a * 100:a * 100 + 50, a] = 0.0
        x[a * 100 + 50:a * 100 + 100, a] = 1.0
    x[300:320] = -0.02
    x[320:340] = 1.03
    x = x.to(cuda_device)
    launch, plain, _, args = _jac_backward_case(shape, x, gen, cuda_device)
    got, _ = _check_jac(launch, plain, args)
    outside = (args[0] < 0) | (args[0] > 1)
    assert bool(outside.any()) and bool((got[1][outside] == 0).all())


@pytest.mark.parametrize("shape", _JAC_SHAPES, ids=_JAC_IDS)
def test_jac_backward_order_and_repeat(cuda_device, shape):
    """Ray-ordered samples (8 rays of 512) and a shuffled copy of the same
    samples: every gradient of both within 2.5e-2 of the largest plain value,
    d u of the shuffled call equal to the permuted d u (each sample's sum runs
    in a fixed order), and a repeated call gives a bit-equal d basis (its
    second-pass sum runs in block order)."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(13)
    n = 4096
    perm = torch.randperm(n, generator=gen).to(cuda_device)
    x = positions(gen, "ray", n).to(cuda_device)
    launch, plain, _, args = _jac_backward_case(shape, x, gen, cuda_device)
    shuffled = list(args)
    shuffled[0] = args[0][:, perm].contiguous()
    shuffled[1] = args[1][:, :, perm].contiguous()
    shuffled[2] = args[2][:, :, perm].contiguous()
    shuffled[3] = args[3][:, perm].contiguous()
    shuffled[4] = args[4][:, :, perm].contiguous()
    got = launch(*args)
    again = launch(*args)
    got_shuffled = launch(*shuffled)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert torch.equal(got[2], again[2])
    assert torch.equal(got_shuffled[1], got[1][:, perm])
    for a, b, r in zip(got, got_shuffled, ref):
        _close(a, r, rel=2.5e-2)
    _close(got_shuffled[0], ref[0], rel=2.5e-2)
    _close(got_shuffled[2], ref[2], rel=2.5e-2)


def _hash_spec(name):
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    if name == "bench":  # bench.py --encoding hash
        return _bench_hash()
    return HashGridSpec(n_levels=12, log2_hashmap_size=18)  # configs/nerf-synthetic.yaml


def _hash_table_grad_f64(spec, x, ct, mask):
    """The table gradient as a float64 sum of the float32 corner updates
    ``w_c * (ct_l * mask_l)`` that the kernel and the plain version add."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    f = spec.n_features_per_level
    out = torch.zeros((spec.total_params, f), dtype=torch.float64, device=x.device)
    for lv in range(spec.n_levels):
        idx, w = hg.level_corner_indices(spec, x.T.contiguous(), lv)  # (8, N)
        g = ct[:, lv * f:(lv + 1) * f] * (mask[lv] if mask is not None else 1.0)
        upd = w[:, :, None] * g[None]  # (8, N, F) float32
        out.index_add_(0, idx.reshape(-1), upd.reshape(-1, f).double())
    return out


def _check_hash(spec, table, x, ct, mask, exact=False):
    """HG2 with and without d x against its plain version: the table gradient
    within 1e-5 x max|plain| per level (with ``exact``, against the float64
    sum of the same float32 updates instead: where thousands of updates land
    on one row, the plain version's own sequential float32 sum strays by as
    much), d x within 1e-4 x max|plain|."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    dt, dx = hg.hashgrid_backward_launch(table, x, ct, spec, mask, with_dx=True)
    dt_only, no_dx = hg.hashgrid_backward_launch(table, x, ct, spec, mask)
    torch.cuda.synchronize()
    assert no_dx is None
    rt, rx = hg.hashgrid_backward_plain(table, x, ct, spec, mask, with_dx=True)
    if exact:
        rt = _hash_table_grad_f64(spec, x, ct, mask)
    for lv in range(spec.n_levels):
        sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
        _close(dt[sl].to(rt.dtype), rt[sl], rel=1e-5)
        _close(dt_only[sl].to(rt.dtype), rt[sl], rel=1e-5)
    _close(dx, rx, rel=1e-4)
    return dt, dx


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["bench", "nerf-synthetic"])
def test_hash_backward_order_and_repeat(cuda_device, name, masked):
    """Ray-ordered samples (8 rays of 512: the coarse levels' rows repeat
    within a warp, so the merge runs) and a shuffled copy: both within the
    limits, d x of the shuffled call equal to the permuted d x."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    spec = _hash_spec(name)
    gen = torch.Generator().manual_seed(14)
    n = 4096
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(cuda_device)
    x = positions(gen, "ray", n).to(cuda_device)
    ct = torch.randn((n, spec.n_output_dims), generator=gen).to(cuda_device)
    mask = torch.linspace(1.0, 0.0, spec.n_levels).to(cuda_device) if masked else None
    perm = torch.randperm(n, generator=gen).to(cuda_device)
    _, dx = _check_hash(spec, table, x, ct, mask)
    _, dx_shuffled = _check_hash(spec, table, x[perm].contiguous(), ct[perm].contiguous(), mask)
    assert torch.equal(dx_shuffled, dx[perm])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["bench", "nerf-synthetic"])
def test_hash_backward_one_point(cuda_device, name, masked):
    """Every one of 4,096 samples at the same position: each warp sums its 32
    samples, each block its warps' sums in warp order, into one update per
    level and corner (32 float32 atomics a row); the table gradient within
    1e-5 x max|exact| of the float64 sum of the same updates, d x within its
    limit."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = _hash_spec(name)
    gen = torch.Generator().manual_seed(15)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(cuda_device)
    x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(4096, 1).to(cuda_device)
    ct = torch.randn((4096, spec.n_output_dims), generator=gen).to(cuda_device)
    mask = torch.linspace(1.0, 0.0, spec.n_levels).to(cuda_device) if masked else None
    _check_hash(spec, table, x, ct, mask, exact=True)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["bench", "nerf-synthetic"])
def test_hash_backward_no_samples(cuda_device, name, masked):
    """N = 0: a zero table gradient, an empty d x, no launch."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = _hash_spec(name)
    table = (hg.hashgrid_init(torch.Generator().manual_seed(16), spec) * 1e4).to(cuda_device)
    x = torch.zeros((0, 3), device=cuda_device)
    ct = torch.zeros((0, spec.n_output_dims), device=cuda_device)
    mask = torch.linspace(1.0, 0.0, spec.n_levels).to(cuda_device) if masked else None
    before = hg.hashgrid_backward.launches
    for with_dx in (False, True):
        dt, dx = hg.hashgrid_backward_launch(table, x, ct, spec, mask, with_dx=with_dx)
        torch.cuda.synchronize()
        assert dt.shape == table.shape and not bool(dt.any())
        assert dx is None if not with_dx else tuple(dx.shape) == (0, 3)
    assert hg.hashgrid_backward.launches == before


# HG5-HG8 (csrc/hashgrid_lattice_{fwd,bwd}.cu: the tap-dedup levels' 27-point
# lattices) at configs/nerf-blender.yaml's and neus-blender.yaml's dedup specs;
# with group 6 (num_samples_per_ray: 768 makes the march's stride 6) every
# dedup level's g is 6, which divides no power of two
def _lattice_spec(name, group=8):
    import dataclasses

    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import BLENDER_DEDUP_STEP

    base = (_bench_hash() if name == "nerf-blender" else HashGridSpec(
        base_resolution=32, per_level_scale=1.3195079107728942))
    spec = dataclasses.replace(base, dedup_group=group, dedup_step=BLENDER_DEDUP_STEP)
    if group == 6:
        assert spec.dedup_group_sizes[:6] == (6,) * 5 + (0,)
    else:
        assert spec.dedup_group_sizes[:7] == ((8,) * 5 + (4, 4) if name == "nerf-blender"
                                              else (8,) * 4 + (4, 4, 0))
    return spec


def _lattice_case(name, n, seed, masked, device, one_point=False, group=8):
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import march_blocks

    spec = _lattice_spec(name, group)
    gen = torch.Generator().manual_seed(seed)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(device)
    x = (torch.tensor([[0.3, 0.71, 0.52]]).repeat(n, 1) if one_point
         else march_blocks(gen, n, per_ray=512 if group == 8 else 768)).to(device)
    assert hg.lattice_cover_ok(spec, x)
    ct_f = torch.randn((n, spec.n_output_dims), generator=gen).to(device)
    ct_j = torch.randn((3, n, spec.n_output_dims), generator=gen).to(device)
    mask = (torch.tensor([1.0, 0.5, 1.0, 0.0, 1.0, 1.0, 0.5] + [1.0, 0.5] * 4 + [0.0]).to(device)
            if masked else None)
    return spec, table, x, ct_f, ct_j, mask


def _lattice_columns(spec):
    n_lat = sum(1 for g in spec.dedup_group_sizes if g)
    return slice(0, n_lat * spec.n_features_per_level)


def _check_lattice_grads(spec, table, x, ct_f, ct_j, mask, jac):
    """HG6 (``jac`` False) or HG8 alone, with and without d x, and through
    HG2 + HG6 / HG4 + HG8: the table gradient within 1e-5 x max|exact| per
    level of the plain version's float64 sum, d x within 1e-4 x max|plain|."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    if jac:
        cts = (ct_f, ct_j)
        alone, full, plain = (hg.hashgrid_lattice_jac_backward_launch,
                              hg.hashgrid_jac_backward_launch, hg.hashgrid_jac_backward_plain)
    else:
        cts = (ct_f,)
        alone, full, plain = (hg.hashgrid_lattice_backward_launch, hg.hashgrid_backward_launch,
                              hg.hashgrid_backward_plain)
    for fn, lattice_only in ((alone, True), (full, False)):
        dt, dx = fn(table, x, *cts, spec, mask, with_dx=True)
        dt_only, no_dx = fn(table, x, *cts, spec, mask)
        torch.cuda.synchronize()
        assert no_dx is None
        rt, rx = plain(table, x, *cts, spec, mask, with_dx=True, accumulate=torch.float64,
                       lattice_only=lattice_only)
        for lv in range(spec.n_levels):
            sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
            _close(dt[sl].double(), rt[sl], rel=1e-5)
            _close(dt_only[sl].double(), rt[sl], rel=1e-5)
        _close(dx, rx, rel=1e-4)


@pytest.mark.parametrize("group", [8, 6])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["nerf-blender", "neus-blender"])
def test_hash_lattice_kernels_match_plain(cuda_device, name, masked, group):
    """HG5 and HG7 on march blocks (128 rays of 512 uniform steps, or 85 of
    768 at group 6): the dedup levels' columns within 1e-5 x max|plain| of
    their plain versions (HG7's features equal to HG5's to the bit), and
    through HG1 + HG5 / HG3 + HG7 the whole encode; HG6 and HG8 within the
    hash gradient limits (``_check_lattice_grads``); each wrapper's launch
    counted once a call; a spec without dedup levels launches none of
    them."""
    import dataclasses

    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    n = 1 << 16 if group == 8 else 768 * 85
    spec, table, x, ct_f, ct_j, mask = _lattice_case(name, n, 31, masked, cuda_device,
                                                     group=group)
    cols = _lattice_columns(spec)
    counters = (hg.hashgrid_lattice_forward, hg.hashgrid_lattice_jac_forward,
                hg.hashgrid_lattice_backward, hg.hashgrid_lattice_jac_backward)
    before = [c.launches for c in counters]
    out = hg.hashgrid_lattice_forward_launch(table, x, spec, mask)
    feat, jac = hg.hashgrid_lattice_jac_forward_launch(table, x, spec, mask)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    ref = hg.hashgrid_forward_plain(table, x, spec, mask, lattice_only=True)
    ref_f, ref_j = hg.hashgrid_jac_forward_plain(table, x, spec, mask, lattice_only=True)
    _close(out[:, cols], ref[:, cols], rel=1e-5)
    assert torch.equal(feat, out)
    _close(jac[..., cols], ref_j[..., cols], rel=1e-5)
    full = hg.hashgrid_forward_launch(table, x, spec, mask)
    full_f, full_j = hg.hashgrid_jac_forward_launch(table, x, spec, mask)
    torch.cuda.synchronize()
    _close(full, hg.hashgrid_forward_plain(table, x, spec, mask), rel=1e-5)
    assert torch.equal(full_f, full)
    _close(full_j, hg.hashgrid_jac_forward_plain(table, x, spec, mask)[1], rel=1e-5)
    _check_lattice_grads(spec, table, x, ct_f, None, mask, jac=False)
    _check_lattice_grads(spec, table, x, ct_f, ct_j, mask, jac=True)
    plain_spec = dataclasses.replace(spec, dedup_group=0)
    before = [c.launches for c in counters]
    hg.hashgrid_forward_launch(table, x, plain_spec, mask)
    hg.hashgrid_jac_backward_launch(table, x, ct_f, ct_j, plain_spec, mask, with_dx=True)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("jac", [False, True])
@pytest.mark.parametrize("name", ["nerf-blender", "neus-blender"])
def test_hash_lattice_table_grad(cuda_device, name, jac):
    """HG6 / HG8's table gradient where the atomics' order matters most:
    32,768 samples on one point (every block's lattice on the same rows:
    4,096 updates a row) and 65,536 march-block samples, each within 1e-5 x
    max|exact| per level of the float64 sum (the dense dedup levels' rows
    summed in float64 by the kernel); d x within 1e-4."""
    for n, one_point in ((1 << 15, True), (1 << 16, False)):
        spec, table, x, ct_f, ct_j, mask = _lattice_case(name, n, 32, False, cuda_device,
                                                         one_point)
        _check_lattice_grads(spec, table, x, ct_f, ct_j if jac else None, mask, jac)


def test_hash_lattice_no_samples(cuda_device):
    """N = 0: zero gradients, empty outputs, no launch."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = _lattice_spec("nerf-blender")
    table = (hg.hashgrid_init(torch.Generator().manual_seed(33), spec) * 1e4).to(cuda_device)
    x = torch.zeros((0, 3), device=cuda_device)
    ct = torch.zeros((0, spec.n_output_dims), device=cuda_device)
    counters = (hg.hashgrid_lattice_forward, hg.hashgrid_lattice_jac_forward,
                hg.hashgrid_lattice_backward, hg.hashgrid_lattice_jac_backward)
    before = [c.launches for c in counters]
    assert hg.hashgrid_forward_launch(table, x, spec).shape == (0, spec.n_output_dims)
    dt, dx = hg.hashgrid_backward_launch(table, x, ct, spec, with_dx=True)
    dt2, _ = hg.hashgrid_jac_backward_launch(table, x, ct, ct[None].expand(3, 0, -1), spec)
    torch.cuda.synchronize()
    assert not bool(dt.any()) and not bool(dt2.any()) and tuple(dx.shape) == (0, 3)
    assert [c.launches for c in counters] == before


# HG3 / HG4 (csrc/hashgrid_jac_{fwd,bwd}.cu: the hash encoding with its
# position Jacobian, and its backward from both cotangents) at
# configs/neus-synthetic.yaml's grid
def _neus_hash():
    from instant_nsr_pl_tpu_torch.ops.hashgrid import HashGridSpec

    return HashGridSpec(n_levels=12, n_features_per_level=2, log2_hashmap_size=18,
                        base_resolution=32, per_level_scale=1.3195079107728942)


def _jac_case(x, seed, masked, device):
    """The table (values of order 1), both cotangents and the mask (a
    ProgressiveBandHashGrid's 5 levels of 12) for positions x."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = _neus_hash()
    gen = torch.Generator().manual_seed(seed)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(device)
    n = x.shape[0]
    ct_f = torch.randn((n, spec.n_output_dims), generator=gen).to(device)
    ct_j = torch.randn((3, n, spec.n_output_dims), generator=gen).to(device)
    mask = (torch.arange(12) < 5).float().to(device) if masked else None
    return spec, table, ct_f, ct_j, mask


def _check_hash_jac(spec, table, x, ct_f, ct_j, mask):
    """HG4 with and without d x: the table gradient within 1e-5 x max|exact|
    per level of the float64 sum of the plain version's float32 updates
    (atomics sum in another order each run), d x within 1e-4 x max|plain|."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    dt, dx = hg.hashgrid_jac_backward_launch(table, x, ct_f, ct_j, spec, mask, with_dx=True)
    dt_only, no_dx = hg.hashgrid_jac_backward_launch(table, x, ct_f, ct_j, spec, mask)
    torch.cuda.synchronize()
    assert no_dx is None
    rt, rx = hg.hashgrid_jac_backward_plain(table, x, ct_f, ct_j, spec, mask, with_dx=True,
                                            accumulate=torch.float64)
    for lv in range(spec.n_levels):
        sl = slice(spec.level_offsets[lv], spec.level_offsets[lv] + spec.level_sizes[lv])
        _close(dt[sl].double(), rt[sl], rel=1e-5)
        _close(dt_only[sl].double(), rt[sl], rel=1e-5)
    _close(dx, rx, rel=1e-4)
    return dt, dx


@pytest.mark.parametrize("masked", [False, True])
def test_hash_jac_kernels_match_plain(cuda_device, masked):
    """HG3 on a ragged N with exact 0 / 1 coordinates: its features equal to
    HG1's (and the plain version's) to the bit, its Jacobian within 2e-2 x
    max|plain| of the plain version; HG4 within the HG2 limits
    (``_check_hash_jac``); each launch counted once; through the autograd
    op the table gets HG4's gradient, and x one only when it requires
    grad."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    gen = torch.Generator().manual_seed(17)
    x = torch.rand((20011, 3), generator=gen)
    x[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.0, 1.0]])
    x = x.to(cuda_device)
    spec, table, ct_f, ct_j, mask = _jac_case(x, 18, masked, cuda_device)
    before = hg.hashgrid_jac_forward.launches
    feat, jac = hg.hashgrid_jac_forward(table, x, spec, mask)
    torch.cuda.synchronize()
    assert hg.hashgrid_jac_forward.launches == before + 1
    assert feat.shape == (20011, 24) and jac.shape == (3, 20011, 24)
    assert torch.equal(feat, hg.hashgrid_forward_launch(table, x, spec, mask))
    ref_f, ref_j = hg.hashgrid_jac_forward_plain(table, x, spec, mask)
    assert torch.equal(feat, ref_f)
    _close(jac, ref_j, rel=2e-2)
    before = hg.hashgrid_jac_backward.launches
    _check_hash_jac(spec, table, x, ct_f, ct_j, mask)
    assert hg.hashgrid_jac_backward.launches == before + 2
    t = table.clone().requires_grad_(True)
    f2, j2 = hg.hashgrid_encode_with_jac(t, x, spec, mask)
    ((f2 * ct_f).sum() + (j2 * ct_j).sum()).backward()
    rt, _ = hg.hashgrid_jac_backward_plain(table, x, ct_f, ct_j, spec, mask,
                                           accumulate=torch.float64)
    _close(t.grad.double(), rt, rel=1e-5)
    a = x.clone().requires_grad_(True)
    f3, j3 = hg.hashgrid_encode_with_jac(table, a, spec, mask)
    ((f3 * ct_f).sum() + (j3 * ct_j).sum()).backward()
    _, rx = hg.hashgrid_jac_backward_plain(table, x, ct_f, ct_j, spec, mask, with_dx=True)
    _close(a.grad, rx, rel=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_hash_jac_backward_order_and_repeat(cuda_device, masked):
    """Ray-ordered samples (8 rays of 512: the coarse levels' rows repeat
    within a warp, so the merges run) and a shuffled copy: both within the
    limits, d x of the shuffled call equal to the permuted d x, HG3's
    outputs of the shuffled call equal to the permuted outputs."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(19)
    x = positions(gen, "ray", 4096).to(cuda_device)
    spec, table, ct_f, ct_j, mask = _jac_case(x, 20, masked, cuda_device)
    perm = torch.randperm(4096, generator=gen).to(cuda_device)
    _, dx = _check_hash_jac(spec, table, x, ct_f, ct_j, mask)
    xp = x[perm].contiguous()
    _, dx_p = _check_hash_jac(spec, table, xp, ct_f[perm].contiguous(),
                              ct_j[:, perm].contiguous(), mask)
    assert torch.equal(dx_p, dx[perm])
    feat, jac = hg.hashgrid_jac_forward_launch(table, x, spec, mask)
    feat_p, jac_p = hg.hashgrid_jac_forward_launch(table, xp, spec, mask)
    assert torch.equal(feat_p, feat[perm]) and torch.equal(jac_p, jac[:, perm])


@pytest.mark.parametrize("masked", [False, True])
def test_hash_jac_backward_one_point(cuda_device, masked):
    """Every one of 4,096 samples at the same position: each warp sums its
    32 samples, each block its warps' sums in warp order, into one update
    per level and corner; the table gradient within 1e-5 x max|exact| of
    the float64 sum of the same updates, d x within its limit."""
    x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(4096, 1).to(cuda_device)
    spec, table, ct_f, ct_j, mask = _jac_case(x, 21, masked, cuda_device)
    _check_hash_jac(spec, table, x, ct_f, ct_j, mask)


def test_hash_jac_no_samples(cuda_device):
    """N = 0: empty outputs and a zero table gradient, no launch."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    x = torch.zeros((0, 3), device=cuda_device)
    spec, table, ct_f, ct_j, mask = _jac_case(x, 22, True, cuda_device)
    before = (hg.hashgrid_jac_forward.launches, hg.hashgrid_jac_backward.launches)
    feat, jac = hg.hashgrid_jac_forward_launch(table, x, spec, mask)
    assert feat.shape == (0, 24) and jac.shape == (3, 0, 24)
    for with_dx in (False, True):
        dt, dx = hg.hashgrid_jac_backward_launch(table, x, ct_f, ct_j, spec, mask,
                                                 with_dx=with_dx)
        torch.cuda.synchronize()
        assert dt.shape == table.shape and not bool(dt.any())
        assert dx is None if not with_dx else tuple(dx.shape) == (0, 3)
    assert (hg.hashgrid_jac_forward.launches, hg.hashgrid_jac_backward.launches) == before


# the level counts HG3's level groups (4, 2 or 1 levels a thread) and HG4's
# tiles (4 levels, the last one short at 6 and 5 levels) cut along
_JAC_TILE_SPECS = {"neus-synthetic": dict(n_levels=12, n_features_per_level=2,
                                          log2_hashmap_size=18, base_resolution=32,
                                          per_level_scale=1.3195079107728942),
                   "6 levels": dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=14,
                                    base_resolution=4, per_level_scale=1.5),
                   "5 levels": dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=11,
                                    base_resolution=4, per_level_scale=1.9)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 3 * 128 + 5, 262107])
@pytest.mark.parametrize("name", sorted(_JAC_TILE_SPECS))
def test_hash_jac_tile_edges(cuda_device, name, n, masked):
    """HG3 / HG4 around their tiles' edges (128 samples a block) at every
    level grouping, with the box's corners and faces, a run of up to 250
    samples on one point from sample 100 (across blocks) and zero cotangents
    on samples 200-259 (a step's empty slots), with and without a band mask
    of the first 5 levels: HG3's features equal to HG1's and its Jacobian
    equal to the plain version's to the bit (the same sums in the same
    order); HG4 against the float64 sum of the plain version's updates
    (``_check_hash_jac``); d x the same bits in two calls."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = hg.HashGridSpec(**_JAC_TILE_SPECS[name])
    gen = torch.Generator().manual_seed(23)
    table = (hg.hashgrid_init(gen, spec) * 1e4).to(cuda_device)
    x = torch.rand((n, 3), generator=gen)
    x[:8] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.0, 0.125],
                          [0.5, 0.5, 0.0], [0.25, 1.0, 0.75], [1.0, 0.3, 0.6],
                          [0.999999, 1e-7, 0.5]])[:n]
    x[100:350] = torch.tensor([0.3, 0.71, 0.52])
    x = x.to(cuda_device)
    ct_f = torch.randn((n, spec.n_output_dims), generator=gen)
    ct_j = torch.randn((3, n, spec.n_output_dims), generator=gen)
    ct_f[200:260], ct_j[:, 200:260] = 0.0, 0.0
    ct_f, ct_j = ct_f.to(cuda_device), ct_j.to(cuda_device)
    mask = (torch.arange(spec.n_levels) < 5).float().to(cuda_device) if masked else None
    feat, jac = hg.hashgrid_jac_forward_launch(table, x, spec, mask)
    torch.cuda.synchronize()
    assert torch.equal(feat, hg.hashgrid_forward_launch(table, x, spec, mask))
    assert torch.equal(jac, hg.hashgrid_jac_forward_plain(table, x, spec, mask)[1])
    _, dx = _check_hash_jac(spec, table, x, ct_f, ct_j, mask)
    _, dx2 = hg.hashgrid_jac_backward_launch(table, x, ct_f, ct_j, spec, mask, with_dx=True)
    assert torch.equal(dx2, dx)
    if n > 200:
        assert not bool(dx[200:260].any())


# K1 / K13 / cp_big's K1 (csrc/cp_mlp_fwd.cu: tensor-core tiles of 64
# samples) and HG1 (csrc/hashgrid_fwd.cu: level-major, (T, F) table)
_FWD_SHAPES = [("bench", 64, (128, 2048), False), ("stacked", 64, (129, 2049), True),
               ("cp_big", 128, (64, 512, 4096), False)]


def _fwd_head(shape, device, seed):
    """A density head at a kernel instantiation's widths (F=16, MLP
    16 S -> 64 -> 16, non-zero biases) from seeded random weights: its
    parameters, packed operands, launch and plain version."""
    _, c, res, stacked = shape
    gen = torch.Generator().manual_seed(seed)
    cp_spec = CPSpec(c, res, 16)
    mlp_spec = MLPSpec(dim_in=16 * len(res), dim_out=16, n_neurons=64, n_hidden_layers=1)
    cp_params = cp_init(gen, cp_spec, device)
    layers = _biased(mlp_init(gen, mlp_spec), gen, device)
    if stacked:
        ops = t_cp_mlp.cp_mlp_stacked_operands(cp_params, layers, cp_spec, mlp_spec)
        launch, plain = t_cp_mlp.cp_mlp_stacked_launch, t_cp_mlp.cp_mlp_stacked_forward_plain
    else:
        ops = t_cp_mlp.cp_mlp_operands(cp_params, layers, cp_spec, mlp_spec)
        launch, plain = t_cp_mlp.cp_mlp_launch, t_cp_mlp.cp_mlp_forward_plain
    return cp_spec, mlp_spec, cp_params, layers, ops, launch, plain, gen


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 262107])
@pytest.mark.parametrize("shape", _FWD_SHAPES, ids=[s[0] for s in _FWD_SHAPES])
def test_cp_forward_sizes_match_plain(cuda_device, shape, n):
    """K1 / K13 / cp_big's K1 around the 64-sample tile and at a ragged
    N: vsave equal to the plain version's to the bit, hsave differing in at
    most 1e-3 of its entries (f32 sums in another order can flip a bf16
    rounding), out within 2e-2; eval equal to training to the bit, and two
    identical calls equal to the bit."""
    cp_spec, mlp_spec, cp_params, layers, ops, launch, plain, gen = _fwd_head(shape, cuda_device,
                                                                           n + 31)
    x = torch.rand((n, 3), generator=gen) * 1.1 - 0.05
    edges = torch.tensor([[0.0, 1.0, 0.5], [1.0, 0.0, -0.05], [1.05, 0.5, 1.0],
                          [1 / 127, 1 / 2047, 0.25]])
    x[: min(n, 4)] = edges[: min(n, 4)]
    x = x.to(cuda_device)
    out, vsave, hsave = launch(ops, x, cp_spec, mlp_spec, train=True)
    out_e, v_e, h_e = launch(ops, x, cp_spec, mlp_spec)
    again = launch(ops, x, cp_spec, mlp_spec, train=True)
    torch.cuda.synchronize()
    assert v_e is None and h_e is None
    assert torch.equal(out, out_e), "eval and training mode disagree"
    for a, b in zip(again, (out, vsave, hsave)):
        assert torch.equal(a, b), "two identical calls disagree"
    ref, ref_v, ref_h = plain(cp_params, layers, x, cp_spec, mlp_spec, save_residuals=True)
    assert out.shape == ref.shape and vsave.shape == ref_v.shape and hsave.shape == ref_h.shape
    assert torch.equal(vsave, ref_v)
    if n:
        assert float((hsave != ref_h).float().mean()) <= 1e-3
        _close(out, ref)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 262107])
def test_hash_forward_sizes_match_plain(cuda_device, n, masked):
    """HG1 at the bench hash shape around its 128-sample blocks and at a
    ragged N, with and without a level mask: equal to its plain version to
    the bit and across two calls; with 6 and 5 levels (2 and 1 levels a
    thread) equal to the bit too."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    gen = torch.Generator().manual_seed(n + 41)
    x = torch.rand((n, 3), generator=gen)
    edges = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75],
                          [0.0, 1.0, 0.5], [1.0, 0.0, 0.125], [0.999999, 1e-7, 0.5]])
    x[: min(n, 6)] = edges[: min(n, 6)]
    x = x.to(cuda_device)
    for spec in (_bench_hash(), hg.HashGridSpec(n_levels=6, log2_hashmap_size=15),
                 hg.HashGridSpec(n_levels=5, log2_hashmap_size=15)):
        table = (hg.hashgrid_init(gen, spec) * 1e4).to(cuda_device)
        assert tuple(table.shape) == (spec.total_params, 2)
        mask = torch.linspace(1.0, 0.0, spec.n_levels).to(cuda_device) if masked else None
        got = hg.hashgrid_forward_launch(table, x, spec, mask)
        again = hg.hashgrid_forward_launch(table, x, spec, mask)
        torch.cuda.synchronize()
        ref = hg.hashgrid_encode(table, x, spec, mask)
        assert got.shape == ref.shape == (n, spec.n_output_dims)
        assert torch.equal(got, ref) and torch.equal(again, got)


# K8 (the raw-product instantiation of csrc/cp_jac_basis_bwd.cu: K10's
# 64-sample tiles without the basis) and K3 (csrc/sh_mlp_fwd.cu: the MLP on
# tensor cores)

# (label, C, R): every K8 instantiation at its models' resolutions
_K8_SHAPES = [("raw", 64, 2048), ("raw_coarse", 64, 128), ("raw_cp_big", 128, 4096),
              ("raw_cp_big_coarse", 128, 64), ("raw_small", 16, 64)]
_K8_IDS = [s[0] for s in _K8_SHAPES]


def _k8_case(shape, x, gen, device):
    """K7 training-mode residuals at positions x (n, 3) and the arguments of
    the matching K8 launch: (u3, vsave, gdsave, d prod, d jac, R)."""
    _, c, r = shape
    u3 = x.T.contiguous()
    lines = t_cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
    _, _, vsave, gdsave = t_cpp.cp_product_jac_launch(lines.to(device), u3, r, train=True)
    n = u3.shape[1]
    dprod = torch.randn((c, n), generator=gen).to(device)
    djac = torch.randn((3, c, n), generator=gen).to(device)
    return [u3, vsave, gdsave, dprod, djac, r]


def _check_k8(args):
    """K8 against its plain version: d lines and d u within 2.5e-2 of the
    largest plain value, one launch counted (none without samples)."""
    before = t_cpp.cp_product_jac_backward.launches
    got = t_cpp.cp_product_jac_backward_launch(*args)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_jac_backward.launches == before + (args[0].shape[1] > 0)
    ref = t_cpp.cp_product_jac_backward_plain(*args)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        if b.numel():
            _close(a, b, rel=2.5e-2)
    return got, ref


@pytest.mark.parametrize("n", [1, 15, 63, 64, 65, 127, 129, 515, 4096])
@pytest.mark.parametrize("shape", _K8_SHAPES, ids=_K8_IDS)
def test_k8_sizes_match_plain(cuda_device, shape, n):
    """K8 at every instantiation and at sizes around the 64-sample tile (n
    not a multiple of 4 reads the f32 cotangents without cp.async)."""
    gen = torch.Generator().manual_seed(400 + n)
    x = (torch.rand((n, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    _check_k8(_k8_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("shape", _K8_SHAPES, ids=_K8_IDS)
def test_k8_no_samples(cuda_device, shape):
    """N = 0: zero table gradients, an empty d u, no launch."""
    gen = torch.Generator().manual_seed(14)
    args = _k8_case(shape, torch.zeros((0, 3), device=cuda_device), gen, cuda_device)
    got, _ = _check_k8(args)
    assert not bool(got[0].any()) and tuple(got[1].shape) == (3, 0)


@pytest.mark.parametrize("shape", _K8_SHAPES, ids=_K8_IDS)
def test_k8_one_point(cuda_device, shape):
    """Every one of 4,096 samples at the same position: each tile's scatter
    merges all its samples into two rows per axis."""
    gen = torch.Generator().manual_seed(15)
    x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(4096, 1).to(cuda_device)
    _check_k8(_k8_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("shape", _K8_SHAPES, ids=_K8_IDS)
def test_k8_edges(cuda_device, shape):
    """u exactly 0 and exactly 1 on each axis in turn (the last tent row,
    d clip(u)/du = 0.5) and out of range; d u zero outside [0, 1]."""
    gen = torch.Generator().manual_seed(16)
    n = 515
    x = torch.rand((n, 3), generator=gen)
    for a in range(3):
        x[a * 100:a * 100 + 50, a] = 0.0
        x[a * 100 + 50:a * 100 + 100, a] = 1.0
    x[300:320] = -0.02
    x[320:340] = 1.03
    args = _k8_case(shape, x.to(cuda_device), gen, cuda_device)
    got, _ = _check_k8(args)
    outside = (args[0] < 0) | (args[0] > 1)
    assert bool(outside.any()) and bool((got[1][outside] == 0).all())


@pytest.mark.parametrize("shape", _K8_SHAPES, ids=_K8_IDS)
def test_k8_order_and_repeat(cuda_device, shape):
    """Ray-ordered samples (8 rays of 512) and a shuffled copy: both within
    2.5e-2, and d u of the shuffled call equal to the permuted d u to the bit
    (each sample's sum over the components runs in a fixed order)."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(17)
    n = 4096
    perm = torch.randperm(n, generator=gen).to(cuda_device)
    args = _k8_case(shape, positions(gen, "ray", n).to(cuda_device), gen, cuda_device)
    shuffled = [args[0][:, perm].contiguous(), args[1][:, :, perm].contiguous(),
                args[2][:, :, perm].contiguous(), args[3][:, perm].contiguous(),
                args[4][:, :, perm].contiguous(), args[5]]
    got, ref = _check_k8(args)
    got_shuffled, _ = _check_k8(shuffled)
    assert torch.equal(got_shuffled[1], got[1][:, perm])
    _close(got_shuffled[0], ref[0], rel=2.5e-2)


# K6 (the CP product's backward: the line-table instantiation of
# csrc/cp_jac_basis_bwd.cu, K8's tiles without the Jacobian, gd read from the
# table: each sample's rows i0 and i0 + 1 gathered per step through L1 with
# cp.async.ca)

# (label, C, R): every K6 instantiation at its models' resolutions (the bench
# finite-difference NeuS, the stacked scales' per-scale products, cp_big's)
_K6_SHAPES = [("prod", 64, 2048), ("prod_coarse", 64, 128), ("prod_stacked", 64, 129),
              ("prod_stacked_fine", 64, 2049), ("prod_cp_big", 128, 4096),
              ("prod_cp_big_mid", 128, 512), ("prod_cp_big_coarse", 128, 64),
              ("prod_small", 16, 64)]
_K6_IDS = [s[0] for s in _K6_SHAPES]


def _k6_case(shape, x, gen, device):
    """K5 training-mode residual at positions x (n, 3) and the arguments of
    the matching K6 launch: (lines, u3, vsave, d prod, R)."""
    _, c, r = shape
    u3 = x.T.contiguous()
    lines = t_cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
    lines = lines.to(device)
    _, vsave = t_cpp.cp_product_launch(lines, u3, r, train=True)
    dprod = torch.randn((c, u3.shape[1]), generator=gen).to(device)
    return [lines, u3, vsave, dprod, r]


def _check_k6(args):
    """K6 against its plain version: d lines and d u within 2.5e-2 of the
    largest plain value, one launch counted (none without samples)."""
    before = t_cpp.cp_product_backward.launches
    got = t_cpp.cp_product_backward_launch(*args)
    torch.cuda.synchronize()
    assert t_cpp.cp_product_backward.launches == before + (args[1].shape[1] > 0)
    ref = t_cpp.cp_product_backward_plain(*args)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        if b.numel():
            _close(a, b, rel=2.5e-2)
    return got, ref


@pytest.mark.parametrize("shape", _K6_SHAPES, ids=_K6_IDS)
def test_k6_stencil_matches_plain(cuda_device, shape):
    """The finite-difference NeuS's operands: 8 rays of 512 samples, each
    expanded into its six-point stencil (tools/bwd_bench.py ``stencil``,
    ``models/geometry.py``'s construction), 24,576 points."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(18)
    x = positions(gen, "stencil", 4096)
    assert tuple(x.shape) == (6 * 4096, 3)
    _check_k6(_k6_case(shape, x.to(cuda_device), gen, cuda_device))


@pytest.mark.parametrize("n", [1, 15, 63, 64, 65, 127, 129, 515, 4096])
@pytest.mark.parametrize("shape", _K6_SHAPES, ids=_K6_IDS)
def test_k6_sizes_match_plain(cuda_device, shape, n):
    """K6 at every instantiation and at sizes around the 64-sample tile (n
    not a multiple of 4 reads the f32 cotangent without cp.async)."""
    gen = torch.Generator().manual_seed(500 + n)
    x = (torch.rand((n, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    _check_k6(_k6_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("shape", _K6_SHAPES, ids=_K6_IDS)
def test_k6_no_samples(cuda_device, shape):
    """N = 0: zero table gradients, an empty d u, no launch."""
    gen = torch.Generator().manual_seed(14)
    args = _k6_case(shape, torch.zeros((0, 3), device=cuda_device), gen, cuda_device)
    got, _ = _check_k6(args)
    assert not bool(got[0].any()) and tuple(got[1].shape) == (3, 0)


@pytest.mark.parametrize("shape", _K6_SHAPES, ids=_K6_IDS)
def test_k6_one_point(cuda_device, shape):
    """Every one of 4,096 samples at the same position: each tile's scatter
    merges all its samples into two rows per axis."""
    gen = torch.Generator().manual_seed(15)
    x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(4096, 1).to(cuda_device)
    _check_k6(_k6_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("shape", _K6_SHAPES, ids=_K6_IDS)
def test_k6_edges(cuda_device, shape):
    """u exactly 0 and exactly 1 on each axis in turn (the last tent row,
    d clip(u)/du = 0.5) and out of range; d u zero outside [0, 1]."""
    gen = torch.Generator().manual_seed(16)
    n = 515
    x = torch.rand((n, 3), generator=gen)
    for a in range(3):
        x[a * 100:a * 100 + 50, a] = 0.0
        x[a * 100 + 50:a * 100 + 100, a] = 1.0
    x[300:320] = -0.02
    x[320:340] = 1.03
    args = _k6_case(shape, x.to(cuda_device), gen, cuda_device)
    got, _ = _check_k6(args)
    outside = (args[1] < 0) | (args[1] > 1)
    assert bool(outside.any()) and bool((got[1][outside] == 0).all())


@pytest.mark.parametrize("shape", _K6_SHAPES, ids=_K6_IDS)
def test_k6_order_and_repeat(cuda_device, shape):
    """Stencil-ordered samples and a shuffled copy: both within 2.5e-2, and d
    u of the shuffled call equal to the permuted d u to the bit (each
    sample's sum over the components runs in a fixed order: lanes, then
    steps), d lines of two identical calls within 2.5e-2 of each other's
    plain version (atomics)."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(17)
    x = positions(gen, "stencil", 1024).to(cuda_device)
    n = x.shape[0]
    perm = torch.randperm(n, generator=gen).to(cuda_device)
    args = _k6_case(shape, x, gen, cuda_device)
    shuffled = [args[0], args[1][:, perm].contiguous(), args[2][:, :, perm].contiguous(),
                args[3][:, perm].contiguous(), args[4]]
    got, ref = _check_k6(args)
    again, _ = _check_k6(args)
    got_shuffled, _ = _check_k6(shuffled)
    assert torch.equal(again[1], got[1])
    assert torch.equal(got_shuffled[1], got[1][:, perm])
    _close(got_shuffled[0], ref[0], rel=2.5e-2)


def _k3_case(shape, n, gen, device):
    """A radiance head at a K3 instantiation's widths (SH degree 4, two hidden
    layers, D = 3, non-zero biases), its packed operands and inputs."""
    _, n_feat, w = shape
    spec = MLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=w, n_hidden_layers=2)
    layers = _biased(mlp_init(gen, spec), gen, device)
    feats, dirs = _sh_inputs(gen, n, n_feat, device)
    return spec, layers, t_sh_mlp.pack_sh_mlp(layers, spec, 4, 16, n_feat), feats, dirs


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 262107])
@pytest.mark.parametrize("shape", _SH_SHAPES, ids=[s[0] for s in _SH_SHAPES])
def test_sh_forward_sizes_match_plain(cuda_device, shape, n):
    """K3 at every instantiation, around the 64-sample tile and at a ragged
    N: eval equal to training to the bit and two identical calls equal, out
    within 2e-2, hsave differing from the plain version's in at most 1e-3 of
    its entries (f32 sums in another order can flip a bf16 rounding), and K4
    on the kernel's hsave within 2.5e-2 of the plain backward on the plain
    hsave. No samples launch nothing."""
    gen = torch.Generator().manual_seed(n + 61)
    spec, layers, ops, feats, dirs = _k3_case(shape, n, gen, cuda_device)
    before = t_sh_mlp.sh_mlp_forward.launches
    out, hsave = t_sh_mlp.sh_mlp_launch(ops, feats, dirs, spec, 4, train=True)
    out_e, h_e = t_sh_mlp.sh_mlp_launch(ops, feats, dirs, spec, 4)
    again = t_sh_mlp.sh_mlp_launch(ops, feats, dirs, spec, 4, train=True)
    torch.cuda.synchronize()
    assert t_sh_mlp.sh_mlp_forward.launches == before + (3 if n else 0)
    assert h_e is None and torch.equal(out, out_e), "eval and training mode disagree"
    assert torch.equal(again[0], out) and torch.equal(again[1], hsave)
    ref, ref_h = t_sh_mlp.sh_mlp_forward_plain(layers, feats, dirs, spec, 4, 16,
                                               save_residuals=True)
    assert out.shape == ref.shape and hsave.shape == ref_h.shape
    if not n:
        return
    assert float((hsave != ref_h).float().mean()) <= 1e-3
    _close(out, ref)
    dout = torch.randn((n, 3), generator=gen).to(cuda_device)
    ws, _, fpad = ops
    got = t_sh_mlp.sh_mlp_backward_launch(feats, dirs, hsave, dout, ws, fpad, spec, 4)
    torch.cuda.synchronize()
    want = t_sh_mlp.sh_mlp_backward_plain(feats, dirs, ref_h, dout, ws, fpad, spec, 4)
    for a, b in zip(got, want):
        _close(a, b, rel=2.5e-2)


def test_sh_forward_packs_once_per_weights_version(cuda_device, monkeypatch):
    """The eval op packs the radiance weights once for any number of chunks
    and packs anew after an in-place update of one of them."""
    gen = torch.Generator().manual_seed(18)
    spec, layers, _, feats, dirs = _k3_case(_SH_SHAPES[0], 3000, gen, cuda_device)
    packs = []
    pack = t_sh_mlp.pack_sh_mlp
    monkeypatch.setattr(t_sh_mlp, "pack_sh_mlp", lambda *a: packs.append(1) or pack(*a))
    with torch.no_grad():
        outs = [t_sh_mlp.sh_mlp_forward(layers, f, d, spec, 4, 16)
                for f, d in zip(feats.split(1000), dirs.split(1000))]
        assert len(packs) == 1
        layers[0]["b"].add_(0.5)
        moved = t_sh_mlp.sh_mlp_forward(layers, feats[:1000], dirs[:1000], spec, 4, 16)
    assert len(packs) == 2 and not torch.equal(moved, outs[0])
    _close(torch.cat(outs), t_sh_mlp.sh_mlp_forward_plain(
        [{"w": l["w"], "b": l["b"] - (0.5 if k == 0 else 0.0)} for k, l in enumerate(layers)],
        feats, dirs, spec, 4, 16))


# K5 (csrc/cp_product_fwd.cu) and K9 / K11 / cp_big's K9 (csrc/cp_jac_basis_fwd.cu):
# K1's 64-sample tiles (whole-row gathers, residuals staged and written as
# whole rows; K9's projection on the tensor cores). prod and the residuals
# equal their plain versions to the bit, enc and jac within 2e-2.

# (label, C, R): every K5 instantiation at its models' resolutions
_K5_SHAPES = [("prod", 64, 2048), ("prod_coarse", 64, 128), ("prod_stacked", 64, 129),
              ("prod_stacked_fine", 64, 2049), ("prod_cp_big", 128, 4096),
              ("prod_cp_big_coarse", 128, 64), ("prod_small", 16, 64)]
_K5_IDS = [s[0] for s in _K5_SHAPES]
# (label, C, F, scales, R): every K9 / K11 instantiation
_K9_SHAPES = [("jacb", 64, 16, 1, 2048), ("jacb_coarse", 64, 16, 1, 128),
              ("jacb_cp_big", 128, 16, 1, 4096), ("jacb_cp_big_mid", 128, 16, 1, 512),
              ("jacb_small", 16, 8, 1, 64), ("stacked", 64, 16, 2, (129, 2049)),
              ("stacked_small", 16, 8, 2, (17, 65))]
_K9_IDS = [s[0] for s in _K9_SHAPES]
_FWD_SIZES = [1, 15, 63, 64, 65, 127, 129, 385, 515, 4096]


def _k5_case(shape, x, gen, device):
    """The arguments of a K5 launch at positions x (n, 3): (lines, u3, R)."""
    _, c, r = shape
    lines = t_cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
    return [lines.to(device), x.T.contiguous(), r]


def _check_k5(args):
    """K5 in training and eval mode against its plain version: prod and
    vsave to the bit, eval equal to training mode, one launch counted per
    call (none without samples). Returns (prod, vsave)."""
    n = args[1].shape[1]
    before = t_cpp.cp_product.launches
    prod, vsave = t_cpp.cp_product_launch(*args, train=True)
    prod_eval, none = t_cpp.cp_product_launch(*args)
    torch.cuda.synchronize()
    assert none is None and t_cpp.cp_product.launches == before + 2 * (n > 0)
    ref, ref_v = t_cpp.cp_product_plain(*args, save_residuals=True)
    assert prod.shape == ref.shape and vsave.shape == ref_v.shape
    assert torch.equal(prod, ref) and torch.equal(vsave, ref_v)
    assert torch.equal(prod_eval, prod)
    return prod, vsave


def _k9_case(shape, x, gen, device):
    """The arguments of a K9 launch (or K11's, with two scales) at positions
    x (n, 3): (lines, basis, u3, R)."""
    _, c, f, scales, r = shape
    u3 = x.T.contiguous()
    if scales == 1:
        lines = t_cpp.line_stack(*[0.1 * torch.randn((r, c), generator=gen) for _ in range(3)])
        basis = (torch.randn((c, f), generator=gen) / c**0.5).to(torch.bfloat16)
        return [lines.to(device), basis.to(device), u3, r]
    spec = CPSpec(c, r, f)
    params = cp_init(gen, spec, device)
    return [t_cps.stack_lines_fine(params, spec), t_cps.basis_stack(params, spec), u3, max(r)]


def _check_k9(args):
    """K9 / K11 in training and eval mode against the plain version: vsave
    and gdsave to the bit, enc and jac within 2e-2, eval equal to training
    mode, one launch counted per call (none without samples). Returns the
    training-mode outputs."""
    stacked = args[1].ndim == 3
    op = t_cps.cp_jac_basis_stacked if stacked else t_cpp.cp_product_jac_basis
    launch = t_cps.cp_jac_basis_stacked_launch if stacked else t_cpp.cp_product_jac_basis_launch
    plain = t_cps.cp_jac_basis_stacked_plain if stacked else t_cpp.cp_product_jac_basis_plain
    n = args[2].shape[1]
    before = op.launches
    got = launch(*args, train=True)
    enc_e, jac_e, v_e, g_e = launch(*args)
    torch.cuda.synchronize()
    assert v_e is None and g_e is None and op.launches == before + 2 * (n > 0)
    ref = plain(*args, save_residuals=True)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    if n:
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    assert torch.equal(enc_e, got[0]) and torch.equal(jac_e, got[1])
    return got


@pytest.mark.parametrize("n", _FWD_SIZES)
@pytest.mark.parametrize("shape", _K5_SHAPES, ids=_K5_IDS)
def test_k5_sizes_match_plain(cuda_device, shape, n):
    """K5 at every instantiation and at sizes around the 64-sample tile and
    a block's passes (n not a multiple of 4 writes the rows element by
    element)."""
    gen = torch.Generator().manual_seed(600 + n)
    x = (torch.rand((n, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    _check_k5(_k5_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("n", _FWD_SIZES)
@pytest.mark.parametrize("shape", _K9_SHAPES, ids=_K9_IDS)
def test_k9_sizes_match_plain(cuda_device, shape, n):
    """K9 / K11 at every instantiation and at sizes around the tile (odd n
    writes enc and jac element by element)."""
    gen = torch.Generator().manual_seed(700 + n)
    x = (torch.rand((n, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    _check_k9(_k9_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("shape", [_K5_SHAPES[0], _K5_SHAPES[4], _K9_SHAPES[0], _K9_SHAPES[2],
                                   _K9_SHAPES[5]], ids=["k5", "k5_cp_big", "k9", "k9_cp_big",
                                                         "k11"])
def test_k5_k9_ragged_full_size(cuda_device, shape):
    """The bench instantiations at chip_smoke.py's ragged N = 262,107 (the
    row starts c * N are not 16-byte aligned)."""
    gen = torch.Generator().manual_seed(19)
    x = (torch.rand((262107, 3), generator=gen) * 1.1 - 0.05).to(cuda_device)
    if len(shape) == 3:
        _check_k5(_k5_case(shape, x, gen, cuda_device))
    else:
        _check_k9(_k9_case(shape, x, gen, cuda_device))


@pytest.mark.parametrize("shape", _K5_SHAPES, ids=_K5_IDS)
def test_k5_no_samples(cuda_device, shape):
    """N = 0: empty prod and vsave, no launch."""
    gen = torch.Generator().manual_seed(14)
    prod, vsave = _check_k5(_k5_case(shape, torch.zeros((0, 3), device=cuda_device), gen,
                                     cuda_device))
    assert tuple(prod.shape) == (shape[1], 0) and tuple(vsave.shape) == (3, shape[1], 0)


@pytest.mark.parametrize("shape", _K9_SHAPES, ids=_K9_IDS)
def test_k9_no_samples(cuda_device, shape):
    """N = 0: empty enc, jac and residuals, no launch."""
    gen = torch.Generator().manual_seed(14)
    got = _check_k9(_k9_case(shape, torch.zeros((0, 3), device=cuda_device), gen, cuda_device))
    assert all(t.shape[-1] == 0 for t in got)


@pytest.mark.parametrize("shape", _K5_SHAPES, ids=_K5_IDS)
def test_k5_one_point(cuda_device, shape):
    """One sample, and every one of 4,096 samples at the same position."""
    gen = torch.Generator().manual_seed(15)
    for n in (1, 4096):
        x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(n, 1).to(cuda_device)
        prod, _ = _check_k5(_k5_case(shape, x, gen, cuda_device))
        assert bool((prod == prod[:, :1]).all())


@pytest.mark.parametrize("shape", _K9_SHAPES, ids=_K9_IDS)
def test_k9_one_point(cuda_device, shape):
    """One sample, and every one of 4,096 samples at the same position (each
    sample's enc and jac the same sums, to the bit)."""
    gen = torch.Generator().manual_seed(15)
    for n in (1, 4096):
        x = torch.tensor([[0.3, 0.71, 0.52]]).repeat(n, 1).to(cuda_device)
        enc, jac, _, _ = _check_k9(_k9_case(shape, x, gen, cuda_device))
        assert bool((enc == enc[:, :1]).all()) and bool((jac == jac[:, :, :1]).all())


def _edge_positions(gen, device, n=515):
    """u exactly 0 and exactly 1 on each axis in turn (the last tent row,
    d clip(u)/du = 0.5) and out of range."""
    x = torch.rand((n, 3), generator=gen)
    for a in range(3):
        x[a * 100:a * 100 + 50, a] = 0.0
        x[a * 100 + 50:a * 100 + 100, a] = 1.0
    x[300:320] = -0.02
    x[320:340] = 1.03
    return x.to(device)


@pytest.mark.parametrize("shape", _K5_SHAPES, ids=_K5_IDS)
def test_k5_edges(cuda_device, shape):
    gen = torch.Generator().manual_seed(16)
    _check_k5(_k5_case(shape, _edge_positions(gen, cuda_device), gen, cuda_device))


@pytest.mark.parametrize("shape", _K9_SHAPES, ids=_K9_IDS)
def test_k9_edges(cuda_device, shape):
    """As K5's, and jac zero outside [0, 1] on that axis (d clip/du = 0)."""
    gen = torch.Generator().manual_seed(16)
    args = _k9_case(shape, _edge_positions(gen, cuda_device), gen, cuda_device)
    _, jac, _, _ = _check_k9(args)
    for a in range(3):
        outside = (args[2][a] < 0) | (args[2][a] > 1)
        assert bool(outside.any()) and not bool(jac[a][:, outside].any())


@pytest.mark.parametrize("shape", _K5_SHAPES, ids=_K5_IDS)
def test_k5_order_and_repeat(cuda_device, shape):
    """Ray-ordered samples: two identical calls equal to the bit, and a
    shuffled copy's outputs the permuted outputs."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(17)
    args = _k5_case(shape, positions(gen, "ray", 4096).to(cuda_device), gen, cuda_device)
    perm = torch.randperm(4096, generator=gen).to(cuda_device)
    prod, vsave = _check_k5(args)
    again = t_cpp.cp_product_launch(*args, train=True)
    shuffled = _check_k5([args[0], args[1][:, perm].contiguous(), args[2]])
    assert torch.equal(again[0], prod) and torch.equal(again[1], vsave)
    assert torch.equal(shuffled[0], prod[:, perm]) and torch.equal(shuffled[1], vsave[:, :, perm])


@pytest.mark.parametrize("shape", _K9_SHAPES, ids=_K9_IDS)
def test_k9_order_and_repeat(cuda_device, shape):
    """Ray-ordered samples: two identical calls equal to the bit, and a
    shuffled copy's outputs the permuted outputs to the bit (each sample's
    sums run in a fixed order)."""
    from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions

    gen = torch.Generator().manual_seed(17)
    args = _k9_case(shape, positions(gen, "ray", 4096).to(cuda_device), gen, cuda_device)
    perm = torch.randperm(4096, generator=gen).to(cuda_device)
    got = _check_k9(args)
    launch = (t_cps.cp_jac_basis_stacked_launch if args[1].ndim == 3
              else t_cpp.cp_product_jac_basis_launch)
    again = launch(*args, train=True)
    shuffled = _check_k9([args[0], args[1], args[2][:, perm].contiguous(), args[3]])
    for a, b, s in zip(got, again, shuffled):
        assert torch.equal(a, b) and torch.equal(s, a[..., perm])


# ---------------------------------------------------------------------------
# unbounded scenes: the hash kernels on contracted points, the contracted grid
# ---------------------------------------------------------------------------

_UNBOUNDED_SPECS = {  # nerf-colmap.yaml's geometry; the NeuS configs' geometry_bg
    "nerf-colmap": dict(n_levels=16, log2_hashmap_size=19, base_resolution=16,
                        per_level_scale=1.447269237440378),
    "neus-colmap-bg": dict(n_levels=16, log2_hashmap_size=19, base_resolution=32,
                           per_level_scale=1.3195079107728942),
}


def _contracted_points(gen, n):
    """World points with radii log-uniform in [0.01, 1e6] through the sphere
    contraction (radius 1), the outer shell crowding toward u -> 1, plus
    u = 1 - 1 ulp and exact cell corners on every axis."""
    from instant_nsr_pl_tpu_torch.ops.contraction import ContractionType, contract_to_unisphere

    d = torch.randn((n, 3), generator=gen, dtype=torch.float64)
    d = d / d.norm(dim=1, keepdim=True)
    r = torch.exp(torch.rand((n, 1), generator=gen, dtype=torch.float64) * math.log(1e8)) * 0.01
    u = contract_to_unisphere((d * r).float(), 1.0, ContractionType.UN_BOUNDED_SPHERE)
    one_minus = 1.0 - 2.0 ** -24
    u[:8] = torch.tensor([[one_minus] * 3, [one_minus, 0.5, 0.0], [0.0, one_minus, 1.0],
                          [1.0, 1.0, 1.0], [0.5, 0.5, one_minus], [1.0 - 2.0 ** -23] * 3,
                          [0.25, 0.75, 0.125], [0.0, 0.0, 0.0]])
    return u.contiguous()


@pytest.mark.parametrize("name", sorted(_UNBOUNDED_SPECS))
def test_hash_kernels_on_contracted_points(cuda_device, name):
    """HG1 / HG2 at the unbounded configs' grids on sphere-contracted points
    (far samples crowd u -> 1; u = 1 - 1 ulp on every axis): HG1 equal to
    its plain version on the card and on the CPU to the bit, each level's
    corner indices equal to the CPU's; HG2 within the hash gradient limits."""
    from instant_nsr_pl_tpu_torch.ops import hashgrid as hg

    spec = hg.HashGridSpec(**_UNBOUNDED_SPECS[name])
    gen = torch.Generator().manual_seed(91)
    x = _contracted_points(gen, 65536)
    # points beyond radius 10 (5 / 8 of them) land within 0.025 of the cube's
    # shell, |c| = 2 - 1 / |x| > 1.9 in the contracted [-2, 2]
    assert float(x.max()) <= 1.0 and float(x.min()) >= 0.0
    assert float(((x - 0.5).norm(dim=1) > 0.475).float().mean()) > 0.5
    table = hg.hashgrid_init(gen, spec) * 1e4
    xd, td = x.to(cuda_device), table.to(cuda_device)
    got = hg.hashgrid_forward_launch(td, xd, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, hg.hashgrid_encode(td, xd, spec))
    assert torch.equal(got.cpu(), hg.hashgrid_encode(table, x, spec))
    for lv in range(spec.n_levels):
        idx_d, w_d = hg.level_corner_indices(spec, xd.T.contiguous(), lv)
        idx_c, w_c = hg.level_corner_indices(spec, x.T.contiguous(), lv)
        assert torch.equal(idx_d.cpu(), idx_c) and torch.equal(w_d.cpu(), w_c), lv
    ct = torch.randn((x.shape[0], spec.n_output_dims), generator=gen).to(cuda_device)
    _check_hash(spec, td, xd, ct, None, exact=True)


def test_unbounded_occupancy_lookup_and_march_on_card_match_cpu(cuda_device):
    """nerf-colmap.yaml's 256^3 contracted grid (a random binary field): the
    occupancy lookup at far points and the cone-angle march (2,048 samples
    from 0.2 to 1e4, 256 rays) on the card equal to the CPU's to the bit."""
    from instant_nsr_pl_tpu_torch.ops import marching as mr
    from instant_nsr_pl_tpu_torch.ops.contraction import ContractionType

    spec = mr.OccGridSpec(256, 1.0, ContractionType.UN_BOUNDED_SPHERE)
    gen = torch.Generator().manual_seed(92)
    binary = torch.rand(spec.num_cells, generator=gen) < 0.2
    d = torch.randn((100000, 3), generator=gen)
    p = d / d.norm(dim=1, keepdim=True) * torch.exp(torch.rand((100000, 1), generator=gen) * 20.0)
    hit_c = mr.occupancy_lookup_coords(binary, *p.T, spec)
    hit_d = mr.occupancy_lookup_coords(binary.to(cuda_device), *p.to(cuda_device).T, spec)
    assert torch.equal(hit_d.cpu(), hit_c) and 0.05 < float(hit_c.float().mean()) < 0.5
    n, S = 256, 2048
    o = torch.randn((n, 3), generator=gen) * 0.3
    rd = torch.randn((n, 3), generator=gen)
    rd = rd / rd.norm(dim=1, keepdim=True)
    kw = dict(render_step_size=0.01, max_samples=S, capacity=n * 512, occ_spec=spec,
              cone_angle=10.0 ** (4.0 / S) - 1.0)
    jit = torch.rand(n, generator=gen)
    t0, t1 = torch.full((n,), 0.2), torch.full((n,), 1e4)
    cpu = mr.march_rays(o, rd, t0, t1, occ_binary=binary, jitter=jit, **kw)
    dev = mr.march_rays(*(a.to(cuda_device) for a in (o, rd, t0, t1)),
                        occ_binary=binary.to(cuda_device), jitter=jit.to(cuda_device), **kw)
    assert int(cpu.num_valid) > 50 * n
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# VM1 / VM2 (csrc/vm_{fwd,bwd}.cu) and MT1 / MT2 (csrc/marching_tet.cu)
# ---------------------------------------------------------------------------


def _vm_case(gen, spec, n, order="uniform"):
    """Tables, n positions and cotangents. ``order`` "uniform": uniform
    points; "ray": samples along straight rays in ray order, with a run of 70
    samples on one point (whole warps' runs of VM2 in one cell, across a
    run's and a tile's end) and samples on the planes' and lines' cell edges.
    Both start with samples at u = 0 and 1."""
    from instant_nsr_pl_tpu_torch.ops import vm as t_vm

    params = t_vm.vm_init(gen, spec)
    params = {k: v + 0.3 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    if order == "uniform":
        x = torch.rand((n, 3), generator=gen)
    else:
        rays = -(-n // 48)
        o = torch.rand((rays, 1, 3), generator=gen)
        d = torch.nn.functional.normalize(torch.randn((rays, 1, 3), generator=gen), dim=-1)
        t = torch.linspace(0.0, 0.5, 48)[None, :, None]
        x = (o + t * d).clamp(0.0, 1.0).reshape(-1, 3)[:n].contiguous()
        x[100:170] = torch.tensor([0.31, 0.62, 0.27])
        edges = torch.tensor([3.0, 5.0, 7.0]) / torch.tensor(
            [spec.plane_res(0) - 1, spec.plane_res(0) - 1, spec.line_resolution - 1])
        x[20:30] = edges
    x[:6] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.25, 0.0],
                          [0.5, 1.0, 1.0], [1 / 15, 0.5, 1.0]])
    ct = torch.randn((n, spec.n_output_dims), generator=gen)
    return params, x, ct


@pytest.mark.parametrize("c,n_scales,n,order", [
    (4, 2, 1001, "uniform"), (16, 2, 4096, "uniform"), (8, 1, 33, "uniform"),
    (32, 3, 517, "uniform"), (16, 2, 0, "uniform"), (16, 2, 4096, "ray"), (16, 2, 389, "ray"),
    (4, 4, 1001, "ray"), (8, 1, 515, "ray"), (32, 3, 257, "ray"), (16, 4, 130, "ray")])
def test_vm_kernels_match_plain(cuda_device, c, n_scales, n, order):
    """VM1 equal to its plain version on the card and on the CPU to the bit;
    VM2's table gradients within 1e-5 x max|ref| per table of the float64 sum
    of the plain updates, its d x within 1e-4 x max|plain| (samples at u = 0
    and 1 included) and equal to the bit in a second run; through the
    autograd op, d x only when x requires it. On uniform points and on
    ray-ordered samples (VM2's merge of equal rows), at N around VM2's runs
    of 16 and tiles of 32 / (C / 4) runs."""
    from instant_nsr_pl_tpu_torch.ops import vm as t_vm

    spec = t_vm.VMSpec(n_components=c, plane_resolution=24, line_resolution=40,
                       n_scales=n_scales)
    gen = torch.Generator().manual_seed(c * 10 + n_scales)
    params, x, ct = _vm_case(gen, spec, max(n, 200), order)
    x, ct = x[:n], ct[:n]
    pd = {k: v.to(cuda_device) for k, v in params.items()}
    xd, ctd = x.to(cuda_device), ct.to(cuda_device)
    before = t_vm.vm_forward.launches
    got = t_vm.vm_forward(pd, xd, spec)
    torch.cuda.synchronize()
    assert t_vm.vm_forward.launches == before + (n > 0)
    assert torch.equal(got, t_vm.vm_encode(pd, xd, spec))
    assert torch.equal(got.cpu(), t_vm.vm_encode(params, x, spec))
    dparams, dx = t_vm.vm_backward(pd, xd, ctd, spec, with_dx=True)
    ref, rdx = t_vm.vm_backward_plain(params, x, ct, spec, with_dx=True, accumulate=torch.float64)
    for k in spec.keys():
        tol = 1e-5 * max(float(ref[k].abs().max()), 1e-30)
        assert float((dparams[k].cpu().double() - ref[k]).abs().max()) <= tol, k
    if n == 0:  # no launch: zero gradients, an empty d x
        assert tuple(dx.shape) == (0, 3)
        return
    _close(dx, rdx, rel=1e-4)
    _, dx2 = t_vm.vm_backward(pd, xd, ctd, spec, with_dx=True)
    assert torch.equal(dx, dx2)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pd.items()}
    (t_vm.vm_encode_fast(leaves, xd, spec) * ctd).sum().backward()
    for k in spec.keys():
        _close(leaves[k].grad, ref[k].float(), rel=1e-5)


def _sphere_grid(res, radius=0.6, center=(0.05, -0.1, 0.02)):
    c = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2)
            - radius).astype(np.float32)


def _nan_field():
    """A sphere SDF with NaN corners: the four cubes around one crossed +z
    edge each get a NaN corner off the edge (no vertex there), and a dozen
    scattered NaNs (``test_torch_port_marching.py``'s field)."""
    v = _sphere_grid(30)
    inside = v < 0
    xs, ys, zs = np.nonzero(inside[:, :, :-1] != inside[:, :, 1:])
    pick = [(x, y, z) for x, y, z in zip(xs, ys, zs) if 2 <= x <= 27 and 2 <= y <= 27]
    x, y, z = pick[len(pick) // 3]
    for dx in (-1, 1):
        for dy in (-1, 1):
            v[x + dx, y + dy, z] = np.nan
    v[tuple(np.random.RandomState(5).randint(0, 30, (12, 3)).T)] = np.nan
    return v


def _box_field():
    """A sphere of radius 1.2 in [-1, 1]^3 on a 21 x 19 x 23 grid: the surface
    cuts all six faces of the box."""
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in (21, 19, 23)]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.2).astype(np.float32)


@pytest.mark.parametrize("field", ["sphere", "random", "aniso", "quantized", "flat", "tiny",
                                   "nan", "box", "unaligned"])
def test_marching_kernels_match_numpy_twin(cuda_device, field):
    """MT1 / MT2 against the numpy twin: the same faces and vertices, to the
    bit, in the same order, on a sphere SDF, a random field (iso 0.1), an
    anisotropic grid, a field with values on the iso level and on rounding
    ties, a field without a surface, a 2-wide grid, a field with NaN corners,
    a surface that cuts all six faces of the box and a grid whose storage
    starts 4 bytes past a 16-byte boundary (MT1 without its float4 loads);
    the scanned totals are the mesh's sizes."""
    from instant_nsr_pl_tpu_torch.ops import isosurface as t_iso

    rs = np.random.RandomState(3)
    values, iso = {
        "sphere": (_sphere_grid(97), 0.0),
        "random": (rs.randn(23, 19, 17).astype(np.float32), 0.1),
        "aniso": (rs.rand(9, 40, 6).astype(np.float32), 0.5),
        "quantized": ((np.round(_sphere_grid(64) * 8) / 8).astype(np.float32), 0.0),
        "flat": (np.ones((8, 8, 8), np.float32), 0.0),
        "tiny": (rs.randn(2, 5, 6).astype(np.float32), 0.0),
        "nan": (_nan_field(), 0.0),
        "box": (_box_field(), 0.0),
        "unaligned": (_sphere_grid(64), 0.0),
    }[field]
    rv, rf = t_iso.marching_tetrahedra_numpy(values, iso)
    before = t_iso.marching_classify.launches, t_iso.marching_emit.launches
    grid = torch.from_numpy(values).to(cuda_device)
    if field == "unaligned":
        flat = torch.cat([torch.zeros(1, device=cuda_device), grid.reshape(-1)])
        grid = flat[1:].reshape(values.shape)
        assert grid.is_contiguous() and grid.data_ptr() % 16 == 4
    v, f = t_iso.marching_tetrahedra(grid, iso)
    torch.cuda.synchronize()
    assert (t_iso.marching_classify.launches, t_iso.marching_emit.launches) == (
        before[0] + 1, before[1] + int(len(rf) > 0))
    assert v.device.type == "cuda" and v.dtype == torch.float32 and f.dtype == torch.int64
    np.testing.assert_array_equal(f.cpu().numpy(), rf)
    np.testing.assert_array_equal(v.cpu().numpy(), rv)
    totals = t_iso.marching_classify(grid, float(np.float32(iso))).totals.tolist()
    assert totals[1:] == [len(rf), len(rv)]


def test_marching_wide_offsets_match_narrow(cuda_device):
    """The 64-bit instantiation of MT1 / MT2 (asked for with ``wide``) on
    the 512^3 sphere, which the 32-bit one marches by default: the same
    bytes, counts and scans, and the same mesh to the bit."""
    from instant_nsr_pl_tpu_torch.ops import isosurface as t_iso

    grid = torch.from_numpy(_sphere_grid(512)).to(cuda_device)
    narrow = t_iso.marching_classify(grid, 0.0)
    wide = t_iso.marching_classify(grid, 0.0, wide=True)
    assert not narrow.wide and wide.wide
    for a, b in zip(narrow[:5], wide[:5]):
        assert torch.equal(a, b)
    nv, nf = t_iso.marching_emit(grid, 0.0, narrow)
    wv, wf = t_iso.marching_emit(grid, 0.0, wide)
    torch.cuda.synchronize()
    assert len(nf) > 2_000_000 and torch.equal(nf, wf) and torch.equal(nv, wv)


# ---------------------------------------------------------------------------
# slice 14: JPEG decoding on the card's host, the compositing VJP on the card
# ---------------------------------------------------------------------------

_JPEG_FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "jpeg"
_JPEG_DIGESTS = json.loads((_JPEG_FIXTURES / "digests.json").read_text())["pil"]


@pytest.mark.parametrize("group", sorted({p.split("/")[0] for p in _JPEG_DIGESTS}))
def test_jpeg_fixtures_match_pil_digests(group):
    """``read_jpeg`` on the committed fixtures (a capture's folder as one
    case) against the digests PIL gave when they were written: sha256,
    shape and mode. Needs no card and no PIL, so it also holds the host
    build of ``jpeg_decode.cc`` on the card's machine."""
    from instant_nsr_pl_tpu_torch.utils.image_io import read_jpeg

    names = [p for p in _JPEG_DIGESTS if p.split("/")[0] == group]
    for name in names:
        a, mode = read_jpeg(_JPEG_FIXTURES / name)
        got = {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "shape": list(a.shape),
               "mode": mode}
        assert got == _JPEG_DIGESTS[name], name


@pytest.mark.parametrize("group", [1, 8])
def test_compositing_backward_matches_autograd_on_card(cuda_device, group):
    """``accumulate_along_rays``'s custom VJP (one gather) against autograd
    through the same float64 prefix-sum forward, on CUDA tensors: the
    forward to the bit, the gradients of weights and values within 1e-6 x
    max|grad|, with invalid and padding slots and rays that own none."""
    from instant_nsr_pl_tpu_torch.ops import rendering as t_rend

    rs = np.random.RandomState(group)
    n_rays, cap = 4096, 1 << 17
    blocks = rs.randint(0, 5, n_rays)
    ray_of_block = np.repeat(np.arange(n_rays), blocks)[: cap // group - 4]
    live = len(ray_of_block) * group
    ends = torch.from_numpy(np.cumsum(np.bincount(ray_of_block, minlength=n_rays) * group))
    valid = torch.zeros(cap, dtype=torch.bool)
    valid[:live] = torch.from_numpy(rs.rand(live) < 0.8)
    weights = torch.from_numpy(rs.rand(cap).astype(np.float32))
    values = torch.from_numpy(rs.randn(cap, 5).astype(np.float32))
    ct = torch.from_numpy(rs.randn(n_rays, 5).astype(np.float32)).to(cuda_device)
    ends, valid = ends.to(cuda_device), valid.to(cuda_device)

    def grads(fn):
        w = weights.to(cuda_device).requires_grad_()
        v = values.to(cuda_device).requires_grad_()
        src = torch.where(valid, w, torch.zeros_like(w))[:, None] * v
        if group > 1:
            src = src.reshape(-1, group, 5).sum(dim=1)
        out = fn(src, ends // group)
        return (out.detach(), *torch.autograd.grad(out, (w, v), ct))

    new = grads(t_rend.segment_sum_sorted)
    old = grads(t_rend.segment_sum_prefix)
    got = t_rend.accumulate_along_rays(weights.to(cuda_device), values.to(cuda_device), ends,
                                       valid=valid, group=group)
    assert torch.equal(new[0], old[0]) and torch.equal(got, old[0])
    for a, b in zip(new[1:], old[1:]):
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("group", [1, 8])
def test_segmented_cumsum_backward_matches_autograd_on_card(cuda_device, group, monkeypatch):
    """The segmented prefix sum's backward (``SegmentedInclusiveCumsum``:
    the cotangent's segmented sum read from the right, gathers only) against
    autograd through the same float64 forward (``segmented_inclusive_prefix``,
    whose gathers' backward is a float64 scatter) on CUDA tensors, through
    ``render_weight_from_density`` and ``distortion_loss``: the forwards to
    the bit, d sigma, d weights and d midpoints within 1e-6 x max|grad|,
    with invalid slots, rays without samples and padding slots. Both run
    with PyTorch's deterministic algorithms on: its CUDA float cumsum
    otherwise adds in an order that varies from run to run."""
    from instant_nsr_pl_tpu_torch.ops import rendering as t_rend

    rs = np.random.RandomState(10 + group)
    n_rays, cap = 4096, 1 << 17
    blocks = rs.randint(0, 5, n_rays)
    ray_of_block = np.repeat(np.arange(n_rays), blocks)[: cap // group - 4]
    live = len(ray_of_block) * group
    ray_indices = np.full(cap, n_rays - 1, np.int64)
    ray_indices[:live] = np.repeat(ray_of_block, group)
    valid = np.zeros(cap, bool)
    valid[:live] = rs.rand(live) < 0.8
    ts = np.sort(rs.uniform(0, 3, cap)).astype(np.float32)
    te = (ts + rs.uniform(0.001, 0.02, cap)).astype(np.float32)
    sigma = rs.exponential(20.0, cap).astype(np.float32)
    ct = rs.randn(cap).astype(np.float32)
    dev = cuda_device
    ri, va, t0, t1 = (torch.from_numpy(a).to(dev) for a in (ray_indices, valid, ts, te))

    def run():
        s = torch.from_numpy(sigma).to(dev).requires_grad_()
        w = t_rend.render_weight_from_density(t0, t1, s, ri, va, group=group)
        (d_s,) = torch.autograd.grad(w, s, torch.from_numpy(ct).to(dev))
        wl = w.detach().clone().requires_grad_()
        m = (0.5 * (t0 + t1)).requires_grad_()
        loss = t_rend.distortion_loss(wl, m, t1 - t0, ri, va, n_rays, group=group)
        return (w.detach(), loss.detach(), d_s, *torch.autograd.grad(loss, (wl, m)))

    torch.use_deterministic_algorithms(True)
    try:
        new = run()
        monkeypatch.setattr(t_rend, "_segmented_inclusive_cumsum",
                            lambda flags, x: t_rend.segmented_inclusive_prefix(flags, x)[0])
        old = run()
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    for a, b in zip(new[2:], old[2:]):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0,
                                   atol=1e-6 * float(b.abs().max()))
