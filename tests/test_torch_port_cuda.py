"""The port's CUDA kernels on the card, each against its plain PyTorch
version (the backwards fed the same training-mode residuals), a small NeRF
forward on the card against the same forward on the CPU, and gradients
flowing through a training step on the card. Skipped without a CUDA device.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

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


@pytest.mark.parametrize("c,res,n", [(16, 24, 515), (16, 64, 4096), (64, 2048, 3001)])
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


@pytest.mark.parametrize("c,f,res,n", [(16, 8, 24, 515), (16, 8, 64, 4096), (64, 16, 2048, 3001)])
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


def test_neus_train_step_cuda_gradients_flow(cuda_device):
    """A small NeuS system on the card (analytic gradients on the jac path):
    train_step launches K3, K4, K9 and K10 and, in its warmup grid update,
    K5; after that first update every parameter gets a finite, non-zero
    gradient; with finite differences K5 and K6 run on every step."""
    import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
    from instant_nsr_pl_tpu_torch.registry import datasets, systems

    def make(grad_type):
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
                                            "resolutions": [24, 64], "n_features": 8,
                                            "include_xyz": True},
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
