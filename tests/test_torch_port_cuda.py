"""The port's CUDA kernels on the card, each against its plain PyTorch
version, and a small NeRF forward on the card against the same forward on
the CPU. Skipped without a CUDA device. This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu_torch.config import config_from_dict
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cp_mlp
from instant_nsr_pl_tpu_torch.ops import sh_mlp as t_sh_mlp
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    """Tolerance of the JAX kernel tests: bf16 operands, f32 accumulation."""
    ref = ref.cpu()
    torch.testing.assert_close(got.cpu(), ref, rtol=0,
                               atol=2e-2 * max(float(ref.abs().max()), 1e-3))


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
