"""CPU checks around the redesigned K8 (the raw CP product-with-Jacobian
backward: K10's 64-sample tiles without the basis, ``csrc/cp_jac_basis_bwd.cu``)
and K3 (the fused SH radiance forward on tensor cores, ``csrc/sh_mlp_fwd.cu``).

- K8's plain version (what a CPU tensor runs, and what the card tests hold
  the kernel against) against the JAX package's Pallas backward
  ``_cp_product_jac_bwd`` in interpret mode, fed the JAX forward's residuals,
  at sizes around the card kernel's 64-sample tile and one scatter run, at
  R = 128 and 2048, with u exactly 0 and 1 on each axis and with every
  sample at one point (the case the kernel's row merge sums whole): d lines
  and d u within 2.5e-2 x max|ref| (the JAX kernel tests' gradient limit).
- K3's plain version with its residual against ``_fwd_impl`` (Pallas in
  interpret mode, called eagerly: ``jax.jit`` of it needs a bf16 x bf16 ->
  f32 dot this XLA CPU build lacks), with and without NeuS normals as
  extras, parameters carried by ``utils/transplant.py``: ``out`` within
  2e-2 x max|ref| and hsave within the output's limit (bf16 activations of
  f32 sums taken in another order); no samples give empty outputs of the
  kernel's shapes.
- The radiance weights are packed once for a rendered view of many chunks
  and again only after the weights change (``ops/mlp_common.py``
  ``packed_once``): the eval path's launches are counted on the CPU with the
  op's kernel device pointed at the CPU and a stand-in for the launch.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instant_nsr_pl_tpu_torch.datasets  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.systems  # noqa: F401  (register)
from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu.ops import sh_mlp_pallas as j_shm
from instant_nsr_pl_tpu.ops.mlp import MLPSpec as JMLPSpec
from instant_nsr_pl_tpu.ops.mlp import mlp_init as j_mlp_init
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import sh_mlp as t_shm
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

TILE = 64  # samples per tile of the card's K8 and K3 (csrc/mma_common.cuh kT)
RUN = 3 * TILE  # the (axis, sample) rows a K8 tile scatters
C = 16  # the small test model's components: the tile and the scatter do not depend on C


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _k8_inputs(res, n, seed, one_point):
    """Three (R, C) tables and (3, N) coordinates: uniform in [-0.05, 1.05]
    with u exactly 0 and exactly 1 on each axis in turn, or every sample at
    one point."""
    rs = np.random.RandomState(seed)
    lines = [(rs.randn(res, C) * 0.1).astype(np.float32) for _ in range(3)]
    if one_point:
        u3 = np.tile(np.array([[0.3], [0.71], [0.52]], np.float32), (1, n))
    else:
        u3 = rs.uniform(-0.05, 1.05, (3, n)).astype(np.float32)
        for a in range(3):
            u3[a, (2 * a) % n] = 0.0
            u3[a, (2 * a + 1) % n] = 1.0
    return lines, u3


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, RUN - 1, 1000])
@pytest.mark.parametrize("res", [128, 2048])
def test_k8_plain_matches_jax_kernel_around_the_tile(res, n):
    """K8's plain version against ``_cp_product_jac_bwd`` on the residuals of
    ``_cp_product_jac_fwd_impl`` (bit-equal to the port's, tests/
    test_torch_port_raw_ops.py): d lines and d u within 2.5e-2."""
    lines, u3 = _k8_inputs(res, n, seed=res + n, one_point=False)
    jl = [jnp.asarray(a) for a in lines]
    _, _, vsave, gdsave = j_cpp._cp_product_jac_fwd_impl(*jl, jnp.asarray(u3), res)
    rs = np.random.RandomState(n + 3)
    dprod = rs.randn(C, n).astype(np.float32)
    djac = rs.randn(3, C, n).astype(np.float32)
    ref = j_cpp._cp_product_jac_bwd(res, (*jl, jnp.asarray(u3), vsave, gdsave),
                                    (jnp.asarray(dprod), jnp.asarray(djac)))
    t_v = _t(np.asarray(vsave[:, :, :n]).astype(np.float32)).to(torch.bfloat16)
    t_gd = _t(np.asarray(gdsave[:, :, :n]).astype(np.float32)).to(torch.bfloat16)
    dlines, du = t_cpp.cp_product_jac_backward_plain(_t(u3), t_v, t_gd, _t(dprod), _t(djac), res)
    assert dlines.shape == (3, res, C) and du.shape == (3, n)
    for ax in range(3):
        _close(dlines[ax], ref[ax], 2.5e-2, f"d line {ax}")
    _close(du, ref[3], 2.5e-2, "du")


@pytest.mark.parametrize("res", [128, 2048])
def test_k8_plain_matches_jax_kernel_one_point(res):
    """Every sample at one point: all of a tile's samples land on the same two
    rows per axis, the kernel's merged case."""
    n = 2 * RUN + 5
    lines, u3 = _k8_inputs(res, n, seed=7, one_point=True)
    jl = [jnp.asarray(a) for a in lines]
    _, _, vsave, gdsave = j_cpp._cp_product_jac_fwd_impl(*jl, jnp.asarray(u3), res)
    rs = np.random.RandomState(8)
    dprod = rs.randn(C, n).astype(np.float32)
    djac = rs.randn(3, C, n).astype(np.float32)
    ref = j_cpp._cp_product_jac_bwd(res, (*jl, jnp.asarray(u3), vsave, gdsave),
                                    (jnp.asarray(dprod), jnp.asarray(djac)))
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    _, _, t_v, t_gd = t_cpp.cp_product_jac_plain(stack, _t(u3), res, save_residuals=True)
    dlines, du = t_cpp.cp_product_jac_backward_plain(_t(u3), t_v, t_gd, _t(dprod), _t(djac), res)
    for ax in range(3):
        assert int((dlines[ax].abs().sum(1) > 0).sum()) == 2  # two rows per axis
        _close(dlines[ax], ref[ax], 2.5e-2, f"d line {ax}")
    _close(du, ref[3], 2.5e-2, "du")


def _k3_head(n_extra, seed):
    """The small radiance head (16 features, ``n_extra`` extras such as NeuS
    normals, SH degree 4, MLP -> 32 -> 32 -> 3, non-zero biases) in both
    packages with the same parameters."""
    n_feat = 16 + n_extra
    j_spec = JMLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=32, n_hidden_layers=2,
                      output_activation="Sigmoid")
    rs = np.random.RandomState(seed)
    params = [{"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
              for l in j_mlp_init(jax.random.PRNGKey(seed), j_spec)]
    spec = MLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=32, n_hidden_layers=2,
                   output_activation="Sigmoid")
    carried = params_from_state_dict(
        params_from_jax(jax.tree_util.tree_map(np.asarray, params)), "cpu")
    return j_spec, params, spec, carried, rs


def _k3_inputs(rs, n, n_feat):
    feats = rs.randn(n, n_feat).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    return feats, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, RUN - 1, 1000])
@pytest.mark.parametrize("n_extra", [0, 3])
def test_k3_plain_matches_jax_kernel_around_the_tile(n_extra, n):
    """K3's plain version with its residual against ``_fwd_impl``: out within
    2e-2 x max|ref|, both hidden layers of hsave within the output's limit."""
    j_spec, params, spec, carried, rs = _k3_head(n_extra, n)
    feats, dirs = _k3_inputs(rs, n, 16 + n_extra)
    out, (_, _, n_, hsave), _ = j_shm._fwd_impl(params, jnp.asarray(feats), jnp.asarray(dirs),
                                                j_spec, 4, 16)
    got, hs = t_shm.sh_mlp_forward_plain(carried, _t(feats), _t(dirs), spec, 4, 16,
                                         save_residuals=True)
    assert n_ == n and tuple(hs.shape) == (2, 32, n) and hs.dtype == torch.bfloat16
    _close(got, out, 2e-2, "out")
    for layer in range(2):
        _close(hs[layer], np.asarray(hsave.astype(jnp.float32))[layer, :, :n], 2e-2,
               f"hsave {layer}")


@pytest.mark.parametrize("n_extra", [0, 3])
def test_k3_plain_zero_samples(n_extra):
    """No samples: an empty output and an empty residual of the kernel's
    shapes, through the plain version and the op."""
    _, _, spec, carried, _ = _k3_head(n_extra, 3)
    feats, dirs = torch.zeros((0, 16 + n_extra)), torch.zeros((0, 3))
    out, hs = t_shm.sh_mlp_forward_plain(carried, feats, dirs, spec, 4, 16, save_residuals=True)
    assert tuple(out.shape) == (0, 3) and tuple(hs.shape) == (2, 32, 0)
    with torch.no_grad():
        assert tuple(t_shm.sh_mlp_forward(carried, feats, dirs, spec, 4, 16).shape) == (0, 3)


def _nerf_cfg():
    """A small fused NeRF (the bench model's shape at narrow widths) whose
    32x32 view renders in chunks of 256 rays."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "dataset": {"name": "synthetic", "size": 32, "n_train": 1, "n_val": 1},
        "model": {
            "name": "nerf", "radius": 1.5, "num_samples_per_ray": 1024,
            "eval_chunk_rays": 256, "eval_num_samples": 8192,
            "grid_prune": True, "learned_background": False,
            "geometry": {
                "name": "volume-density", "radius": 1.5, "feature_dim": 16,
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


def test_render_packs_radiance_weights_once_per_view(monkeypatch):
    """A 32x32 view rendered in four chunks: the eval op launches once per
    chunk and packs the radiance weights once; a second view packs nothing;
    after an in-place update of one weight the next view packs once more."""
    cfg = _nerf_cfg()
    dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    dm.setup("validate")
    system = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    system.setup_data(dm.val)
    state = system.init_state(seed=0)

    packs, launches = [], []
    pack = t_shm.pack_sh_mlp

    def counted_pack(*args):
        packs.append(1)
        return pack(*args)

    def stand_in(operands, features, dirs, mlp_spec, degree, train=False):
        assert not train and operands[0].dtype == torch.bfloat16
        launches.append(features.shape[0])
        return torch.zeros((*features.shape[:-1], mlp_spec.dim_out)), None

    monkeypatch.setattr(t_shm, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(t_shm, "pack_sh_mlp", counted_pack)
    monkeypatch.setattr(t_shm, "sh_mlp_launch", stand_in)
    system.evaluate_image(state, 0)
    assert len(launches) == 4 and len(packs) == 1, (launches, packs)
    system.evaluate_image(state, 0)
    assert len(launches) == 8 and len(packs) == 1
    with torch.no_grad():
        state["params"]["texture"]["network"]["layers"][1]["w"].mul_(1.5)
    system.evaluate_image(state, 0)
    assert len(launches) == 12 and len(packs) == 2
