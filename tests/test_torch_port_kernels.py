"""The port's fused density and radiance ops against the JAX package: the
plain PyTorch versions (what a CPU tensor runs) against the Pallas kernels in
interpret mode and their plain-XLA twins, parameters carried across with
utils/transplant.py. The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_port_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops.cp import CPSpec as JCPSpec
from instant_nsr_pl_tpu.ops.cp import cp_init
from instant_nsr_pl_tpu.ops.cp_mlp_pallas import cp_mlp_apply, cp_mlp_reference
from instant_nsr_pl_tpu.ops.marching import OccGridSpec as JOccGridSpec
from instant_nsr_pl_tpu.ops.marching import _postprocess_binary as j_postprocess
from instant_nsr_pl_tpu.ops.mlp import MLPSpec as JMLPSpec
from instant_nsr_pl_tpu.ops.mlp import mlp_init
from instant_nsr_pl_tpu.ops.sh import sh_output_dim
from instant_nsr_pl_tpu.ops.sh_mlp_pallas import sh_mlp_apply, sh_mlp_reference
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cp_mlp
from instant_nsr_pl_tpu_torch.ops import sh_mlp as t_sh_mlp
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec
from instant_nsr_pl_tpu_torch.utils.transplant import (
    occupancy_from_jax,
    params_from_jax,
    params_from_state_dict,
    state_dict,
)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(tree, device="cpu"):
    return params_from_state_dict(params_from_jax(_np_tree(tree)), device)


def _close(got, ref):
    """The JAX kernel tests' tolerance (tests/test_cp_mlp_pallas.py:53):
    both sides round matmul operands to bf16 with f32 accumulation."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, atol=2e-2 * max(np.abs(ref).max(), 1e-3))


def _cp_setup(n_hidden, n=515, seed=0):
    rs = np.random.RandomState(seed)
    cp_spec = JCPSpec(n_components=16, resolutions=(24, 64), n_features=8)
    mlp_spec = JMLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    cp_params = cp_init(jax.random.PRNGKey(seed), cp_spec)
    mlp_params = [
        {"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
        for l in mlp_init(jax.random.PRNGKey(seed + 1), mlp_spec)
    ]
    x = rs.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    # exact knots of both grids, the ends 0 and 1, and out-of-range coords
    x[:8] = [[0.0, 1.0, 0.5], [1.0, 0.0, 1.0], [1 / 23, 5 / 23, 22 / 23],
             [1 / 63, 31 / 63, 62 / 63], [-0.1, 1.1, 0.0], [12 / 23, 21 / 63, 1.0],
             [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]
    t_specs = (CPSpec(16, (24, 64), 8),
               MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden))
    return cp_spec, mlp_spec, cp_params, mlp_params, x, t_specs


@pytest.mark.parametrize("n_hidden", [1, 2])
def test_cp_mlp_plain_matches_jax(n_hidden):
    cp_spec, mlp_spec, cp_params, mlp_params, x, (tcp, tmlp) = _cp_setup(n_hidden)
    kernel = jax.jit(lambda c, m, v: cp_mlp_apply(c, m, v, cp_spec, mlp_spec))(
        cp_params, mlp_params, jnp.asarray(x))
    # eager: this XLA CPU build has no fused bf16 x bf16 -> f32 dot thunk
    # for the twin's tent product under jit
    twin = cp_mlp_reference(cp_params, mlp_params, jnp.asarray(x), cp_spec, mlp_spec)
    assert t_cp_mlp.fusable(tcp, tmlp)
    got = t_cp_mlp.cp_mlp_forward(_carry(cp_params), _carry(mlp_params),
                                  torch.from_numpy(x), tcp, tmlp)
    assert got.shape == (515, 16) and got.dtype == torch.float32
    _close(got, kernel)
    _close(got, twin)


def test_cp_mlp_plain_chunking_changes_nothing(monkeypatch):
    cp_spec, mlp_spec, cp_params, mlp_params, x, (tcp, tmlp) = _cp_setup(1)
    args = (_carry(cp_params), _carry(mlp_params), torch.from_numpy(x), tcp, tmlp)
    one = t_cp_mlp.cp_mlp_forward_plain(*args)
    monkeypatch.setattr(t_cp_mlp, "_CHUNK", 37)  # 37-sample chunks
    torch.testing.assert_close(t_cp_mlp.cp_mlp_forward_plain(*args), one, rtol=0, atol=0)


@pytest.mark.parametrize("n_pre,n_post", [(16, 0), (16, 3)])
def test_sh_mlp_plain_matches_jax(n_pre, n_post):
    rs = np.random.RandomState(2)
    n_feat = n_pre + n_post
    spec = JMLPSpec(dim_in=n_feat + sh_output_dim(4), dim_out=3, n_neurons=32, n_hidden_layers=2)
    params = [
        {"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
        for l in mlp_init(jax.random.PRNGKey(5), spec)
    ]
    feats = rs.randn(300, n_feat).astype(np.float32)
    dirs = rs.randn(300, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    kernel = jax.jit(lambda p, f, d: sh_mlp_apply(p, f, d, spec, 4, n_pre))(params, feats, dirs)
    twin = jax.jit(lambda p, f, d: sh_mlp_reference(p, f, d, spec, 4, n_pre))(params, feats, dirs)
    tspec = MLPSpec(dim_in=spec.dim_in, dim_out=3, n_neurons=32, n_hidden_layers=2)
    assert t_sh_mlp.fusable(tspec, n_feat, 4)
    got = t_sh_mlp.sh_mlp_forward(_carry(params), torch.from_numpy(feats),
                                  torch.from_numpy(dirs), tspec, 4, n_pre)
    assert got.shape == (300, 3)
    _close(got, kernel)
    _close(got, twin)


def test_sh_pack_order_and_padding():
    """The kernel's first-layer rows: [features | extras | zero pad | SH]."""
    spec = MLPSpec(dim_in=19 + 16, dim_out=3, n_neurons=32, n_hidden_layers=2)
    w0 = torch.arange(35 * 32, dtype=torch.float32).reshape(35, 32)
    params = [{"w": w0, "b": torch.zeros(32)},
              {"w": torch.zeros(32, 32), "b": torch.zeros(32)},
              {"w": torch.zeros(32, 3), "b": torch.zeros(3)}]
    ws, bs, fpad = t_sh_mlp.pack_sh_mlp(params, spec, 4, 16, 19)
    assert fpad == 24 and ws.shape == (24 + 16 + 64, 32) and bs.shape == (3, 32)
    rows = ws[:40].float()
    torch.testing.assert_close(rows[:16], w0[:16].bfloat16().float())   # pre
    torch.testing.assert_close(rows[16:19], w0[32:35].bfloat16().float())  # extras
    assert (rows[19:24] == 0).all()  # padding
    torch.testing.assert_close(rows[24:40], w0[16:32].bfloat16().float())  # SH


def test_transplant_params_and_grid():
    cp_spec, mlp_spec, cp_params, mlp_params, x, (tcp, tmlp) = _cp_setup(1, n=64)
    tree = {"geometry": {"encoding": {"cp": cp_params}, "network": {"layers": mlp_params}},
            "texture": {"dir_encoding": {}, "network": {"layers": mlp_params}}}
    sd = params_from_jax(_np_tree(tree))
    assert set(sd) == {
        *(f"geometry.encoding.cp.line_{s}_{a}" for s in range(2) for a in range(3)),
        "geometry.encoding.cp.basis_0", "geometry.encoding.cp.basis_1",
        *(f"{h}.network.layers.{i}.{k}" for h in ("geometry", "texture")
          for i in range(2) for k in "wb"),
    }
    assert sd["geometry.encoding.cp.line_1_2"].shape == (64, 16)  # (R, C) as in JAX
    assert sd["geometry.network.layers.0.w"].shape == (16, 32)  # (d_in, d_out)
    np.testing.assert_array_equal(sd["geometry.encoding.cp.basis_0"].numpy(),
                                  np.asarray(cp_params["basis_0"]))
    params = params_from_state_dict(sd)
    assert isinstance(params["geometry"]["network"]["layers"], list)
    assert state_dict(params).keys() == sd.keys()
    got = t_cp_mlp.cp_mlp_forward(params["geometry"]["encoding"]["cp"],
                                  params["geometry"]["network"]["layers"],
                                  torch.from_numpy(x), tcp, tmlp)
    ref = cp_mlp_reference(cp_params, mlp_params, jnp.asarray(x), cp_spec, mlp_spec)
    _close(got, ref)

    rs = np.random.RandomState(0)
    binary = rs.rand(32**3) < 0.05
    dil, bricks = j_postprocess(jnp.asarray(binary), JOccGridSpec(32, 1.5))
    jgrid = {"occs": rs.rand(32**3).astype(np.float32), "binary": binary,
             "binary_dilated": np.asarray(dil), "bricks": np.asarray(bricks)}
    grid = occupancy_from_jax(jgrid, "cpu")
    assert isinstance(grid, OccupancyGridState) and grid.binary.dtype == torch.bool
    np.testing.assert_array_equal(grid.binary_dilated.numpy(), np.asarray(dil))
    np.testing.assert_array_equal(grid.occs.numpy(), jgrid["occs"])
