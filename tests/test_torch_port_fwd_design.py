"""CPU checks around the redesigned forward kernels: the fused CP density
head K1 / K13 (tensor-core tiles of 64 samples, ``csrc/cp_mlp_fwd.cu``) and
the hash encode HG1 (level-major, from the row-major (T, F) table,
``csrc/hashgrid_fwd.cu``).

- K1 / K13's plain versions (what a CPU tensor runs, and what the card
  tests hold the kernels against) against the JAX package's Pallas forward
  kernels in interpret mode (``_fwd_impl`` / ``_fwd_impl_stacked``, called
  eagerly: ``jax.jit`` of them needs a bf16 x bf16 -> f32 dot this XLA CPU
  build lacks), with transplanted parameters, at sizes around the card
  kernel's 64-sample tile and a ragged count: the output within
  ``2e-2 * max|ref|`` (``tests/test_cp_mlp_pallas.py:53``), the residual
  vsave equal to the bit (each v is one rounding of two exact products in
  both), hsave within the output's limit (bf16 activations of f32 sums
  taken in another order); no samples give empty outputs of the kernels'
  shapes.
- The hash table's row-major (T, F) layout: a JAX table carried from a
  parameter pytree and from a JAX ``.npz`` train state (its Adam moments
  too) is transposed, and the port's encoding of it equals the JAX
  package's ``hashgrid_encode`` within 1e-6 relative; a port checkpoint
  round-trips the (T, F) table and its moments.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py``)."""

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
from instant_nsr_pl_tpu.models import network_utils as j_nu
from instant_nsr_pl_tpu.ops import cp_mlp_pallas as j_cpm
from instant_nsr_pl_tpu.ops import hashgrid as jh
from instant_nsr_pl_tpu.ops.cp import CPSpec as JCPSpec
from instant_nsr_pl_tpu.ops.cp import cp_init as j_cp_init
from instant_nsr_pl_tpu.ops.mlp import MLPSpec as JMLPSpec
from instant_nsr_pl_tpu.ops.mlp import mlp_init as j_mlp_init
from instant_nsr_pl_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models import network_utils as t_nu
from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cpm
from instant_nsr_pl_tpu_torch.ops import hashgrid as th
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec
from instant_nsr_pl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from instant_nsr_pl_tpu_torch.utils.transplant import (
    params_from_jax,
    params_from_state_dict,
    port_layout,
)

TILE = 64  # samples per tile of the card's K1 / K13 (csrc/mma_common.cuh kT)
HASH_CFG = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=14, base_resolution=4,
                per_level_scale=1.5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(tree):
    return params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)),
                                  "cpu")


def _head(stacked, n_hidden, seed):
    """A small fused head (the test instantiation C=16, F=8, MLP 16->32->16)
    in both packages with the same parameters (non-zero biases)."""
    res = (17, 65) if stacked else (24, 64)
    j_spec = JCPSpec(n_components=16, resolutions=res, n_features=8)
    j_mlp = JMLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    rs = np.random.RandomState(seed)
    cp_p = j_cp_init(jax.random.PRNGKey(seed), j_spec)
    mlp_p = [{"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
             for l in j_mlp_init(jax.random.PRNGKey(seed + 1), j_mlp)]
    cp_spec = CPSpec(16, res, 8)
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    return (j_spec, j_mlp, cp_p, mlp_p), (cp_spec, mlp_spec, _carry(cp_p), _carry(mlp_p)), rs


def _close(got, ref, what, rel=2e-2):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 1000])
@pytest.mark.parametrize("stacked", [False, True])
def test_cp_forward_plain_matches_jax_kernel_around_the_tile(stacked, n):
    """K1 (K13 with ``stacked``) plain version against the Pallas forward:
    output within 2e-2 x max|ref|, vsave to the bit, hsave within the
    output's limit; the op (``cp_mlp_forward``) equals the plain version."""
    (j_spec, j_mlp, cp_p, mlp_p), (cp_spec, mlp_spec, tcp, tmlp), rs = _head(stacked, 1, n)
    x = rs.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    x[: min(n, 4)] = np.array([[0.0, 1.0, 0.5], [1.0, 0.0, 1.05], [-0.05, 0.5, 1.0],
                               [0.25, 0.75, 0.0]], np.float32)[: min(n, 4)]
    impl = j_cpm._fwd_impl_stacked if stacked else j_cpm._fwd_impl
    out, (_, _, vsave, hsave), *_ = impl(cp_p, mlp_p, jnp.asarray(x), j_spec, j_mlp)
    plain = t_cpm.cp_mlp_stacked_forward_plain if stacked else t_cpm.cp_mlp_forward_plain
    got, vs, hs = plain(tcp, tmlp, torch.from_numpy(x), cp_spec, mlp_spec, save_residuals=True)
    _close(got, out, "out")
    np.testing.assert_array_equal(vs.float().numpy(),
                                  np.asarray(vsave.astype(jnp.float32))[:, :, :n])
    assert tuple(hs.shape) == (1, 32, n) and hs.dtype == torch.bfloat16
    _close(hs, np.asarray(hsave.astype(jnp.float32))[:, :, :n], "hsave")
    op = t_cpm.cp_mlp_stacked_forward if stacked else t_cpm.cp_mlp_forward
    assert torch.equal(op(tcp, tmlp, torch.from_numpy(x), cp_spec, mlp_spec), got)


@pytest.mark.parametrize("stacked", [False, True])
def test_cp_forward_plain_two_hidden_layers_match_jax(stacked):
    """The second test instantiation (two hidden layers): output and both
    hidden layers of hsave against the Pallas forward at a ragged count."""
    (j_spec, j_mlp, cp_p, mlp_p), (cp_spec, mlp_spec, tcp, tmlp), rs = _head(stacked, 2, 7)
    x = rs.uniform(0.0, 1.0, (TILE * 3 + 5, 3)).astype(np.float32)
    impl = j_cpm._fwd_impl_stacked if stacked else j_cpm._fwd_impl
    out, (_, n, vsave, hsave), *_ = impl(cp_p, mlp_p, jnp.asarray(x), j_spec, j_mlp)
    plain = t_cpm.cp_mlp_stacked_forward_plain if stacked else t_cpm.cp_mlp_forward_plain
    got, vs, hs = plain(tcp, tmlp, torch.from_numpy(x), cp_spec, mlp_spec, save_residuals=True)
    _close(got, out, "out")
    np.testing.assert_array_equal(vs.float().numpy(),
                                  np.asarray(vsave.astype(jnp.float32))[:, :, :n])
    for layer in range(2):
        _close(hs[layer], np.asarray(hsave.astype(jnp.float32))[layer, :, :n], f"hsave {layer}")


@pytest.mark.parametrize("stacked", [False, True])
def test_cp_forward_plain_zero_samples(stacked):
    """No samples: an empty output and empty residuals of the kernels'
    shapes, through the op and the plain version."""
    _, (cp_spec, mlp_spec, tcp, tmlp), _ = _head(stacked, 1, 3)
    x = torch.zeros((0, 3))
    plain = t_cpm.cp_mlp_stacked_forward_plain if stacked else t_cpm.cp_mlp_forward_plain
    out, vs, hs = plain(tcp, tmlp, x, cp_spec, mlp_spec, save_residuals=True)
    assert tuple(out.shape) == (0, 16) and tuple(vs.shape) == (3, 32, 0)
    assert tuple(hs.shape) == (1, 32, 0)
    op = t_cpm.cp_mlp_stacked_forward if stacked else t_cpm.cp_mlp_forward
    assert tuple(op(tcp, tmlp, x, cp_spec, mlp_spec).shape) == (0, 16)


def _hash_x(n, seed):
    x = np.random.RandomState(seed).rand(n, 3).astype(np.float32)
    x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.75], [0.999999, 1e-7, 0.5]]
    return x


def test_hash_table_from_jax_pytree_is_row_major_and_encodes_as_jax():
    """A JAX ``HashGrid`` encoding's parameters carried with
    ``params_from_jax``: the (F, T) table arrives as the port's (T, F)
    table, other leaves as they were, and the port's encoding of it equals
    the JAX ``hashgrid_encode`` within 1e-6 relative."""
    cfg = {"otype": "HashGrid", **HASH_CFG}
    j_enc = j_nu.get_encoding(3, cfg)
    t_enc = t_nu.get_encoding(3, cfg)
    j_params = j_enc.init(jax.random.PRNGKey(0))
    j_table = (np.random.RandomState(1).rand(*np.asarray(j_params["table"]).shape) - 0.5)
    j_params = {"table": jnp.asarray(j_table.astype(np.float32))}
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    spec = t_enc.encoding.spec
    assert tuple(sd["table"].shape) == (spec.total_params, 2) and sd["table"].is_contiguous()
    np.testing.assert_array_equal(sd["table"].numpy().T, np.asarray(j_params["table"]))
    x = _hash_x(3000, 2)
    ref = np.asarray(jax.jit(lambda t, a: jh.hashgrid_encode(t, a, jh.HashGridSpec(**HASH_CFG)))(
        j_params["table"], x))
    got = t_enc.apply(params_from_state_dict(sd, "cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    # only a hash table's leaf is transposed
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(port_layout("geometry.network.layers.0.w", w), w)
    np.testing.assert_array_equal(port_layout("geometry.encoding.table", w), w.T)


def _hash_nerf_cfg():
    """A hash NeRF at narrow widths (the shape of ``tests/test_torch_port_hashgrid.py``'s)."""
    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "n_neurons": 32}
    return {
        "name": "nerf-hash-small",
        "seed": 3,
        "dataset": {"name": "synthetic", "size": 16, "n_train": 2, "n_val": 1},
        "model": {
            "name": "nerf", "radius": 1.5, "num_samples_per_ray": 1024,
            "train_num_rays": 48, "max_train_num_rays": 48, "train_num_samples": 16384,
            "dynamic_ray_sampling": False, "eval_chunk_rays": 1024, "eval_num_samples": 65536,
            "grid_prune": True, "grid_warmup_steps": 16, "learned_background": False,
            "background_color": "random", "randomized": True,
            "geometry": {
                "name": "volume-density", "radius": 1.5, "feature_dim": 16,
                "density_activation": "trunc_exp", "density_bias": -1,
                "xyz_encoding_config": {"otype": "HashGrid", **HASH_CFG, "grad_mode": "fast"},
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


def _port_system(cfg):
    dm = t_reg.datasets.make("synthetic", t_config(copy.deepcopy(cfg))["dataset"])
    dm.setup("fit")
    system = t_reg.systems.make("nerf-system", t_config(copy.deepcopy(cfg)), device="cpu")
    system.setup_data(dm.train)
    return system


def test_hash_table_from_jax_npz_state_with_moments_encodes_as_jax(tmp_path):
    """A JAX ``.npz`` train state of a hash NeRF (random leaves): the table
    and its AdamW moments land transposed in the port's state, the other
    leaves as they were, and the port's encoding of the loaded table equals
    the JAX ``hashgrid_encode`` of the saved one within 1e-6 relative."""
    cfg = _hash_nerf_cfg()
    j_dm = j_reg.datasets.make("synthetic", j_config(copy.deepcopy(cfg))["dataset"])
    j_dm.setup("fit")
    j_sys = j_reg.systems.make("nerf-system", j_config(copy.deepcopy(cfg)))
    j_sys.setup_data(j_dm.train)
    rs = np.random.RandomState(4)
    j_state = jax.tree_util.tree_map(
        lambda a: (jnp.asarray(rs.rand(*np.shape(a)).astype(np.float32) - 0.5)
                   if np.asarray(a).dtype == np.float32 else a),
        j_sys.init_state(seed=0))
    path = str(tmp_path / "jax-hash.ckpt.npz")
    j_save_checkpoint(path, j_state)

    system = _port_system(cfg)
    state = load_checkpoint(path, system.init_state(seed=0))
    live = dict(named_leaves(state["params"]))
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, j_state["params"])))
    spec = th.HashGridSpec(**HASH_CFG)
    table = state["params"]["geometry"]["encoding"]["table"]
    assert tuple(table.shape) == (spec.total_params, 2) and table.is_contiguous()
    for key, t in live.items():
        want = ref[key].T if key == "geometry.encoding.table" else ref[key]
        np.testing.assert_array_equal(t.detach().numpy(), want, err_msg=key)
    adam = j_state["opt_state"].inner_states["geometry"].inner_state[0]
    opt = state["optimizer"].optimizer
    for moment, leaves in (("exp_avg", adam.mu["geometry"]), ("exp_avg_sq", adam.nu["geometry"])):
        want = np.asarray(leaves["encoding"]["table"])
        got = opt.state[table][moment].numpy()
        assert got.shape == (spec.total_params, 2)
        np.testing.assert_array_equal(got.T, want)
    x = _hash_x(2000, 5)
    j_table = ref["geometry.encoding.table"]
    want = np.asarray(jax.jit(lambda t, a: jh.hashgrid_encode(t, a, jh.HashGridSpec(**HASH_CFG)))(
        j_table, x))
    got = th.hashgrid_encode(table.detach(), torch.from_numpy(x), spec).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_port_checkpoint_round_trips_row_major_table(tmp_path):
    """A port checkpoint of a hash NeRF after two steps: the (T, F) table,
    its AdamW moments and the step come back equal, and training goes on."""
    cfg = _hash_nerf_cfg()
    system = _port_system(cfg)
    state = system.init_state(seed=0)
    for _ in range(2):
        state, _ = system.train_step(state)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, state)
    loaded = load_checkpoint(path, _port_system(cfg).init_state(seed=1))
    spec = th.HashGridSpec(**HASH_CFG)
    a = state["params"]["geometry"]["encoding"]["table"]
    b = loaded["params"]["geometry"]["encoding"]["table"]
    assert tuple(b.shape) == (spec.total_params, 2) and b.is_contiguous()
    assert torch.equal(a.detach(), b.detach()) and loaded["step"] == state["step"] == 2
    opt_a, opt_b = state["optimizer"].optimizer, loaded["optimizer"].optimizer
    for moment in ("exp_avg", "exp_avg_sq"):
        assert tuple(opt_b.state[b][moment].shape) == (spec.total_params, 2)
        assert torch.equal(opt_a.state[a][moment], opt_b.state[b][moment])
    loaded, metrics = system.train_step(loaded)
    assert loaded["step"] == 3 and np.isfinite(float(metrics["train/loss"]))
