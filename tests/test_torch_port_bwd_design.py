"""CPU checks around the tensor-core backward kernels K2/K14 and K4: the
plain versions (what a CPU tensor runs, and what the card tests hold the
kernels against) at zero samples, against the JAX package's Pallas backward
kernels in interpret mode at sizes around the kernels' 64-sample tile, and
the ray-ordered operands of ``tools/bwd_bench.py``. The kernels themselves
run only on the card (``tests/test_torch_port_cuda.py``).

Tolerance of the JAX kernel tests: gradients within 2.5e-2 of their largest
reference value (bf16 operands, f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import cp_mlp_pallas as j_cpm
from instant_nsr_pl_tpu.ops.cp import CPSpec as JCPSpec
from instant_nsr_pl_tpu.ops.cp import cp_init as j_cp_init
from instant_nsr_pl_tpu.ops.mlp import MLPSpec as JMLPSpec
from instant_nsr_pl_tpu.ops.mlp import mlp_init as j_mlp_init
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cpm
from instant_nsr_pl_tpu_torch.ops import sh_mlp as t_shm
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec, cp_init
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec, mlp_init
from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict


@pytest.mark.parametrize("stacked", [False, True])
def test_cp_backward_plain_zero_samples(stacked):
    """K2 / K14's plain versions with no samples: zero gradients of the
    kernels' output shapes."""
    gen = torch.Generator().manual_seed(0)
    cp_spec = CPSpec(16, (17, 65) if stacked else (24, 64), 8)
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=1)
    cp_params = cp_init(gen, cp_spec)
    layers = mlp_init(gen, mlp_spec)
    x = torch.zeros((0, 3))
    if stacked:
        ops = t_cpm.cp_mlp_stacked_operands(cp_params, layers, cp_spec, mlp_spec)
        _, vsave, hsave = t_cpm.cp_mlp_stacked_forward_plain(cp_params, layers, x, cp_spec,
                                                             mlp_spec, save_residuals=True)
        got = t_cpm.cp_mlp_stacked_backward(x, vsave, hsave, torch.zeros((0, 16)), ops[1],
                                            ops[2], cp_spec, mlp_spec)
        shapes = [(3, 65, 32), (2, 16, 8), (48, 32), (2, 32)]
        flat = list(got)
    else:
        ops = t_cpm.cp_mlp_operands(cp_params, layers, cp_spec, mlp_spec)
        _, vsave, hsave = t_cpm.cp_mlp_forward_plain(cp_params, layers, x, cp_spec, mlp_spec,
                                                     save_residuals=True)
        got = t_cpm.cp_mlp_backward(x, vsave, hsave, torch.zeros((0, 16)), ops[1], ops[2],
                                    cp_spec, mlp_spec)
        shapes = [(3, 24, 16), (3, 64, 16), (2, 16, 8), (48, 32), (2, 32)]
        flat = [*got[0], *got[1:]]
    assert [tuple(t.shape) for t in flat] == shapes
    assert not any(bool(t.any()) for t in flat)


def test_sh_backward_plain_zero_samples():
    """K4's plain version with no samples: zero dW and db, an empty d features."""
    gen = torch.Generator().manual_seed(1)
    spec = MLPSpec(dim_in=35, dim_out=3, n_neurons=32, n_hidden_layers=2)
    layers = mlp_init(gen, spec)
    ws, _, fpad = t_shm.pack_sh_mlp(layers, spec, 4, 16, 19)
    hsave = torch.zeros((2, 32, 0), dtype=torch.bfloat16)
    dws, dbs, dfeat = t_shm.sh_mlp_backward(torch.zeros((0, 19)), torch.zeros((0, 3)), hsave,
                                            torch.zeros((0, 3)), ws, fpad, spec, 4)
    assert tuple(dws.shape) == (24 + 16 + 64, 32) and tuple(dbs.shape) == (3, 32)
    assert tuple(dfeat.shape) == (0, 19)
    assert not bool(dws.any()) and not bool(dbs.any())


@pytest.mark.parametrize("n", [1, 63, 65, 129])
def test_cp_backward_plain_matches_jax_kernel_around_the_tile(n):
    """K2's plain version on the JAX forward's own residuals against the
    Pallas backward (interpret mode), at sizes on both sides of the card
    kernel's 64-sample tile: line tables, basis, dW and db within 2.5e-2 of
    their largest reference value."""
    rs = np.random.RandomState(n)
    j_spec = JCPSpec(n_components=16, resolutions=(24, 64), n_features=8)
    j_mlp = JMLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=1)
    cp_p = j_cp_init(jax.random.PRNGKey(n), j_spec)
    mlp_p = [{"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
             for l in j_mlp_init(jax.random.PRNGKey(n + 1), j_mlp)]
    x = rs.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    dout = rs.randn(n, 16).astype(np.float32)
    _, (u3p, n_, vsave, hsave), _ = j_cpm._fwd_impl(cp_p, mlp_p, jnp.asarray(x), j_spec, j_mlp)
    saved = (cp_p, mlp_p, u3p, n_, vsave, hsave, jnp.asarray(x))
    d_cp, d_mlp, _ = j_cpm._cp_mlp_bwd(j_spec, j_mlp, saved, jnp.asarray(dout))

    cp_spec = CPSpec(16, (24, 64), 8)
    mlp_spec = MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=1)

    def carry(tree):
        return params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)),
                                      "cpu")

    _, basis, ws, _ = t_cpm.cp_mlp_operands(carry(cp_p), carry(mlp_p), cp_spec, mlp_spec)
    vs = torch.from_numpy(np.asarray(vsave.astype(jnp.float32))[:, :, :n]).bfloat16()
    hs = torch.from_numpy(np.asarray(hsave.astype(jnp.float32))[:, :, :n]).bfloat16()
    dlines, dbasis, dws, dbs = t_cpm.cp_mlp_backward(torch.from_numpy(x), vs, hs,
                                                     torch.from_numpy(dout), basis, ws,
                                                     cp_spec, mlp_spec)

    def close(got, ref, what):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=2.5e-2 * max(np.abs(ref).max(), 1e-8), err_msg=what)

    for s in range(2):
        for ax in range(3):
            close(dlines[s][ax], d_cp[f"line_{s}_{ax}"], f"line_{s}_{ax}")
        close(dbasis[s], d_cp[f"basis_{s}"], f"basis_{s}")
    close(dws[:16, :32], d_mlp[0]["w"], "w0")
    close(dbs[0, :32], d_mlp[0]["b"], "b0")
    close(dws[16:, :16], d_mlp[1]["w"], "w1")
    close(dbs[1, :16], d_mlp[1]["b"], "b1")


def test_ray_ordered_positions():
    """``tools/bwd_bench.py``'s ray-ordered operands: 512 samples per ray,
    inside the unit box, evenly spaced and in order along each ray."""
    x = positions(torch.Generator().manual_seed(0), "ray", 4096).reshape(8, 512, 3)
    assert bool(((x >= 0) & (x <= 1)).all())
    step = x[:, 1:] - x[:, :-1]
    torch.testing.assert_close(step, step[:, :1].expand_as(step), rtol=0, atol=1e-5)
    assert bool((step.norm(dim=-1) > 0).all())
