"""CPU checks around the tensor-core backward K10 / K12 (the CP product with
its Jacobian and basis) and the merged-scatter table gradient HG2: their
plain versions (what a CPU tensor runs, and what the card tests hold the
kernels against) on the ray-ordered samples of ``tools/bwd_bench.py``, where
neighbouring samples share table rows, against the JAX package's backward
(the Pallas kernels ``_cp_jacb_bwd`` / ``_cp_jacs_bwd`` in interpret mode,
and ``_encode_fast_bwd`` through ``jax.vjp``), and at zero samples. The
kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).

Tolerance of the JAX kernel tests: gradients within 2.5e-2 of their largest
reference value (bf16 operands, f32 sums in another order; the JAX hash
path rounds ``w * ct`` to bf16 on its one-hot matmul levels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import cp as j_cp
from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu.ops import hashgrid as jh
from instant_nsr_pl_tpu_torch.ops import cp as t_cp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import cp_stacked as t_cps
from instant_nsr_pl_tpu_torch.ops import hashgrid as th
from instant_nsr_pl_tpu_torch.tools.bwd_bench import positions
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

C, F = 16, 8
N_RAY = 1024  # two rays of 512 samples


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, what, rel=2.5e-2):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _ray_u3(seed, n=N_RAY):
    """(3, n) coordinates of n / 512 rays of 512 samples across the unit box."""
    return positions(torch.Generator().manual_seed(seed), "ray", n).T.contiguous().numpy()


@pytest.mark.parametrize("res", [16, 64, 128])
def test_jac_basis_backward_plain_matches_pallas_on_rays(res, monkeypatch):
    """K10's plain version on the JAX forward's residuals against
    ``_cp_jacb_bwd`` (interpret mode) on ray-ordered samples: the line
    tables (whose rows repeat from sample to sample), the coordinates and the
    basis within 2.5e-2."""
    monkeypatch.setattr(j_cpp, "_block_n", lambda r: 256)
    rs = np.random.RandomState(res)
    lines = [(rs.randn(res, C) * 0.1).astype(np.float32) for _ in range(3)]
    basis = (rs.randn(C, F) / np.sqrt(C)).astype(np.float32)
    u3 = _ray_u3(res)
    jl = [jnp.asarray(a) for a in lines]
    _, _, vsave, gdsave = j_cpp._cp_jacb_fwd_impl(*jl, jnp.asarray(basis), jnp.asarray(u3), res)
    denc = rs.randn(F, N_RAY).astype(np.float32)
    djac = rs.randn(3, F, N_RAY).astype(np.float32)
    ref = j_cpp._cp_jacb_bwd(res, (*jl, jnp.asarray(basis), jnp.asarray(u3), vsave, gdsave),
                             (jnp.asarray(denc), jnp.asarray(djac)))
    t_v = _t(np.asarray(vsave[:, :, :N_RAY]).astype(np.float32)).bfloat16()
    t_gd = _t(np.asarray(gdsave[:, :, :N_RAY]).astype(np.float32)).bfloat16()
    dlines, du, dbasis = t_cpp.cp_product_jac_basis_backward(
        _t(u3), t_v, t_gd, _t(denc), _t(djac), _t(basis).bfloat16(), res)
    i0 = t_cpp.tent_coords(_t(u3[0]), res)[0]
    assert int((i0[1:] == i0[:-1]).sum()) > N_RAY // 4  # rows repeat along a ray
    for ax in range(3):
        _close(dlines[ax], ref[ax], f"d line {ax}")
    _close(dbasis, ref[3], "d basis")
    _close(du, ref[4], "du")


def test_jac_stacked_backward_plain_matches_pallas_on_rays(monkeypatch):
    """K12's plain version against ``_cp_jacs_bwd`` (interpret mode) on
    ray-ordered samples at nested R = (17, 65): every coarse line (through
    ``U^T d fine``), basis and the coordinates within 2.5e-2."""
    monkeypatch.setattr(j_cpp, "_block_n", lambda r: 256)
    res = (17, 65)
    j_spec, t_spec = j_cp.CPSpec(C, res, F), t_cp.CPSpec(C, res, F)
    params = j_cp.cp_init(jax.random.PRNGKey(3), j_spec)
    u3 = _ray_u3(4)
    assert float(u3.max()) < 1.0  # the JAX kernel's diff-hot differs from the port's at u = 1
    _, _, vsave, gdsave = j_cpp._cp_jacs_fwd_impl(params, jnp.asarray(u3), j_spec)
    rs = np.random.RandomState(5)
    denc = rs.randn(2 * F, N_RAY).astype(np.float32)
    djac = rs.randn(3, 2 * F, N_RAY).astype(np.float32)
    d_params, du = j_cpp._cp_jacs_bwd(j_spec, (params, jnp.asarray(u3), vsave, gdsave),
                                      (jnp.asarray(denc), jnp.asarray(djac)))
    tp = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    basis = t_cps.basis_stack(tp, t_spec)
    t_v = _t(np.asarray(vsave[:, :, :N_RAY]).astype(np.float32)).bfloat16()
    t_gd = _t(np.asarray(gdsave[:, :, :N_RAY]).astype(np.float32)).bfloat16()
    dfine, t_du, dbasis = t_cps.cp_jac_basis_stacked_backward(
        _t(u3), t_v, t_gd, _t(denc), _t(djac), basis, max(res))
    lines_g = t_cps.coarse_line_grads(dfine, t_spec)
    for s in range(len(res)):
        for ax in range(3):
            _close(lines_g[f"line_{s}_{ax}"], d_params[f"line_{s}_{ax}"], f"line_{s}_{ax}")
        _close(dbasis[s], d_params[f"basis_{s}"], f"basis_{s}")
    _close(t_du, du, "du")


@pytest.mark.parametrize("stacked", [False, True])
def test_jac_backward_plain_zero_samples(stacked):
    """K10 / K12's plain versions with no samples: zero gradients of the
    kernels' output shapes and an empty d u."""
    s_count = 2 if stacked else 1
    r = 65
    u3 = torch.zeros((3, 0))
    res = torch.zeros((3, s_count * C, 0), dtype=torch.bfloat16)
    denc, djac = torch.zeros((s_count * F, 0)), torch.zeros((3, s_count * F, 0))
    if stacked:
        basis = torch.ones((s_count, C, F), dtype=torch.bfloat16)
        got = t_cps.cp_jac_basis_stacked_backward(u3, res, res, denc, djac, basis, r)
    else:
        basis = torch.ones((C, F), dtype=torch.bfloat16)
        got = t_cpp.cp_product_jac_basis_backward(u3, res, res, denc, djac, basis, r)
    dlines, du, dbasis = got
    assert tuple(dlines.shape) == (3, r, s_count * C) and tuple(du.shape) == (3, 0)
    assert tuple(dbasis.shape) == ((s_count, C, F) if stacked else (C, F))
    assert not bool(dlines.any()) and not bool(dbasis.any())


HASH_SPECS = {
    # 5 levels, 2^11 rows: levels 0-1 dense, 2-4 hashed
    "small": dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=11, base_resolution=4,
                  per_level_scale=1.9),
    # 4 levels, 2^17 rows: the JAX fast path's two-sort levels 2-3 and one-hot levels 0-1
    "sort": dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=17, base_resolution=8,
                 per_level_scale=2.5),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(HASH_SPECS))
def test_hash_backward_plain_matches_jax_fast_bwd_on_rays(name, masked):
    """HG2's plain version against ``_encode_fast_bwd`` (through ``jax.vjp``
    of ``hashgrid_encode_fast``, jitted) on ray-ordered samples, where
    neighbouring samples share corner rows on every coarse level: the table
    and position gradients within 2.5e-2 of their largest reference value."""
    js, ts = jh.HashGridSpec(**HASH_SPECS[name]), th.HashGridSpec(**HASH_SPECS[name])
    rs = np.random.RandomState(7)
    table = ((rs.rand(js.n_features_per_level, js.total_params) - 0.5) * 0.2).astype(np.float32)
    x = positions(torch.Generator().manual_seed(8), "ray", N_RAY).numpy()
    ct = rs.randn(N_RAY, js.n_output_dims).astype(np.float32)
    mask = np.array([1.0, 0.5, 0.0, 1.0, 0.25][:js.n_levels], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(jax.jit(lambda t, a: jh.hashgrid_encode_fast(t, a, js, jm)),
                     jnp.asarray(table), jnp.asarray(x))
    jt, jx = vjp(jnp.asarray(ct))
    idx, _ = th.level_corner_indices(ts, _t(x).T.contiguous(), 0)
    assert int(idx.unique().numel()) < idx.numel() // 4  # coarse rows repeat
    dt, dx = th.hashgrid_backward(_t(table), _t(x), _t(ct), ts,
                                  None if mask is None else _t(mask), with_dx=True)
    _close(dt, jt, "d table")
    _close(dx, jx, "d x")
