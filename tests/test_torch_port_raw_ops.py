"""The raw-product CP encoding (``n_features: 0``) in the port against the JAX
package, fed the same numpy inputs at small widths (CP C=16): the plain
versions of the CP product-with-Jacobian kernels (K7/K8, ``cp_product_jac``)
against the Pallas kernels in interpret mode, the autograd Function and
``cp_encode_with_jac`` against ``jax.grad``, and a raw-CP ``VolumeSDF`` (sdf,
gradient, features and the second-order gradients of an eikonal loss) on the
jac path against the JAX package's.

Tolerances (tests/test_cp_pallas.py:100-161): residuals bit for bit; prod and
jac within 6e-3 of the largest reference value; table gradients within
1.2e-2 and coordinate gradients within 8e-3 (bf16 scatter operands, f32 sums
in another order). The SDF values within 1e-4 relative, the SDF gradient within
2e-3 and the parameter gradients within 2e-3 of their largest reference value
plus 1e-2 relative (tests/test_geometry_jac.py:152-172).

The JAX kernels take their diff-hot operand over the table padded to a
multiple of 8 rows, so where clip(u) = 1 and R is not such a multiple their
diff-hot derivative runs towards the zero pad; the port keeps the per-scale
convention. R = 20 is compared away from clip(u) = 1."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instant_nsr_pl_tpu.models  # noqa: F401  (register)
import instant_nsr_pl_tpu_torch.models  # noqa: F401  (register)
from instant_nsr_pl_tpu import registry as j_reg
from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.ops import cp as j_cp
from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu_torch import registry as t_reg
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models.network_utils import (
    CPEncoding,
    make_trainable,
    named_leaves,
)
from instant_nsr_pl_tpu_torch.ops import cp as t_cp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

C = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _inputs(res, n, seed, with_one=True):
    """Three (R, C) tables and (3, N) coordinates with exact 0 and 0.5, every
    knot, values below 0 and, ``with_one``, exact 1 and values above 1
    (else those move to 0.999)."""
    rs = np.random.RandomState(seed)
    lines = [(rs.randn(res, C) * 0.1).astype(np.float32) for _ in range(3)]
    u3 = rs.uniform(-0.05, 1.05, (3, n)).astype(np.float32)
    u3[:, 0], u3[:, 1], u3[:, 2] = 0.0, 0.5, 0.25
    k = res - 1 if not with_one else res  # knot R - 1 is u = 1
    knots = (np.arange(res, dtype=np.float32) / np.float32(res - 1))[:k]
    u3[0, 3:3 + k] = knots
    u3[1, 3:3 + k] = knots[::-1]
    u3[2, 3:3 + k] = np.roll(knots, 5)
    u3[:, -1], u3[:, -2], u3[:, -3] = -0.03, 1.04, 1.0
    if not with_one:  # clip(u) = 1 nowhere
        u3 = np.where(u3 >= 1.0, np.float32(0.999), u3)
    return lines, u3


CASES = [(24, 500, True), (64, 500, True), (64, 131, True), (20, 499, False)]


@pytest.mark.parametrize("res,n,with_one", CASES)
def test_cp_product_jac_plain_matches_pallas(res, n, with_one):
    """K7/K8 plain versions against _cp_product_jac_fwd_impl /
    _cp_product_jac_bwd: vsave and gdsave bit for bit, prod and jac within
    6e-3, the table gradients within 1.2e-2 and du within 8e-3; du is zero
    outside [0, 1]."""
    lines, u3 = _inputs(res, n, seed=res + n, with_one=with_one)
    jl = [jnp.asarray(a) for a in lines]
    prod, jac, vsave, gdsave = j_cpp._cp_product_jac_fwd_impl(*jl, jnp.asarray(u3), res)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    t_prod, t_jac, t_v, t_gd = t_cpp.cp_product_jac_plain(stack, _t(u3), res,
                                                          save_residuals=True)
    for got, ref in ((t_v, vsave), (t_gd, gdsave)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref[:, :, :n]).astype(np.float32))
    _close(t_prod, prod, 6e-3, "prod")
    _close(t_jac, jac, 6e-3, "jac")
    # eval mode: the same outputs, no residuals
    e_prod, e_jac = t_cpp.cp_product_jac_plain(stack, _t(u3), res)
    assert torch.equal(e_prod, t_prod) and torch.equal(e_jac, t_jac)
    rs = np.random.RandomState(n + 1)
    dprod = rs.randn(C, n).astype(np.float32)
    djac = rs.randn(3, C, n).astype(np.float32)
    ref = j_cpp._cp_product_jac_bwd(res, (*jl, jnp.asarray(u3), vsave, gdsave),
                                    (jnp.asarray(dprod), jnp.asarray(djac)))
    dlines, du = t_cpp.cp_product_jac_backward_plain(_t(u3), t_v, t_gd, _t(dprod), _t(djac),
                                                     res)
    assert dlines.shape == (3, res, C) and du.shape == (3, n)
    for ax in range(3):
        _close(dlines[ax], ref[ax], 1.2e-2, f"d line {ax}")
    _close(du, ref[3], 8e-3, "du")
    outside = (u3 < 0) | (u3 > 1)
    assert outside.any() and float(du[torch.from_numpy(outside)].abs().max()) == 0.0


def test_cp_product_jac_function_matches_jax_grad():
    """The cp_product_jac autograd Function (K7 training mode -> K8 plain on
    the CPU) against jax.grad of cp_pallas.cp_product_jac through a loss of
    both outputs; without grad the op takes the eval path (no residuals) and
    gives the same values; the launch counters stay untouched on the CPU."""
    res, n = 24, 257
    lines, u3 = _inputs(res, n, seed=7)
    rs = np.random.RandomState(8)
    ct = rs.randn(C, n).astype(np.float32)
    ctj = rs.randn(3, C, n).astype(np.float32)

    def j_loss(a, b, c, u):
        prod, jac = j_cpp.cp_product_jac(a, b, c, u, res)
        return (prod * ct).sum() + (jac * ctj).sum()

    jl = [jnp.asarray(a) for a in lines]
    g_ref = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*jl, jnp.asarray(u3))
    tl = [_t(a).requires_grad_(True) for a in lines]
    tu = _t(u3).requires_grad_(True)
    launches = (t_cpp.cp_product_jac.launches, t_cpp.cp_product_jac_backward.launches)
    prod, jac = t_cpp.cp_product_jac(*tl, tu, res)
    ((prod * _t(ct)).sum() + (jac * _t(ctj)).sum()).backward()
    assert (t_cpp.cp_product_jac.launches, t_cpp.cp_product_jac_backward.launches) == launches
    for ax in range(3):
        _close(tl[ax].grad, g_ref[ax], 1.2e-2, f"d line {ax}")
    _close(tu.grad, g_ref[3], 8e-3, "du")
    with torch.no_grad():
        e_prod, e_jac = t_cpp.cp_product_jac(*tl, tu, res)
    assert torch.equal(e_prod, prod.detach()) and torch.equal(e_jac, jac.detach())


def _raw_spec_params(resolutions, seed):
    spec_j = j_cp.CPSpec(C, resolutions, 0)
    params = j_cp.cp_init(jax.random.PRNGKey(seed), spec_j)
    return spec_j, t_cp.CPSpec(C, resolutions, 0), params


def test_cp_encode_with_jac_raw_matches_pallas():
    """cp_encode_with_jac with n_features: 0 (one cp_product_jac per scale,
    the scales concatenated) against the JAX package's impl="pallas": the
    (N, 2C) encoding and the (3, N, 2C) Jacobian within 6e-3, and the table
    gradients of a loss of both within 1.2e-2. The raw tree has no basis."""
    spec_j, spec_t, params = _raw_spec_params((24, 64), seed=3)
    assert not any(k.startswith("basis") for k in params)
    x = np.random.RandomState(4).uniform(0.0, 0.999, (333, 3)).astype(np.float32)
    rs = np.random.RandomState(5)
    ct = rs.randn(333, 2 * C).astype(np.float32)
    ctj = rs.randn(3, 333, 2 * C).astype(np.float32)

    def j_loss(p):
        e, j = j_cp.cp_encode_with_jac(p, jnp.asarray(x), spec_j, impl="pallas")
        return (e * ct).sum() + (j * ctj).sum(), (e, j)

    (_, (enc, jac)), g_ref = jax.value_and_grad(j_loss, has_aux=True)(params)
    tp = make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))))
    assert sorted(tp) == sorted(params)
    t_enc, t_jac = t_cp.cp_encode_with_jac(tp, _t(x), spec_t, impl="fast")
    _close(t_enc, enc, 6e-3, "enc")
    _close(t_jac, jac, 6e-3, "jac")
    ((t_enc * _t(ct)).sum() + (t_jac * _t(ctj)).sum()).backward()
    for key, t in tp.items():
        _close(t.grad, g_ref[key], 1.2e-2, key)


def _raw_geometry():
    return {
        "name": "volume-sdf", "radius": 1.5, "feature_dim": 13, "grad_type": "analytic",
        "analytic_jac": True,
        "xyz_encoding_config": {"otype": "CP", "n_components": C, "resolutions": [16, 48],
                                "n_features": 0, "include_xyz": True, "grad_mode": "fast"},
        "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                               "output_activation": "none", "n_neurons": 32,
                               "n_hidden_layers": 1, "sphere_init": True,
                               "sphere_init_radius": 0.5, "weight_norm": True},
    }


def _sdf_loss(out):
    sdf, grad, feat = out
    lib = torch if torch.is_tensor(sdf) else jnp
    norm = torch.linalg.norm(grad, dim=-1) if lib is torch else jnp.linalg.norm(grad, axis=-1)
    return ((norm - 1.0) ** 2).mean() + (feat ** 2).mean() + (sdf ** 2).mean()


def test_raw_volume_sdf_matches_jax():
    """A raw-CP VolumeSDF (E = 2 x 16 products + 3 xyz = 35 inputs) on the jac
    path: the port's K7/K8 plain versions against the JAX package's Pallas
    kernels in interpret mode. sdf within 1e-4, the SDF gradient within 2e-3
    and the features within 1e-4 of their largest reference value, every
    parameter gradient of an eikonal + feature + sdf loss (second order
    through the fp32 MLP's tangents) within 1e-2 relative + 2e-3 of the
    largest; the port's tree transplants from the JAX one and has no basis;
    under no_grad the values repeat."""
    cfg = _raw_geometry()
    j_geo = j_reg.models.make("volume-sdf", j_config(copy.deepcopy(cfg)))
    t_geo = t_reg.models.make("volume-sdf", t_config(copy.deepcopy(cfg)))
    assert t_geo.use_jac and j_geo.use_jac
    assert t_geo.encoding.n_output_dims == j_geo.encoding.n_output_dims == 2 * C + 3
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.05) * np.asarray(rs.randn(*np.shape(a)), np.float32),
        j_geo.init(jax.random.PRNGKey(0)))
    t_init = t_geo.init(torch.Generator().manual_seed(0))
    assert sorted(t_init["encoding"]["cp"]) == sorted(params["encoding"]["cp"])
    assert not any(k.startswith("basis") for k in params["encoding"]["cp"])
    x = np.random.RandomState(1).uniform(-1.3, 1.3, (96, 3)).astype(np.float32)
    # eager: the jac path hits this XLA CPU build's missing bf16 x bf16 -> f32
    # dot under jit
    ref = j_geo.apply(params, jnp.asarray(x))
    g_ref = jax.grad(lambda p: _sdf_loss(j_geo.apply(p, jnp.asarray(x))))(params)
    tp = make_trainable(params_from_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "cpu"))
    out = t_geo.apply(tp, torch.from_numpy(x))
    for got, r, what, rel in zip(out, ref, ("sdf", "grad", "feature"), (1e-4, 2e-3, 1e-4)):
        _close(got, r, rel, what)
    _sdf_loss(out).backward()
    g_ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    scale = max(float(np.abs(v).max()) for v in g_ref.values())
    for key, t in named_leaves(tp):
        assert t.grad is not None and float(t.grad.abs().max()) > 0, key
        np.testing.assert_allclose(t.grad.numpy(), g_ref[key], rtol=1e-2, atol=2e-3 * scale,
                                   err_msg=key)
    with torch.no_grad():
        ev = t_geo.apply(tp, torch.from_numpy(x))
    for a, b in zip(ev, out):
        torch.testing.assert_close(a, b.detach(), rtol=1e-5, atol=1e-6)


def test_raw_cp_encoding_accepts_fast_mode():
    """CPEncoding with n_features: 0 under grad_mode: fast: apply and
    apply_with_jac give the JAX package's shapes, (N, S*C) and (3, N, S*C)."""
    enc = CPEncoding(3, {"otype": "CP", "n_components": C, "resolutions": [8, 24],
                         "n_features": 0})
    assert enc.grad_mode == "fast" and enc.n_output_dims == 2 * C
    params = enc.init(torch.Generator().manual_seed(0))
    assert sorted(params["cp"]) == [f"line_{s}_{a}" for s in range(2) for a in range(3)]
    x = torch.rand(5, 7, 3, generator=torch.Generator().manual_seed(1))
    feat, jac = enc.apply_with_jac(params, x)
    assert feat.shape == (5, 7, 2 * C) and jac.shape == (3, 5, 7, 2 * C)
    torch.testing.assert_close(feat, enc.apply(params, x), rtol=0, atol=1e-6)
