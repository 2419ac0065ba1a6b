"""The stacked-scales CP ops of the port against the JAX package, fed the same
numpy inputs at the JAX tests' small spec (CP C=16, R=(17, 65), F=8; MLP
16->32->16 with 1 and 2 hidden layers; N = 515; x in [-0.1, 1.1]^3,
tests/test_cp_mlp_pallas.py:358-379): the fine line table and the
block-diagonal basis, the plain versions of the stacked density kernels
(K13/K14, ``cp_mlp_apply_stacked``) and of the stacked product with its
Jacobian (K11/K12, ``cp_jac_basis_stacked``) against the Pallas kernels in
interpret mode, their autograd Functions against ``jax.grad`` over several
sample blocks, the eikonal-style second-order loss through
``cp_encode_with_jac(stacked=True)``, the routing of ``stack_scales``, and the
carry of a JAX stacked parameter tree.

Tolerances: forwards within 2e-2 of the largest reference value and gradients
within 2.5e-2 (tests/test_cp_mlp_pallas.py: bf16 operands, f32 sums in
another order); residuals bit for bit.

The JAX Pallas Jacobian kernels take their diff-hot operand over the table
padded to a multiple of 8 rows (``_diffhot(rows, ...)``, cp_pallas.py:776):
at p = R - 1, i.e. u >= 1, with R = 65 the derivative row pair is (R - 1, the
zero pad) instead of (R - 2, R - 1). It is multiplied by d clip(u)/du, which
is 0 for u > 1, so only exactly u = 1 sees it. The port keeps the per-scale
convention of ``_diffhot``'s docstring and the XLA path (i0 = min(floor(p),
R - 2)); the comparisons below keep u away from exactly 1, compare gdsave
where u < 1, and a separate test holds the stacked op at u = 1 against the
port's per-scale op."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.ops import cp as j_cp
from instant_nsr_pl_tpu.ops import cp_mlp_pallas as j_cpm
from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu.ops import mlp as j_mlp
from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
from instant_nsr_pl_tpu_torch.ops import cp as t_cp
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cpm
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import cp_stacked as t_cps
from instant_nsr_pl_tpu_torch.ops import mlp as t_mlp
from instant_nsr_pl_tpu_torch.ops.mlp_common import unpack_mlp_grads
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

C, F, RES = 16, 8, (17, 65)
RMAX = max(RES)
N = 515


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(tree, grad=False):
    params = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))
    if grad:
        for _, t in named_leaves(params):
            t.requires_grad_(True)
    return params


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _specs(c=C, res=RES, f=F):
    return j_cp.CPSpec(c, res, f), t_cp.CPSpec(c, res, f)


def _cp_params(seed, c=C, res=RES, f=F):
    j_spec, _ = _specs(c, res, f)
    return j_cp.cp_init(jax.random.PRNGKey(seed), j_spec)


def _coords(seed, n=N):
    """(n, 3) positions in [-0.1, 1.1] with exact 0, out-of-range values and
    every knot of both scales but u = 1."""
    x = np.random.RandomState(seed).uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    knots = np.concatenate([np.arange(r - 1, dtype=np.float32) / np.float32(r - 1)
                            for r in RES])
    k = knots.size
    x[:k, 0], x[:k, 1], x[:k, 2] = knots, knots[::-1], np.roll(knots, 7)
    x[k] = [0.0, -0.05, 1.05]
    x[x == 1.0] = np.float32(1.0 - 2**-20)
    return x


def _fine_ref(params, spec):
    """JAX's (3, S*C, rpad) bf16 fine stack as the port's (3, R_max, S*C)."""
    rpad = -(-max(spec.resolutions) // 8) * 8
    fine = j_cpp._stack_lines_fine(params, spec, rpad)
    return np.asarray(fine).astype(np.float32)[:, :, :max(spec.resolutions)].transpose(0, 2, 1)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


def test_stackable_and_upsample_match_jax():
    for res in [(17, 65), (129, 2049), (65,), (5, 17, 65), (16, 64), (128, 2048), (17, 64)]:
        j_spec, t_spec = _specs(res=res)
        assert t_cps.stackable(t_spec) == j_cpp.stackable(j_spec), res
    for r, rmax in [(17, 65), (129, 2049), (2, 9)]:
        np.testing.assert_array_equal(t_cps.upsample_matrix(r, rmax),
                                      np.asarray(j_cpp._upsample_matrix(r, rmax)))


@pytest.mark.parametrize("c,res,f", [(16, (17, 65), 8), (64, (129, 2049), 16)])
def test_fine_stack_and_blockdiag_match_jax(c, res, f):
    """The port's row-major fine table against ``_stack_lines_fine``: the
    coarse rows come from an f32 product U @ L rounded to bf16, which the two
    packages may round differently; at most one bf16 ulp apart, and (at these
    seeds) none differs. The block-diagonal basis equal."""
    j_spec, t_spec = _specs(c, res, f)
    params = _cp_params(1, c, res, f)
    tp = _carry(params)
    got = t_cps.stack_lines_fine(tp, t_spec)
    assert got.shape == (3, max(res), len(res) * c) and got.dtype == torch.bfloat16
    ref = _fine_ref(params, j_spec)
    diff = got.float().numpy() != ref
    ulp = np.abs(ref) * 2.0**-7
    assert np.all(np.abs(got.float().numpy() - ref)[diff] <= ulp[diff])
    assert int(diff.sum()) == 0, f"{int(diff.sum())} bf16 entries differ by one ulp"
    bt = t_cps.blockdiag_bt(t_cps.basis_stack(tp, t_spec))
    np.testing.assert_array_equal(bt.float().numpy(),
                                  np.asarray(j_cpp._blockdiag_bt(params, j_spec)).astype(np.float32))


# ---------------------------------------------------------------------------
# K13 / K14: the stacked fused density head
# ---------------------------------------------------------------------------


def _mlp(n_hidden, seed):
    spec = j_mlp.MLPSpec(dim_in=len(RES) * F, dim_out=16, n_neurons=32,
                         n_hidden_layers=n_hidden, activation="ReLU", precision="bf16")
    layers = j_mlp.mlp_init(jax.random.PRNGKey(seed), spec)
    rs = np.random.RandomState(seed)
    layers = [{"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
              for l in layers]
    t_spec = t_mlp.MLPSpec(dim_in=len(RES) * F, dim_out=16, n_neurons=32,
                           n_hidden_layers=n_hidden)
    return spec, t_spec, layers


@pytest.mark.parametrize("n_hidden", [1, 2])
def test_cp_mlp_stacked_plain_matches_pallas(n_hidden):
    """K13 and K14 plain versions against ``_fwd_impl_stacked`` and
    ``_cp_mlp_stacked_bwd``: out within 2e-2, the residuals vsave and hsave
    bit for bit, every parameter gradient within 2.5e-2 (three sample
    blocks of 128 on the JAX side)."""
    j_spec, t_spec = _specs()
    m_spec, tm_spec, layers = _mlp(n_hidden, seed=2)
    params = _cp_params(3)
    x = _coords(4)
    out, (u3p, n, vsave, hsave) = j_cpm._fwd_impl_stacked(params, layers, jnp.asarray(x),
                                                          j_spec, m_spec)
    tp, tl = _carry(params), _carry(layers)
    t_out, t_v, t_h = t_cpm.cp_mlp_stacked_forward_plain(tp, tl, _t(x), t_spec, tm_spec,
                                                         save_residuals=True)
    _close(t_out, out, 2e-2, "out")
    np.testing.assert_array_equal(t_v.float().numpy(), np.asarray(vsave[:, :, :N]).astype(np.float32))
    np.testing.assert_array_equal(t_h.float().numpy(), np.asarray(hsave[:, :, :N]).astype(np.float32))
    assert torch.equal(t_cpm.cp_mlp_stacked_forward_plain(tp, tl, _t(x), t_spec, tm_spec), t_out)

    dout = np.random.RandomState(5).randn(N, 16).astype(np.float32)
    d_cp, d_mlp, dx = j_cpm._cp_mlp_stacked_bwd(
        j_spec, m_spec, (params, layers, u3p, n, vsave, hsave, jnp.asarray(x)), jnp.asarray(dout))
    _, basis, ws, _ = t_cpm.cp_mlp_stacked_operands(tp, tl, t_spec, tm_spec)
    dfine, dbasis, dws, dbs = t_cpm.cp_mlp_stacked_backward_plain(
        _t(x), t_v, t_h, _t(dout), basis, ws, t_spec, tm_spec)
    assert dfine.shape == (3, RMAX, len(RES) * C) and dbasis.shape == (len(RES), C, F)
    lines = t_cps.coarse_line_grads(dfine, t_spec)
    for s in range(len(RES)):
        for ax in range(3):
            _close(lines[f"line_{s}_{ax}"], d_cp[f"line_{s}_{ax}"], 2.5e-2, f"line_{s}_{ax}")
        _close(dbasis[s], d_cp[f"basis_{s}"], 2.5e-2, f"basis_{s}")
    for k, layer in enumerate(unpack_mlp_grads(dws, dbs, [tuple(l["w"].shape) for l in layers])):
        _close(layer["w"], d_mlp[k]["w"], 2.5e-2, f"w{k}")
        _close(layer["b"], d_mlp[k]["b"], 2.5e-2, f"b{k}")
    assert float(np.abs(np.asarray(dx)).max()) == 0.0


@pytest.mark.parametrize("n_hidden", [1, 2])
def test_cp_mlp_stacked_function_matches_jax_grad(n_hidden, monkeypatch):
    """The stacked autograd Function (K13 training mode -> K14 plain on the
    CPU, U^T d fine per coarse scale) against ``jax.grad`` of
    ``cp_mlp_apply_stacked`` with a seeded cotangent and 128-sample blocks:
    every CP and MLP gradient within 2.5e-2; positions get none."""
    monkeypatch.setattr(j_cpm, "_block_n", lambda r: 128)
    j_spec, t_spec = _specs()
    m_spec, tm_spec, layers = _mlp(n_hidden, seed=6)
    params = _cp_params(7)
    x = _coords(8)
    ct = np.random.RandomState(9).randn(N, 16).astype(np.float32)

    def loss(cp_p, mlp_p):
        return jnp.sum(j_cpm.cp_mlp_apply_stacked(cp_p, mlp_p, jnp.asarray(x), j_spec, m_spec) * ct)

    g_cp, g_mlp = jax.grad(loss, argnums=(0, 1))(params, layers)
    tp, tl = _carry(params, grad=True), _carry(layers, grad=True)
    tx = _t(x).requires_grad_(True)
    out = t_cpm.cp_mlp_stacked_forward(tp, tl, tx, t_spec, tm_spec)
    (out * _t(ct)).sum().backward()
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, {"cp": g_cp, "mlp": g_mlp})))
    got = dict(named_leaves({"cp": tp, "mlp": tl}))
    assert sorted(ref) == sorted(got)
    for key, t in got.items():
        _close(t.grad, ref[key], 2.5e-2, key)
        assert float(t.grad.abs().max()) > 0, key
    assert tx.grad is None
    with torch.no_grad():
        assert torch.equal(t_cpm.cp_mlp_stacked_forward(tp, tl, tx, t_spec, tm_spec),
                           out.detach())


# ---------------------------------------------------------------------------
# K11 / K12: the stacked product with its Jacobian and block-diagonal basis
# ---------------------------------------------------------------------------


def test_cp_jac_stacked_plain_matches_pallas(monkeypatch):
    """K11 and K12 plain versions against ``_cp_jacs_fwd_impl`` and
    ``_cp_jacs_bwd`` (the backward over five sample blocks of 128): enc and
    jac within 2e-2, vsave bit for bit and gdsave wherever u < 1, the
    gradients of every line, basis and of u3 within 2.5e-2; d u is zero
    outside [0, 1]."""
    monkeypatch.setattr(j_cpp, "_block_n", lambda r: 128)
    j_spec, t_spec = _specs()
    params = _cp_params(10)
    u3 = _coords(11).T.copy()
    enc, jac, vsave, gdsave = j_cpp._cp_jacs_fwd_impl(params, jnp.asarray(u3), j_spec)
    tp = _carry(params)
    lines, basis = t_cps.stack_lines_fine(tp, t_spec), t_cps.basis_stack(tp, t_spec)
    t_enc, t_jac, t_v, t_gd = t_cps.cp_jac_basis_stacked_plain(lines, basis, _t(u3), RMAX,
                                                               save_residuals=True)
    _close(t_enc, enc, 2e-2, "enc")
    _close(t_jac, jac, 2e-2, "jac")
    np.testing.assert_array_equal(t_v.float().numpy(), np.asarray(vsave[:, :, :N]).astype(np.float32))
    below = np.broadcast_to((u3 < 1.0)[:, None, :], t_gd.shape)
    np.testing.assert_array_equal(t_gd.float().numpy()[below],
                                  np.asarray(gdsave[:, :, :N]).astype(np.float32)[below])

    rs = np.random.RandomState(12)
    denc = rs.randn(len(RES) * F, N).astype(np.float32)
    djac = rs.randn(3, len(RES) * F, N).astype(np.float32)
    d_params, du = j_cpp._cp_jacs_bwd(j_spec, (params, jnp.asarray(u3), vsave, gdsave),
                                      (jnp.asarray(denc), jnp.asarray(djac)))
    dfine, t_du, dbasis = t_cps.cp_jac_basis_stacked_backward_plain(
        _t(u3), t_v, t_gd, _t(denc), _t(djac), basis, RMAX)
    lines_g = t_cps.coarse_line_grads(dfine, t_spec)
    for s in range(len(RES)):
        for ax in range(3):
            _close(lines_g[f"line_{s}_{ax}"], d_params[f"line_{s}_{ax}"], 2.5e-2, f"line_{s}_{ax}")
        _close(dbasis[s], d_params[f"basis_{s}"], 2.5e-2, f"basis_{s}")
    _close(t_du, du, 2.5e-2, "du")
    assert float(t_du[torch.from_numpy((u3 < 0) | (u3 > 1))].abs().max()) == 0.0


def test_cp_jac_stacked_function_matches_jax_grad(monkeypatch):
    """The stacked jac Function (K11 -> K12 plain) against ``jax.grad``
    through ``cp_jac_basis_stacked`` with cotangents on enc and jac: the
    gradients of every line, basis and of u3 within 2.5e-2; without grad the
    op takes the eval path and gives the same values."""
    monkeypatch.setattr(j_cpp, "_block_n", lambda r: 128)
    j_spec, t_spec = _specs()
    params = _cp_params(13)
    u3 = _coords(14, n=300).T.copy()
    rs = np.random.RandomState(15)
    ct_e = rs.randn(len(RES) * F, 300).astype(np.float32)
    ct_j = rs.randn(3, len(RES) * F, 300).astype(np.float32)

    def loss(p, u):
        e, j = j_cpp.cp_jac_basis_stacked(p, u, j_spec)
        return (e * ct_e).sum() + (j * ct_j).sum()

    g_p, g_u = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(u3))
    tp = _carry(params, grad=True)
    tu = _t(u3).requires_grad_(True)
    enc, jac = t_cps.cp_jac_basis_stacked(tp, tu, t_spec)
    ((enc * _t(ct_e)).sum() + (jac * _t(ct_j)).sum()).backward()
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_p)))
    for key, t in named_leaves(tp):
        _close(t.grad, ref[key], 2.5e-2, key)
    _close(tu.grad, g_u, 2.5e-2, "u3")
    with torch.no_grad():
        e2, j2 = t_cps.cp_jac_basis_stacked(tp, tu, t_spec)
    assert torch.equal(e2, enc.detach()) and torch.equal(j2, jac.detach())


def test_cp_jac_stacked_at_u_one_follows_per_scale_convention():
    """At exactly u = 1 (d clip/du = 0.5) the stacked op's enc and jac equal
    the port's per-scale op (K9's plain version at each R_s) within 2e-2:
    both take the derivative between rows R - 2 and R - 1."""
    _, t_spec = _specs()
    tp = _carry(_cp_params(16))
    u3 = np.random.RandomState(17).uniform(0.0, 1.0, (3, 64)).astype(np.float32)
    u3[0, :16] = 1.0
    u3[1, 16:32] = 1.0
    u3[2, 32:48] = 1.0
    enc, jac = t_cp.cp_encode_with_jac(tp, _t(u3.T.copy()), t_spec, impl="fast", stacked=True)
    enc_p, jac_p = t_cp.cp_encode_with_jac(tp, _t(u3.T.copy()), t_spec, impl="fast")
    _close(enc, enc_p.numpy(), 2e-2, "enc")
    _close(jac, jac_p.numpy(), 2e-2, "jac")


def test_cp_encode_with_jac_stacked_eikonal_matches_jax():
    """The eikonal-style second-order loss of tests/test_cp_pallas.py:270-294
    through the port's ``cp_encode_with_jac(stacked=True)`` against the JAX
    package's: enc and jac within 2e-2, every gradient within 2.5e-2."""
    j_spec, t_spec = _specs()
    params = _cp_params(18)
    x = np.random.RandomState(19).uniform(0.0, 1.0, (200, 3)).astype(np.float32)
    w = np.random.RandomState(20).randn(j_spec.n_output_dims).astype(np.float32)

    def eikonal(enc, jac, lib):
        g = lib.einsum("e,ane->na", w if lib is jnp else _t(w), jac)
        norm = jnp.linalg.norm(g, axis=-1) if lib is jnp else torch.linalg.norm(g, dim=-1)
        return ((norm - 1.0) ** 2).mean() + (enc @ (w if lib is jnp else _t(w))).mean()

    enc, jac = j_cp.cp_encode_with_jac(params, jnp.asarray(x), j_spec, impl="pallas", stacked=True)
    g_ref = jax.grad(lambda p: eikonal(*j_cp.cp_encode_with_jac(
        p, jnp.asarray(x), j_spec, impl="pallas", stacked=True), jnp))(params)
    tp = _carry(params, grad=True)
    t_enc, t_jac = t_cp.cp_encode_with_jac(tp, _t(x), t_spec, impl="fast", stacked=True)
    _close(t_enc, enc, 2e-2, "enc")
    _close(t_jac, jac, 2e-2, "jac")
    eikonal(t_enc, t_jac, torch).backward()
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))
    for key, t in named_leaves(tp):
        _close(t.grad, ref[key], 2.5e-2, key)


# ---------------------------------------------------------------------------
# routing and the parameter tree
# ---------------------------------------------------------------------------


def _density_cfg(res=(17, 65)):
    return {
        "name": "volume-density", "radius": 1.0, "feature_dim": 16,
        "density_activation": "trunc_exp", "density_bias": -1,
        "xyz_encoding_config": {"otype": "CP", "n_components": C, "resolutions": list(res),
                                "n_features": F, "grad_mode": "fast", "stack_scales": True},
        "mlp_network_config": {"otype": "FullyFusedMLP", "activation": "ReLU",
                               "output_activation": "none", "n_neurons": 32,
                               "n_hidden_layers": 1},
    }


def _sdf_cfg(res=(17, 65)):
    return {
        "name": "volume-sdf", "radius": 1.0, "feature_dim": 13, "grad_type": "analytic",
        "analytic_jac": True,
        "xyz_encoding_config": {"otype": "CP", "n_components": C, "resolutions": list(res),
                                "n_features": F, "include_xyz": True, "grad_mode": "fast",
                                "stack_scales": True},
        "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU", "n_neurons": 32,
                               "n_hidden_layers": 1, "sphere_init": True,
                               "sphere_init_radius": 0.5, "weight_norm": True},
    }


def test_stacked_routing(monkeypatch):
    """A volume-density with ``stack_scales`` is fused on the stacked op and
    a volume-sdf calls the stacked jac op, each matching the JAX model's
    output within 2e-2; non-nested resolutions raise ValueError ("nested")
    in both packages."""
    import instant_nsr_pl_tpu.models  # noqa: F401  (register)
    import instant_nsr_pl_tpu_torch.models  # noqa: F401  (register)
    from instant_nsr_pl_tpu import registry as j_reg
    from instant_nsr_pl_tpu.models.network_utils import CPEncoding as JCPEncoding
    from instant_nsr_pl_tpu_torch import registry as t_reg
    from instant_nsr_pl_tpu_torch.models import network_utils as t_nu

    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_nu, "cp_mlp_stacked_forward", spy(t_cpm.cp_mlp_stacked_forward))
    monkeypatch.setattr(t_nu, "cp_mlp_forward", spy(t_cpm.cp_mlp_forward))
    monkeypatch.setattr(t_cp, "cp_jac_basis_stacked", spy(t_cps.cp_jac_basis_stacked))
    monkeypatch.setattr(t_cp, "cp_product_jac_basis", spy(t_cpp.cp_product_jac_basis))
    x = np.random.RandomState(21).uniform(-1.0, 1.0, (100, 3)).astype(np.float32)

    j_geo = j_reg.models.make("volume-density", j_config(_density_cfg()))
    t_geo = t_reg.models.make("volume-density", t_config(_density_cfg()))
    assert t_geo.encoding_with_network.fused and j_geo.encoding_with_network.fused
    params = j_geo.init(jax.random.PRNGKey(0))
    ref = j_geo.apply(params, jnp.asarray(x))
    got = t_geo.apply(_carry(params), _t(x))
    assert calls == ["cp_mlp_stacked_forward"]
    for a, b, what in zip(got, ref, ("density", "feature")):
        _close(a, b, 2e-2, what)

    calls.clear()
    j_sdf = j_reg.models.make("volume-sdf", j_config(_sdf_cfg()))
    t_sdf = t_reg.models.make("volume-sdf", t_config(_sdf_cfg()))
    assert t_sdf.use_jac and j_sdf.use_jac
    params = j_sdf.init(jax.random.PRNGKey(1))
    ref = j_sdf.apply(params, jnp.asarray(x))
    got = t_sdf.apply(_carry(params), _t(x))
    assert calls == ["cp_jac_basis_stacked"]
    for a, b, what in zip(got, ref, ("sdf", "grad", "feature")):
        _close(a, b, 2e-2, what)

    bad = {"otype": "CP", "n_components": C, "resolutions": [16, 64], "n_features": F,
           "stack_scales": True}
    with pytest.raises(ValueError, match="nested"):
        t_nu.CPEncoding(3, t_config(bad))
    with pytest.raises(ValueError, match="nested"):
        JCPEncoding(3, j_config(bad))


@pytest.mark.parametrize("c,res,f", [(16, (17, 65), 8), (64, (129, 2049), 16)])
def test_jax_stacked_tree_carries_into_port(c, res, f):
    """A JAX stacked CP encoding's parameters (line_{s}_{ax} (R_s, C),
    basis_{s} (C, F)) carry into the port as a copy: the same keys, shapes
    and values as the port's own init gives, and the same encoding."""
    from instant_nsr_pl_tpu.models.network_utils import CPEncoding as JCPEncoding
    from instant_nsr_pl_tpu_torch.models.network_utils import CPEncoding as TCPEncoding

    cfg = {"otype": "CP", "n_components": c, "resolutions": list(res), "n_features": f,
           "grad_mode": "fast", "stack_scales": True}
    j_enc, t_enc = JCPEncoding(3, j_config(cfg)), TCPEncoding(3, t_config(cfg))
    params = j_enc.init(jax.random.PRNGKey(2))
    carried = _carry(params)
    own = dict(named_leaves(t_enc.init(torch.Generator().manual_seed(0))))
    ref = dict(named_leaves(jax.tree_util.tree_map(np.asarray, params)))
    assert sorted(own) == sorted(ref) == sorted(dict(named_leaves(carried)))
    for key, t in named_leaves(carried):
        assert tuple(own[key].shape) == ref[key].shape == tuple(t.shape), key
        np.testing.assert_array_equal(t.numpy(), ref[key])
    x = np.random.RandomState(3).uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    enc, jac = t_enc.apply_with_jac(carried, _t(x))
    j_e, j_j = j_enc.apply_with_jac(params, jnp.asarray(x))
    _close(enc, j_e, 2e-2, "enc")
    _close(jac, j_j, 2e-2, "jac")
