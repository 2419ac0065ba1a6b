"""The NeuS slice's ops in the port against the JAX package, fed the same
numpy inputs (small widths: CP C=16, F=8, R in {16, 64}): the plain versions
of the CP product kernels (K5/K6, ``cp_product``) and of the product with its
Jacobian and basis (K9/K10, ``cp_product_jac_basis``) against the Pallas
kernels in interpret mode, the autograd Functions and ``cp_encode`` /
``cp_encode_with_jac`` against ``jax.grad``, sphere init, weight norm and
Softplus(100) in the MLP, the alpha compositing weights, the distortion loss
and the NeuS variance and alpha.

Tolerances: residuals bit for bit; enc, jac and prod within 1e-5 of the
largest reference value (the same bf16 operands and roundings, f32 sums in
another order); gradients within 2.5e-2, the JAX kernel tests' tolerance
(tests/test_cp_mlp_pallas.py:83): the backward scatters and the projections
sum in another order, and a sum near a bf16 rounding boundary may round the
other way. Fp32 ops (the MLP, compositing, losses) within 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.ops import cp as j_cp
from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu.ops import mlp as j_mlp
from instant_nsr_pl_tpu.ops import rendering as j_rend
from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
from instant_nsr_pl_tpu_torch.ops import cp as t_cp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import mlp as t_mlp
from instant_nsr_pl_tpu_torch.ops import rendering as t_rend
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

C, F = 16, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(tree, grad=False):
    params = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))
    if grad:
        for _, t in named_leaves(params):
            t.requires_grad_(True)
    return params


def _close(got, ref, rel=2.5e-2, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def _inputs(res, n, seed):
    """Three (R, C) tables, a (C, F) basis and (3, N) coordinates with
    out-of-range values, exact 0, 1 and 0.5, and every knot (as
    tests/test_cp_pallas.py:17-29)."""
    rs = np.random.RandomState(seed)
    lines = [(rs.randn(res, C) * 0.1).astype(np.float32) for _ in range(3)]
    basis = (rs.randn(C, F) / np.sqrt(C)).astype(np.float32)
    u3 = rs.uniform(-0.05, 1.05, (3, n)).astype(np.float32)
    u3[:, 0], u3[:, 1], u3[:, 2] = 0.0, 1.0, 0.5
    k = min(res, n - 3)
    knots = (np.arange(res, dtype=np.float32) / np.float32(res - 1))[:k]
    u3[0, 3:3 + k] = knots
    u3[1, 3:3 + k] = knots[::-1]
    u3[2, 3:3 + k] = np.roll(knots, 5)
    u3[:, -1], u3[:, -2] = -0.03, 1.04
    return lines, basis, u3


CASES = [(16, 300), (16, 77), (64, 300), (64, 77)]


@pytest.mark.parametrize("res,n", CASES)
def test_cp_product_plain_matches_pallas(res, n):
    """K5/K6 plain versions against _cp_product_fwd_impl / _cp_product_bwd:
    vsave bit for bit, prod within 1e-5, the table and coordinate gradients
    within 2.5e-2; du is zero outside [0, 1]."""
    lines, _, u3 = _inputs(res, n, seed=res + n)
    jl = [jnp.asarray(a) for a in lines]
    prod, vsave = j_cpp._cp_product_fwd_impl(*jl, jnp.asarray(u3), res)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    t_prod, t_vsave = t_cpp.cp_product_plain(stack, _t(u3), res, save_residuals=True)
    np.testing.assert_array_equal(t_vsave.float().numpy(),
                                  np.asarray(vsave[:, :, :n]).astype(np.float32))
    _close(t_prod, prod, rel=1e-5)
    dprod = np.random.RandomState(n).randn(C, n).astype(np.float32)
    ref = j_cpp._cp_product_bwd(res, (*jl, jnp.asarray(u3), vsave), jnp.asarray(dprod))
    dlines, du = t_cpp.cp_product_backward_plain(stack, _t(u3), t_vsave, _t(dprod), res)
    for ax in range(3):
        _close(dlines[ax], ref[ax], what=f"d line {ax}")
    _close(du, ref[3], what="du")
    outside = (u3 < 0) | (u3 > 1)
    assert outside.any() and float(du[torch.from_numpy(outside)].abs().max()) == 0.0


@pytest.mark.parametrize("res,n", CASES)
def test_cp_jac_basis_plain_matches_pallas(res, n):
    """K9/K10 plain versions against _cp_jacb_fwd_impl / _cp_jacb_bwd: vsave
    and gdsave bit for bit, enc and jac within 1e-5, the gradients of the
    tables, the coordinates and the basis within 2.5e-2."""
    lines, basis, u3 = _inputs(res, n, seed=2 * res + n)
    jl = [jnp.asarray(a) for a in lines]
    enc, jac, vsave, gdsave = j_cpp._cp_jacb_fwd_impl(*jl, jnp.asarray(basis),
                                                      jnp.asarray(u3), res)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    bas = _t(basis).to(torch.bfloat16)
    t_enc, t_jac, t_v, t_gd = t_cpp.cp_product_jac_basis_plain(stack, bas, _t(u3), res,
                                                               save_residuals=True)
    for got, ref in ((t_v, vsave), (t_gd, gdsave)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref[:, :, :n]).astype(np.float32))
    _close(t_enc, enc, rel=1e-5, what="enc")
    _close(t_jac, jac, rel=1e-5, what="jac")
    rs = np.random.RandomState(n + 1)
    denc = rs.randn(F, n).astype(np.float32)
    djac = rs.randn(3, F, n).astype(np.float32)
    ref = j_cpp._cp_jacb_bwd(res, (*jl, jnp.asarray(basis), jnp.asarray(u3), vsave, gdsave),
                             (jnp.asarray(denc), jnp.asarray(djac)))
    dlines, du, dbasis = t_cpp.cp_product_jac_basis_backward_plain(
        _t(u3), t_v, t_gd, _t(denc), _t(djac), bas, res)
    for ax in range(3):
        _close(dlines[ax], ref[ax], what=f"d line {ax}")
    _close(dbasis, ref[3], what="d basis")
    _close(du, ref[4], what="du")
    assert float(du[torch.from_numpy((u3 < 0) | (u3 > 1))].abs().max()) == 0.0


def test_cp_product_function_matches_jax_grad():
    """The cp_product autograd Function (K5 training mode -> K6 plain on the
    CPU) against jax.grad of cp_pallas.cp_product: gradients of the three
    tables and of the coordinates; without grad the op takes the eval path
    and gives the same product."""
    res, n = 16, 129
    lines, _, u3 = _inputs(res, n, seed=5)
    ct = np.random.RandomState(6).randn(C, n).astype(np.float32)
    ref = jax.grad(lambda a, b, c, u: (j_cpp.cp_product(a, b, c, u, res) * ct).sum(),
                   argnums=(0, 1, 2, 3))(*[jnp.asarray(a) for a in lines], jnp.asarray(u3))
    tl = [_t(a).requires_grad_(True) for a in lines]
    tu = _t(u3).requires_grad_(True)
    prod = t_cpp.cp_product(*tl, tu, res)
    (prod * _t(ct)).sum().backward()
    for got, r in zip([*tl, tu], ref):
        _close(got.grad, r)
    with torch.no_grad():
        assert torch.equal(t_cpp.cp_product(*tl, tu, res), prod.detach())
    tu2 = _t(u3)  # coordinates without grad: no du is returned
    prod2 = t_cpp.cp_product(*tl, tu2, res)
    prod2.sum().backward()
    assert tu2.grad is None


def test_cp_jac_basis_function_matches_jax_grad():
    """The cp_product_jac_basis Function (K9 -> K10 plain) against jax.grad
    through cp_pallas.cp_product_jac_basis, with cotangents on both enc and
    jac; the backward is first-order only."""
    res, n = 64, 129
    lines, basis, u3 = _inputs(res, n, seed=7)
    rs = np.random.RandomState(8)
    ct_e = rs.randn(F, n).astype(np.float32)
    ct_j = rs.randn(3, F, n).astype(np.float32)

    def loss(a, b, c, bb, u):
        e, j = j_cpp.cp_product_jac_basis(a, b, c, bb, u, res)
        return (e * ct_e).sum() + (j * ct_j).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in lines], jnp.asarray(basis), jnp.asarray(u3))
    tl = [_t(a).requires_grad_(True) for a in lines]
    tb = _t(basis).requires_grad_(True)
    tu = _t(u3).requires_grad_(True)
    enc, jac = t_cpp.cp_product_jac_basis(*tl, tb, tu, res)
    ((enc * _t(ct_e)).sum() + (jac * _t(ct_j)).sum()).backward()
    for got, r in zip([*tl, tb, tu], ref):
        _close(got.grad, r)
    with torch.no_grad():
        e2, j2 = t_cpp.cp_product_jac_basis(*tl, tb, tu, res)
    assert torch.equal(e2, enc.detach()) and torch.equal(j2, jac.detach())


@pytest.mark.parametrize("impl", ["fast", "xla"])
def test_cp_encode_matches_jax(impl):
    """cp_encode (impl 'fast' = JAX 'pallas', and 'xla') on two scales:
    values within 1e-5, gradients of every table and basis within 2.5e-2."""
    spec = j_cp.CPSpec(n_components=C, resolutions=(16, 48), n_features=F)
    params = j_cp.cp_init(jax.random.PRNGKey(1), spec)
    x = np.random.RandomState(2).uniform(-0.02, 1.02, (257, 3)).astype(np.float32)
    j_impl = "pallas" if impl == "fast" else "xla"
    ref = j_cp.cp_encode(params, jnp.asarray(x), spec, impl=j_impl)
    g_ref = jax.grad(lambda p: (j_cp.cp_encode(p, jnp.asarray(x), spec, impl=j_impl) ** 2).sum())(
        params)
    tp = _carry(params, grad=True)
    t_spec = t_cp.CPSpec(n_components=C, resolutions=(16, 48), n_features=F)
    out = t_cp.cp_encode(tp, _t(x), t_spec, impl=impl)
    _close(out, ref, rel=1e-5)
    (out**2).sum().backward()
    for key, t in named_leaves(tp):
        _close(t.grad, g_ref[key], what=key)


@pytest.mark.parametrize("impl", ["fast", "xla"])
def test_cp_encode_with_jac_matches_jax(impl):
    """cp_encode_with_jac: (enc (N, E), jac (3, N, E)) within 1e-5 of the
    JAX package's, and, for the fast path, the gradients of an eikonal-style
    loss on jac plus a loss on enc within 2.5e-2."""
    spec = j_cp.CPSpec(n_components=C, resolutions=(16, 48), n_features=F)
    params = j_cp.cp_init(jax.random.PRNGKey(3), spec)
    x = np.random.RandomState(4).uniform(0.0, 1.0, (96, 3)).astype(np.float32)
    w = np.random.RandomState(5).randn(spec.n_output_dims).astype(np.float32)
    j_impl = "pallas" if impl == "fast" else "xla"

    def loss(p):
        enc, jac = j_cp.cp_encode_with_jac(p, jnp.asarray(x), spec, impl=j_impl)
        g = jnp.einsum("e,ane->na", w, jac)
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2) + (enc @ w).mean()

    # the composed twin compiles (jacfwd of it is slow op by op); the
    # interpret-mode kernels run eagerly
    jit = jax.jit if impl == "xla" else (lambda f: f)
    enc, jac = jit(lambda p: j_cp.cp_encode_with_jac(p, jnp.asarray(x), spec, impl=j_impl))(
        params)
    tp = _carry(params, grad=True)
    t_spec = t_cp.CPSpec(n_components=C, resolutions=(16, 48), n_features=F)
    t_enc, t_jac = t_cp.cp_encode_with_jac(tp, _t(x), t_spec, impl=impl)
    _close(t_enc, enc, rel=1e-5, what="enc")
    _close(t_jac, jac, rel=1e-5, what="jac")
    g = torch.einsum("e,ane->na", _t(w), t_jac)
    t_loss = ((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).mean() + (t_enc @ _t(w)).mean()
    t_loss.backward()
    g_ref = jit(jax.grad(loss))(params)
    for key, t in named_leaves(tp):
        _close(t.grad, g_ref[key], what=key)


def _mlp_specs(**kw):
    base = dict(dim_in=35, dim_out=13, n_neurons=32, n_hidden_layers=2, activation="ReLU",
                sphere_init=True, sphere_init_radius=0.5, weight_norm=True, precision="fp32")
    base.update(kw)
    return j_mlp.MLPSpec(**base), t_mlp.MLPSpec(**base)


def test_sphere_init_statistics():
    """Sphere init (no weight norm): the first layer is zero beyond the 3
    xyz rows, the last layer's bias is -r and its weights sit at
    sqrt(pi)/sqrt(d_in) with a 1e-4 spread, the hidden layer's spread is
    sqrt(2)/sqrt(d_out)."""
    _, spec = _mlp_specs(n_neurons=256, weight_norm=False)
    layers = t_mlp.mlp_init(torch.Generator().manual_seed(0), spec)
    first, hidden, last = layers
    assert float(first["w"][3:].abs().max()) == 0.0 and float(first["w"][:3].abs().max()) > 0
    assert torch.equal(last["b"], torch.full((13,), -0.5))
    assert float(last["w"].mean()) == pytest.approx(np.sqrt(np.pi) / np.sqrt(256), rel=1e-3)
    assert float(last["w"].std()) == pytest.approx(1e-4, rel=0.1)
    assert float(hidden["w"].std()) == pytest.approx(np.sqrt(2.0) / 16.0, rel=0.05)
    assert float(first["w"][:3].std()) == pytest.approx(np.sqrt(2.0) / 16.0, rel=0.1)
    _, spec_wn = _mlp_specs()
    wn = t_mlp.mlp_init(torch.Generator().manual_seed(0), spec_wn)
    assert sorted(wn[0]) == ["b", "g", "v"]
    torch.testing.assert_close(wn[1]["g"], torch.linalg.norm(wn[1]["v"], dim=0))


def test_weight_norm_softplus_mlp_matches_jax():
    """The fp32 SDF MLP with weight norm and sphere init (hidden activation
    ReLU in the config, Softplus(100) because of sphere init) on transplanted
    parameters: values, parameter gradients and the forward-mode tangents
    (mlp_apply_jvp against jax.jvp) within 1e-5 relative."""
    j_spec, t_spec = _mlp_specs()
    params = j_mlp.mlp_init(jax.random.PRNGKey(0), j_spec)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32), params)
    x = rs.randn(64, 35).astype(np.float32) * 0.5
    tang = rs.randn(3, 64, 35).astype(np.float32)
    ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: (j_mlp.mlp_apply(p, jnp.asarray(x), j_spec) ** 2).sum()))(params)
    ref = j_mlp.mlp_apply(params, jnp.asarray(x), j_spec)
    j_tan = jax.jit(jax.vmap(lambda t: jax.jvp(lambda v: j_mlp.mlp_apply(params, v, j_spec),
                                                (jnp.asarray(x),), (t,))[1]))(jnp.asarray(tang))
    tp = _carry(params, grad=True)
    out = t_mlp.mlp_apply(tp, _t(x), t_spec)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    relu = t_mlp.mlp_apply(tp, _t(x), t_mlp.MLPSpec(**{**t_spec.__dict__, "sphere_init": False}))
    assert not torch.allclose(relu, out)  # sphere init switched the activation
    (out**2).sum().backward()
    for key, t in named_leaves(tp):
        r = np.asarray(dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_ref)))[key])
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4, atol=1e-5 * np.abs(r).max(),
                                   err_msg=key)
    out2, tout = t_mlp.mlp_apply_jvp(tp, _t(x), t_spec, _t(tang))
    torch.testing.assert_close(out2, out)
    for k in range(3):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(j_tan[k]), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(j_tan[k])).max())


def _packed(rs, n_rays=6, per=9):
    """A packed, ray-sorted buffer with padding at the tail."""
    ray = np.repeat(np.arange(n_rays), per)
    cap = ray.size + 7
    ray = np.concatenate([ray, np.full(7, n_rays - 1)]).astype(np.int32)
    valid = np.arange(cap) < n_rays * per - 3
    return cap, ray, valid


def test_render_weight_from_alpha_and_distortion_match_jax():
    """render_weight_from_alpha and distortion_loss on a packed buffer:
    values within 1e-5 relative, gradients with respect to alpha / weights,
    midpoints and intervals within 1e-5 relative of their largest value."""
    rs = np.random.RandomState(3)
    cap, ray, valid = _packed(rs)
    alpha = rs.uniform(0.0, 0.9, cap).astype(np.float32)
    alpha[5] = 0.0
    ct = rs.randn(cap).astype(np.float32)
    mids = np.sort(rs.uniform(0.5, 3.0, cap)).astype(np.float32)
    ints = rs.uniform(0.001, 0.01, cap).astype(np.float32)
    jv = jnp.asarray(valid)
    jr = jnp.asarray(ray)

    w_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda a: (j_rend.render_weight_from_alpha(a, jr, jv) * ct).sum()))(jnp.asarray(alpha))
    ta = _t(alpha).requires_grad_(True)
    tw = t_rend.render_weight_from_alpha(ta, _t(ray).long(), _t(valid))
    (tw * _t(ct)).sum().backward()
    np.testing.assert_allclose(float((tw * _t(ct)).sum().detach()), float(w_ref), rtol=1e-5)
    _close(ta.grad, g_ref, rel=1e-5)
    weights = np.asarray(j_rend.render_weight_from_alpha(jnp.asarray(alpha), jr, jv))

    def j_dist(w, m, i):
        return j_rend.distortion_loss(w, m, i, jr, jv, n_rays=6)

    d_ref, d_grads = jax.jit(jax.value_and_grad(j_dist, argnums=(0, 1, 2)))(
        jnp.asarray(weights), jnp.asarray(mids), jnp.asarray(ints))
    tins = [_t(a).requires_grad_(True) for a in (weights, mids, ints)]
    d = t_rend.distortion_loss(*tins, _t(ray).long(), _t(valid), n_rays=6)
    d.backward()
    assert float(d.detach()) == pytest.approx(float(d_ref), rel=1e-5)
    for t, r in zip(tins, d_grads):
        _close(t.grad, r, rel=1e-5)


def test_variance_and_alpha_match_jax():
    """VarianceNetwork.inv_s with modulation before and after its start and
    NeuSModel.get_alpha with cosine annealing: values within 1e-6 relative
    and the alpha gradients within 1e-5 of their largest value."""
    from instant_nsr_pl_tpu.models import neus as j_neus
    from instant_nsr_pl_tpu_torch.models import neus as t_neus

    vcfg = {"init_val": 0.3, "modulate": True, "mod_start_steps": 100,
            "reach_max_steps": 1000, "max_inv_s": 500.0}
    j_var = j_neus.VarianceNetwork(j_config(vcfg))
    t_var = t_neus.VarianceNetwork(j_config(vcfg))
    for value, step, prev in ((0.3, 50, 20.0), (0.5, 400, 30.0), (0.7, 900, 30.0)):
        ref = j_var.inv_s({"variance": jnp.float32(value)}, step=step, prev_inv_s=jnp.float32(prev))
        got = t_var.inv_s({"variance": torch.tensor(value)}, step=step,
                          prev_inv_s=torch.tensor(prev))
        assert float(got) == pytest.approx(float(ref), rel=1e-6), (value, step)

    rs = np.random.RandomState(9)
    n = 200
    sdf = rs.randn(n).astype(np.float32) * 0.05
    normal = rs.randn(n, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    dirs = rs.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dists = rs.uniform(0.001, 0.01, n).astype(np.float32)
    ct = rs.randn(n).astype(np.float32)
    model = t_neus.NeuSModel.__new__(t_neus.NeuSModel)
    for car in (0.0, 0.3, 1.0):
        def j_alpha(s, nn):
            return (j_neus.NeuSModel.get_alpha(None, jnp.float32(64.0), jnp.float32(car), s, nn,
                                               jnp.asarray(dirs), jnp.asarray(dists)) * ct).sum()

        ref = j_neus.NeuSModel.get_alpha(None, jnp.float32(64.0), jnp.float32(car),
                                         jnp.asarray(sdf), jnp.asarray(normal),
                                         jnp.asarray(dirs), jnp.asarray(dists))
        gs, gn = jax.grad(j_alpha, argnums=(0, 1))(jnp.asarray(sdf), jnp.asarray(normal))
        ts, tn = _t(sdf).requires_grad_(True), _t(normal).requires_grad_(True)
        alpha = model.get_alpha(torch.tensor(64.0), car, ts, tn, _t(dirs), _t(dists))
        np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
        (alpha * _t(ct)).sum().backward()
        _close(ts.grad, gs, rel=1e-5)
        _close(tn.grad, gn, rel=1e-5)
