"""The port's hash encoding with its position Jacobian
(``instant_nsr_pl_tpu_torch/ops/hashgrid.py`` ``hashgrid_encode_with_jac``:
the plain versions of HG3 / HG4 on the CPU) against the JAX package's
(``instant_nsr_pl_tpu/ops/hashgrid.py:767-957``), fed the same seeded numpy
inputs at small sizes with dense and hashed levels; the
``ProgressiveBandHashGrid`` encoding (its level mask and the progressive
finite-difference eps) against the JAX package's; and the transplant of its
table.

Tolerances: the features equal the jitted JAX features to the bit (both round
``x * s + 0.5`` and the corner sum as fused multiply-adds); the Jacobian within
1e-5 of its largest value (the port sums the corners in order, XLA's einsum in
its own); the table gradient and d x within 2.5e-2 of their largest value
against ``jax.vjp`` of the JAX custom VJP (the JAX kernel tests' limit: its
fast path rounds the updates to bf16 on its one-hot matmul levels); against a
JAX dedup spec (the same function from a 27-point lattice per block) the
limits of ``tests/test_hashgrid_jac.py``'s dedup cases. The progressive mask
and eps equal the JAX values (eps to the bit: both raise the float32 scale to
the level in float32)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.models import network_utils as j_nu
from instant_nsr_pl_tpu.ops import hashgrid as jh
from instant_nsr_pl_tpu_torch.models import network_utils as t_nu
from instant_nsr_pl_tpu_torch.ops import hashgrid as th
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, port_layout

# tests/test_hashgrid_jac.py:18: 6 levels, 2^14 rows, levels 0-4 dense, 5 hashed
JAC = dict(n_levels=6, log2_hashmap_size=14, base_resolution=4, per_level_scale=1.5)
# 5 levels, 2^11 rows: levels 0-1 dense, 2-4 hashed
SMALL = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=11, base_resolution=4,
             per_level_scale=1.9)
SPECS = {"jac": JAC, "small": SMALL}
PROGRESSIVE = {"otype": "ProgressiveBandHashGrid", "n_levels": 6, "n_features_per_level": 2,
               "log2_hashmap_size": 14, "base_resolution": 4, "per_level_scale": 1.5,
               "start_level": 2, "start_step": 5, "update_steps": 3}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(kw):
    return jh.HashGridSpec(**kw), th.HashGridSpec(**kw)


def _inputs(spec, n, seed=0):
    """A (F, T) table of order 1000 (``hashgrid_init * 1000``, as the JAX jac
    tests take it), positions away from the box faces, both cotangents."""
    rs = np.random.RandomState(seed)
    table = (rs.rand(spec.n_features_per_level, spec.total_params) - 0.5) * 2e-1
    x = rs.uniform(0.01, 0.99, (n, 3)).astype(np.float32)
    ct_f = rs.randn(n, spec.n_output_dims).astype(np.float32)
    ct_j = rs.randn(3, n, spec.n_output_dims).astype(np.float32)
    return table.astype(np.float32), x, ct_f, ct_j


def _pt(table):
    return torch.from_numpy(np.ascontiguousarray(table.T))


def _mask(spec, masked):
    if not masked:
        return None, None
    m = np.array([1.0, 1.0, 0.5, 0.0, 1.0, 0.0][:spec.n_levels], np.float32)
    return jnp.asarray(m), torch.from_numpy(m)


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_jac_forward_matches_jax(name, masked):
    """feat equal to the jitted JAX features to the bit (and to the plain
    hash encode's), jac within 1e-5 of its largest value, on a ragged N and
    at exact 0 / 1 coordinates."""
    js, ts = _specs(SPECS[name])
    table, x, _, _ = _inputs(js, 1001, seed=1)
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5]]
    jm, tm = _mask(js, masked)
    j_feat, j_jac = jax.jit(lambda t, a: jh.hashgrid_encode_with_jac(t, a, js, jm))(table, x)
    feat, jac = th.hashgrid_encode_with_jac(_pt(table), torch.from_numpy(x), ts, tm)
    np.testing.assert_array_equal(feat.numpy(), np.asarray(j_feat))
    assert torch.equal(feat, th.hashgrid_encode(_pt(table), torch.from_numpy(x), ts, tm))
    _close(jac, j_jac, 1e-5, "jac")
    # a leading batch shape is kept: (..., L*F) and (3, ..., L*F)
    x3 = torch.from_numpy(x[:1000]).reshape(10, 100, 3)
    f3, j3 = th.hashgrid_encode_with_jac(_pt(table), x3, ts, tm)
    assert f3.shape == (10, 100, ts.n_output_dims) and j3.shape == (3, 10, 100, ts.n_output_dims)
    assert torch.equal(j3.reshape(3, 1000, -1), jac[:, :1000])


@functools.lru_cache(maxsize=None)
def _j_vjp_fn(js, masked):
    """jit of the JAX custom VJP's (d table, d x) for both cotangents (one
    compile per spec and mask)."""
    jm = _mask(js, masked)[0]

    def grads(t, a, cf, cj):
        _, vjp = jax.vjp(lambda t, a: jh.hashgrid_encode_with_jac(t, a, js, jm), t, a)
        return vjp((cf, cj))
    return jax.jit(grads)


def _j_vjp(js, masked, table, x, ct_f, ct_j):
    return _j_vjp_fn(js, masked)(*(jnp.asarray(v) for v in (table, x, ct_f, ct_j)))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_jac_backward_matches_jax(name, masked):
    """The table gradient and d x from both cotangents against jax.vjp of
    the JAX custom VJP within 2.5e-2 of their largest value; the mixed
    second-derivative term of d x on its own (ct_feat = 0) too, and the
    plain version through the autograd op: the table gets the gradient, x
    one only when it requires grad."""
    js, ts = _specs(SPECS[name])
    table, x, ct_f, ct_j = _inputs(js, 700, seed=2)
    jm, tm = _mask(js, masked)
    for cf in (ct_f, np.zeros_like(ct_f)):
        jt, jx = _j_vjp(js, masked, table, x, cf, ct_j)
        dt, dx = th.hashgrid_jac_backward_plain(_pt(table), torch.from_numpy(x),
                                                torch.from_numpy(cf), torch.from_numpy(ct_j),
                                                ts, tm, with_dx=True)
        _close(dt, port_layout("table", jt), 2.5e-2, "d table")
        _close(dx, jx, 2.5e-2, "d x")
        assert float(dx.abs().max()) > 0
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    feat, jac = th.hashgrid_encode_with_jac(t, a, ts, tm)
    ((feat * torch.from_numpy(ct_f)).sum() + (jac * torch.from_numpy(ct_j)).sum()).backward()
    ref_t, ref_x = th.hashgrid_jac_backward_plain(_pt(table), torch.from_numpy(x),
                                                  torch.from_numpy(ct_f),
                                                  torch.from_numpy(ct_j), ts, tm, with_dx=True)
    assert torch.equal(t.grad, ref_t) and torch.equal(a.grad, ref_x)
    t2 = _pt(table).requires_grad_(True)
    a2 = torch.from_numpy(x)
    feat, jac = th.hashgrid_encode_with_jac(t2, a2, ts, tm)
    (jac * torch.from_numpy(ct_j)).sum().backward()  # feat unused: a zero cotangent
    assert a2.grad is None
    ref_t, _ = th.hashgrid_jac_backward_plain(_pt(table), a2, torch.zeros_like(feat),
                                              torch.from_numpy(ct_j), ts, tm)
    assert torch.equal(t2.grad, ref_t)
    with torch.no_grad():  # eval: the forward alone
        ev = th.hashgrid_encode_with_jac(t2, a2, ts, tm)
    assert ev[0].grad_fn is None and torch.equal(ev[1], jac.detach())


def _block_inputs(g=8, nblocks=48, step=0.01, seed=4):
    """Uniform-step runs per aligned g-block (the group-compacted march
    layout), as tests/test_hashgrid_jac.py _block_setup_jac builds them."""
    rs = np.random.RandomState(seed)
    x0 = rs.uniform(0.02, 0.98, (nblocks, 3))
    d = rs.randn(nblocks, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    i = np.arange(g)[None, :, None]
    return np.clip(x0[:, None] + d[:, None] * (i * step), 0.0, 1.0).reshape(-1, 3).astype(
        np.float32)


@pytest.mark.parametrize("case", ["forward", "backward"])
def test_jac_matches_jax_dedup_spec(case):
    """A dedup spec (coarse levels read one 27-point lattice per aligned
    block, tests/test_hashgrid_jac.py:132-165) in both packages (the port's
    plain HG7 / HG8 on those levels): features within rtol 1e-5, the
    Jacobian within rtol / atol 1e-4, the table gradient within 3e-3 and d x
    within rtol 1e-3 / 1e-4 of its largest value."""
    js, ts = _specs(JAC)
    jd = dataclasses.replace(js, dedup_group=8, dedup_step=0.01)
    ts = dataclasses.replace(ts, dedup_group=8, dedup_step=0.01)
    assert any(jd.dedup_group_sizes) and not all(jd.dedup_group_sizes)
    assert ts.dedup_group_sizes == jd.dedup_group_sizes
    x = _block_inputs()
    table, _, ct_f, ct_j = _inputs(js, x.shape[0], seed=5)
    if case == "forward":
        jf, jj = jax.jit(lambda t, a: jh.hashgrid_encode_with_jac(t, a, jd))(table, x)
        feat, jac = th.hashgrid_encode_with_jac(_pt(table), torch.from_numpy(x), ts)
        np.testing.assert_allclose(feat.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(jac.numpy(), np.asarray(jj), rtol=1e-4, atol=1e-4)
        return
    jt, jx = _j_vjp(jd, False, table, x, ct_f, ct_j)
    dt, dx = th.hashgrid_jac_backward_plain(_pt(table), torch.from_numpy(x),
                                            torch.from_numpy(ct_f), torch.from_numpy(ct_j), ts,
                                            with_dx=True)
    ref_t = port_layout("table", jt)
    assert float((dt - torch.from_numpy(ref_t)).abs().max()) < 3e-3 * np.abs(ref_t).max()
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), rtol=1e-3,
                               atol=1e-4 * np.abs(np.asarray(jx)).max())


@functools.lru_cache(maxsize=None)
def _progressive():
    """The JAX and the port's ProgressiveBandHashGrid, and jit of the JAX
    encoding's apply and of apply_with_jac's forward and VJP, each a function
    of (table, x, step) (one compile for every traced step)."""
    j_enc = j_nu.get_encoding(3, dict(PROGRESSIVE)).encoding

    def with_jac(t, a, step, cf, cj):
        out, vjp = jax.vjp(lambda t: j_enc.apply_with_jac({"table": t}, a, step=step), t)
        return out, vjp((cf, cj))[0]
    fns = {"apply": lambda t, a, step: j_enc.apply({"table": t}, a, step=step),
           "with_jac": with_jac}
    jitted = {k: jax.jit(f) for k, f in fns.items()}
    return j_enc, t_nu.get_encoding(3, dict(PROGRESSIVE)).encoding, jitted, fns


def test_progressive_mask_follows_step():
    """current_level and the (L,) float32 mask against the JAX encoding's at
    steps before, at and after the start and past the last level; None
    (outside training) masks nothing. The mask lies on the table's device and
    is built once per level."""
    j_enc, t_enc, _, _ = _progressive()
    assert isinstance(t_enc, t_nu.ProgressiveBandHashGrid)
    assert t_enc.current_level(None) == 6 and t_enc._mask(None, "cpu") is None
    for step in (0, 4, 5, 7, 8, 10, 11, 14, 17, 40):
        lvl = int(jax.jit(j_enc.current_level)(jnp.int32(step)))
        assert t_enc.current_level(step) == lvl, step
        ref = np.asarray(jax.jit(j_enc._mask)(jnp.int32(step)))
        got = t_enc._mask(step, torch.device("cpu"))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref), step
        assert t_enc._mask(step, "cpu") is got
    assert [t_enc.current_level(s) for s in (0, 5, 8, 11, 14, 17)] == [2, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("step", [None, 0, 8, 14])
def test_progressive_encoding_matches_jax(step):
    """The ProgressiveBandHashGrid encoding's apply (the fast encode with
    the step's mask: HG1 on the card) and apply_with_jac (HG3) against the
    JAX encoding's at ``step``: features to the bit, the Jacobian within
    1e-5 of its largest value; the jac path's table gradient against jax.vjp
    within 2.5e-2."""
    j_enc, t_enc, jitted, fns = _progressive()
    js = j_enc.spec
    table, x, ct_f, ct_j = _inputs(js, 500, seed=6)
    if step is None:  # no step: no mask, traced once on its own
        jitted = {k: jax.jit(lambda t, a, *cts, f=f: f(t, a, None, *cts))
                  for k, f in fns.items()}
        args = ()
    else:
        args = (jnp.int32(step),)
    ref = jitted["apply"](table, x, *args)
    got = t_enc.apply({"table": _pt(table)}, torch.from_numpy(x), step=step)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    (jf, jj), jt = jitted["with_jac"](table, x, *args, jnp.asarray(ct_f), jnp.asarray(ct_j))
    t = _pt(table).requires_grad_(True)
    feat, jac = t_enc.apply_with_jac({"table": t}, torch.from_numpy(x), step=step)
    np.testing.assert_array_equal(feat.detach().numpy(), np.asarray(jf))
    _close(jac, jj, 1e-5, "jac")
    ((feat * torch.from_numpy(ct_f)).sum() + (jac * torch.from_numpy(ct_j)).sum()).backward()
    _close(t.grad, port_layout("table", jt), 2.5e-2, "d table")
    if step is not None and t_enc.current_level(step) < js.n_levels:
        first_masked = js.level_offsets[t_enc.current_level(step)]
        assert not bool(t.grad[first_masked:].any())  # the masked levels get no gradient


def test_progressive_fd_eps_matches_jax():
    """VolumeSDF's finite_difference_eps 'progressive' against the JAX
    geometry's under jit with a traced int32 step (as its training step
    runs it), to the bit, at neuralangelo-dtu-wmask.yaml's grid (16 levels,
    base 32, scale 1.3195, start level 4) with update_steps cut to 10, and
    with no step (the finest level); a CP encoding with the progressive eps
    raises a ValueError naming its otype."""
    from instant_nsr_pl_tpu import registry as j_reg
    from instant_nsr_pl_tpu.config import config_from_dict as j_config
    import instant_nsr_pl_tpu.models  # noqa: F401  (register)
    from instant_nsr_pl_tpu_torch import registry as t_reg
    from instant_nsr_pl_tpu_torch.config import config_from_dict as t_config
    import instant_nsr_pl_tpu_torch.models  # noqa: F401  (register)

    cfg = {"name": "volume-sdf", "radius": 1.0, "feature_dim": 13,
           "grad_type": "finite_difference", "finite_difference_eps": "progressive",
           "xyz_encoding_config": {"otype": "ProgressiveBandHashGrid", "n_levels": 16,
                                   "n_features_per_level": 2, "log2_hashmap_size": 19,
                                   "base_resolution": 32,
                                   "per_level_scale": 1.3195079107728942,
                                   "include_xyz": True, "start_level": 4, "start_step": 0,
                                   "update_steps": 10},
           "mlp_network_config": {"otype": "VanillaMLP", "activation": "ReLU",
                                  "output_activation": "none", "n_neurons": 64,
                                  "n_hidden_layers": 1}}
    j_geo = j_reg.models.make("volume-sdf", j_config(dict(cfg)))
    t_geo = t_reg.models.make("volume-sdf", t_config(dict(cfg)))
    j_eps = jax.jit(j_geo.finite_difference_eps)
    for step in (0, 9, 10, 25, 60, 119, 120, 500):
        got = t_geo.finite_difference_eps(step)
        assert got.dtype == torch.float32
        assert float(got) == float(j_eps(jnp.int32(step))), step
    assert float(t_geo.finite_difference_eps()) == float(j_geo.finite_difference_eps())
    cp = {**cfg, "xyz_encoding_config": {"otype": "CP", "n_components": 16,
                                         "resolutions": [16, 48], "n_features": 8}}
    with pytest.raises(ValueError, match="otype 'CP'"):
        t_reg.models.make("volume-sdf", t_config(cp))


def test_progressive_table_transplants_like_hash_grid():
    """A ProgressiveBandHashGrid's table is keyed ``table`` like a HashGrid's,
    so a JAX (F, T) table carries across transposed to the port's (T, F)."""
    j_enc = j_nu.get_encoding(3, dict(PROGRESSIVE))
    t_enc = t_nu.get_encoding(3, dict(PROGRESSIVE))
    params = jax.tree_util.tree_map(np.asarray, {"encoding": j_enc.init(jax.random.PRNGKey(0))})
    carried = params_from_jax(params)
    table = params["encoding"]["table"]
    assert table.shape == (2, t_enc.encoding.spec.total_params)
    np.testing.assert_array_equal(carried["encoding.table"].numpy(), table.T)
    assert carried["encoding.table"].shape == t_enc.init(torch.Generator().manual_seed(0),
                                                         "cpu")["table"].shape
