"""The port's hash grid (``instant_nsr_pl_tpu_torch/ops/hashgrid.py``) against
the JAX package's (``instant_nsr_pl_tpu/ops/hashgrid.py``), fed the same
seeded numpy inputs at small sizes with dense and hashed levels: the spec
layout field by field, the corner taps, the forward with and without a level
mask, the table and position gradients against ``jax.grad`` and against the
JAX fast path (its sort and one-hot matmul levels), the dedup spec on
aligned blocks; the ``HashGrid`` encoding module; and the CP instantiation
lists against ``bench.py``'s encodings.

Tolerances: the forward within rtol 1e-5 / atol 1e-8
(``tests/test_ops_hashgrid.py:82``; the port also equals the jitted JAX
forward to the bit: both round ``x * s + 0.5`` and the corner sum as fused
multiply-adds); gradients within rtol 1e-4 / atol 1e-5 of ``jax.grad``
(``tests/test_hashgrid_fast_grad.py:51-52``), at that test's table scale
(``hashgrid_init * 1000``) and grid scales up to ~125 (that test's reach
30): the position gradient sums terms of order scale x table value in
another order than XLA, so its float32 error grows with both; against the
JAX fast path's table gradient 8e-3 x max|ref|, because that path rounds
``w * ct`` to bf16 on its one-hot matmul levels (``hashgrid.py:558-567``)."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import hashgrid as jh
from instant_nsr_pl_tpu_torch.models import network_utils as t_nu
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cp_mlp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import cp_stacked as t_cps
from instant_nsr_pl_tpu_torch.ops import hashgrid as th

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 5 levels, 2^11 rows: levels 0-1 dense, 2-4 hashed
SMALL = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=11, base_resolution=4,
             per_level_scale=1.9)
# 4 levels, 2^17 rows: levels 2-3 hashed, at the JAX fast path's sort size
# (_SORT_GRAD_MIN_SIZE), levels 0-1 dense, on its one-hot matmul
SORT = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=17, base_resolution=8,
            per_level_scale=2.5)
SPECS = {
    "small": SMALL,
    "sort": SORT,
    "bench": {},  # bench.py --encoding hash: the dataclass defaults
    "nerf-synthetic": dict(n_levels=12, log2_hashmap_size=18),
    "neus-blender": dict(base_resolution=32, per_level_scale=1.3195079107728942),
    "f4": dict(n_levels=3, n_features_per_level=4, log2_hashmap_size=10, base_resolution=6,
               per_level_scale=2.0),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(kw):
    return jh.HashGridSpec(**kw), th.HashGridSpec(**kw)


def _pt(table):
    """A JAX-layout (F, T) numpy table as the port's row-major (T, F) tensor."""
    return torch.from_numpy(np.ascontiguousarray(table.T))


def _inputs(spec, n, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    table = ((rs.rand(spec.n_features_per_level, spec.total_params) - 0.5) * 2 * scale)
    x = rs.rand(n, 3).astype(np.float32)
    ct = rs.randn(n, spec.n_output_dims).astype(np.float32)
    return table.astype(np.float32), x, ct


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_layout_matches_jax(name):
    js, ts = _specs(SPECS[name])
    for field in ("table_size", "scales", "resolutions", "level_sizes", "level_hashed",
                  "level_offsets", "total_params", "n_output_dims", "dedup_group_sizes"):
        assert getattr(ts, field) == getattr(js, field), field
    cfg = {"n_levels": js.n_levels, "n_features_per_level": js.n_features_per_level,
           "log2_hashmap_size": js.log2_hashmap_size, "base_resolution": js.base_resolution,
           "per_level_scale": js.per_level_scale}
    assert dataclasses.asdict(th.HashGridSpec.from_config(cfg)) == dataclasses.asdict(
        jh.HashGridSpec.from_config(cfg))
    for group, step in ((8, 0.0017), (8, 0.01), (4, 0.05), (2, 0.01), (16, 0.0)):
        jd = dataclasses.replace(js, dedup_group=group, dedup_step=step)
        td = dataclasses.replace(ts, dedup_group=group, dedup_step=step)
        assert td.dedup_group_sizes == jd.dedup_group_sizes, (group, step)
    if name == "bench":  # the table the chip script times: 50.4 MB of float32
        assert ts.total_params == 6299960 and sum(ts.level_hashed) == 11
    # the kernels' per-level constants
    lv = th.level_params(ts)
    for level in range(ts.n_levels):
        assert lv[level].scale == np.float32(ts.scales[level])
        assert (lv[level].res, lv[level].size, lv[level].offset, lv[level].hashed) == (
            ts.resolutions[level], ts.level_sizes[level], ts.level_offsets[level],
            int(ts.level_hashed[level]))


def test_init_layout_and_range():
    _, ts = _specs(SMALL)
    t = th.hashgrid_init(torch.Generator().manual_seed(0), ts, "cpu")
    assert t.shape == (ts.total_params, 2) and t.dtype == torch.float32 and t.is_contiguous()
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5
    again = th.hashgrid_init(torch.Generator().manual_seed(0), ts, "cpu")
    assert torch.equal(t, again)


@pytest.mark.parametrize("name", ["small", "sort", "nerf-synthetic"])
def test_corner_taps_match_jax(name):
    """Rows and weights of every level's 8 corners equal the jitted JAX
    taps, uint32 hash wrap included, at random positions, exact 0 and 1, and
    positions just off a cell boundary."""
    js, ts = _specs(SPECS[name])
    _, x, _ = _inputs(js, 3000, seed=1)
    x[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1e-7, 0.9999999, 0.25]]
    xt = np.ascontiguousarray(x.T)
    for level in range(js.n_levels):
        s = np.float32(js.scales[level])
        near = (np.floor(x[4:20, 0] * s) + 0.5) / s  # mid-cell, far from a boundary
        xt[0, 4:20] = near.astype(np.float32)
        j_idx, j_w = jax.jit(lambda a, lv=level: jh._level_corner_indices(js, a, lv))(xt)
        t_idx, t_w = th.level_corner_indices(ts, torch.from_numpy(xt), level)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx), err_msg=f"level {level}")
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w), err_msg=f"level {level}")
    assert any(js.level_hashed)
    big = jh.HashGridSpec(**SPECS["bench"])  # cu * 2654435761 wraps mod 2^32
    assert big.resolutions[-1] * 2654435761 > 2**32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["small", "sort", "f4"])
def test_forward_matches_jax(name, masked):
    js, ts = _specs(SPECS[name])
    table, x, _ = _inputs(js, 2000, seed=2, scale=100.0)
    mask = np.linspace(1.0, 0.0, js.n_levels).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = np.asarray(jax.jit(lambda t, a: jh.hashgrid_encode(t, a, js, jm))(table, x))
    got = th.hashgrid_encode(_pt(table), torch.from_numpy(x), ts, tm).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(got, ref)  # the same rounding points
    fast = th.hashgrid_encode_fast(_pt(table), torch.from_numpy(x), ts, tm)
    np.testing.assert_array_equal(fast.numpy(), got)
    # batch dims are kept, level-major features
    x3 = torch.from_numpy(x[:1998]).reshape(3, 666, 3)
    assert th.hashgrid_encode_fast(_pt(table), x3, ts, tm).shape == (
        3, 666, js.n_output_dims)


def _jax_grads(fn, table, x, ct, js, mask):
    jm = None if mask is None else jnp.asarray(mask)
    return jax.jit(jax.grad(lambda t, a: (fn(t, a, js, jm) * ct).sum(), argnums=(0, 1)))(
        jnp.asarray(table), jnp.asarray(x))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["small", "sort", "f4"])
def test_gradients_match_jax_grad(name, masked):
    """The fast op (the plain HG2 on the CPU) and the autodiff encode against
    jax.grad of hashgrid_encode: table and positions."""
    js, ts = _specs(SPECS[name])
    table, x, ct = _inputs(js, 1500, seed=3, scale=0.1)  # hashgrid_init * 1000, as there
    mask = np.array([1.0, 0.5, 0.0, 1.0, 0.25][:js.n_levels], np.float32) if masked else None
    jt, jx = _jax_grads(jh.hashgrid_encode, table, x, ct, js, mask)
    tm = None if mask is None else torch.from_numpy(mask)
    for op in (th.hashgrid_encode_fast, th.hashgrid_encode):
        t = _pt(table).requires_grad_(True)
        a = torch.from_numpy(x).requires_grad_(True)
        (op(t, a, ts, tm) * torch.from_numpy(ct)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy().T, np.asarray(jt), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)
    # positions that do not require grad get none (the NeRF samples)
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x)
    (th.hashgrid_encode_fast(t, a, ts, tm) * torch.from_numpy(ct)).sum().backward()
    assert a.grad is None
    dt, dx = th.hashgrid_backward(_pt(table), a, torch.from_numpy(ct), ts, tm)
    assert dx is None
    np.testing.assert_allclose(dt.numpy().T, np.asarray(jt), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["small", "sort"])
def test_gradients_against_jax_fast_path(name):
    """Against the JAX fast path (two-sort segment sum on levels of >= 2^17
    rows, bf16 one-hot matmul below): positions within rtol 1e-4 / atol 1e-5;
    the table within 8e-3 x max|ref|, the bf16 rounding of w * ct on the
    matmul levels (the sort levels sum in f32: rtol 1e-4 there)."""
    js, ts = _specs(SPECS[name])
    table, x, ct = _inputs(js, 1200, seed=4, scale=0.1)
    jt, jx = _jax_grads(jh.hashgrid_encode_fast, table, x, ct, js, None)
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    (th.hashgrid_encode_fast(t, a, ts) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)
    jt = np.asarray(jt)
    got = t.grad.numpy().T
    assert np.abs(got - jt).max() <= 8e-3 * np.abs(jt).max()  # bf16 one-hot levels
    for level in range(js.n_levels):
        sl = slice(js.level_offsets[level], js.level_offsets[level] + js.level_sizes[level])
        if js.level_sizes[level] >= jh._SORT_GRAD_MIN_SIZE:
            np.testing.assert_allclose(got[:, sl], jt[:, sl], rtol=1e-4, atol=1e-5)
    assert any(s >= jh._SORT_GRAD_MIN_SIZE for s in js.level_sizes) == (name == "sort")


def _blocks(spec, g=8, nblocks=48, step=0.01, seed=5):
    """Uniform-step runs, one per aligned g-block (the group-compacted
    march's layout), as tests/test_hashgrid_fast_grad.py:_block_setup."""
    rs = np.random.RandomState(seed)
    x0 = rs.uniform(0.02, 0.98, (nblocks, 3)).astype(np.float32)
    d = rs.randn(nblocks, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    i = np.arange(g, dtype=np.float32)[None, :, None]
    return np.clip(x0[:, None] + d[:, None] * (i * step), 0.0, 1.0).reshape(-1, 3)


def test_dedup_blocks_match_jax_dedup_path():
    """On aligned blocks both packages read one 27-point lattice per block on
    the coarse levels (the port's plain HG5 / HG6 here): forward rtol 1e-5 /
    atol 1e-6, position gradient rtol 2e-4 / atol 2e-5, table gradient 8e-3
    x max (the JAX fast path's bf16 one-hot levels), as the JAX dedup tests
    hold it."""
    kw = dict(n_levels=6, log2_hashmap_size=14, base_resolution=4, per_level_scale=1.5)
    js, ts = _specs(kw)
    jd = dataclasses.replace(js, dedup_group=8, dedup_step=0.01)
    td = dataclasses.replace(ts, dedup_group=8, dedup_step=0.01)
    assert td.dedup_group_sizes == jd.dedup_group_sizes
    assert any(td.dedup_group_sizes) and not all(td.dedup_group_sizes)
    x = _blocks(js)
    rs = np.random.RandomState(6)
    table = ((rs.rand(2, js.total_params) - 0.5) * 0.2).astype(np.float32)
    ct = rs.randn(x.shape[0], js.n_output_dims).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t, a: jh.hashgrid_encode_fast(t, a, jd))(table, x))
    got = th.hashgrid_encode_fast(_pt(table), torch.from_numpy(x), td).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    jt, jx = _jax_grads(jh.hashgrid_encode_fast, table, x, ct, jd, None)
    t = _pt(table).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    (th.hashgrid_encode_fast(t, a, td) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jx), rtol=2e-4, atol=2e-5)
    assert np.abs(t.grad.numpy().T - np.asarray(jt)).max() <= 8e-3 * np.abs(np.asarray(jt)).max()


def test_hashgrid_encoding_module():
    """``get_encoding`` builds the HashGrid module: 'fast' (the default) and
    'autodiff' compute the same features; configure_dedup keeps the JAX
    module's dedup spec and the grouped call picks it only for whole blocks
    (on aligned blocks its lattice levels give the per-sample features);
    ProgressiveBandHashGrid builds (slice 7), and the encodings of later
    slices are refused with their ROADMAP item."""
    from instant_nsr_pl_tpu.models import network_utils as j_nu

    cfg = {"otype": "HashGrid", **{k: v for k, v in dict(
        n_levels=6, n_features_per_level=2, log2_hashmap_size=14, base_resolution=4,
        per_level_scale=1.5).items()}}
    enc = t_nu.get_encoding(3, cfg)
    inner = enc.encoding
    assert isinstance(inner, t_nu.HashGridEncoding) and inner.grad_mode == "fast"
    assert enc.n_output_dims == 12
    params = enc.init(torch.Generator().manual_seed(0), "cpu")
    assert params["table"].shape == (inner.spec.total_params, 2)
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(1))
    auto = t_nu.get_encoding(3, {**cfg, "grad_mode": "autodiff"})
    assert torch.equal(enc.apply(params, x), auto.apply(params, x))
    j_enc = j_nu.get_encoding(3, {**cfg, "grad_mode": "fast"})
    for group, step in ((8, 0.01), (2, 0.01), (8, 0.0)):
        enc.configure_dedup(group, step)
        j_enc.configure_dedup(group, step)
        j_spec = j_enc.encoding.dedup_spec
        t_spec = inner.dedup_spec
        assert (t_spec is None) == (j_spec is None)
        if j_spec is not None:
            assert t_spec.dedup_group_sizes == j_spec.dedup_group_sizes
    assert inner._spec_for(x, grouped=True) is inner.dedup_spec
    assert inner._spec_for(x[:60], grouped=True) is inner.spec
    assert inner._spec_for(x, grouped=False) is inner.spec
    # a grouped call reads the dedup levels from block lattices: on aligned
    # uniform-step blocks (the lattice's premise) the same function as the
    # per-sample taps, within 1e-5 x max
    xb = torch.from_numpy(_blocks(inner.spec))
    ref = enc.apply(params, xb)
    torch.testing.assert_close(enc.apply(params, xb, grouped=True), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="grad_mode"):
        t_nu.get_encoding(3, {**cfg, "grad_mode": "sort"})
    band = t_nu.get_encoding(3, {**cfg, "otype": "ProgressiveBandHashGrid", "start_level": 2,
                                 "start_step": 0, "update_steps": 4})  # ported in slice 7
    assert isinstance(band.encoding, t_nu.ProgressiveBandHashGrid) and band.has_jac
    assert torch.equal(band.apply(params, x), enc.apply(params, x))  # no step: no mask
    # ported in slice 10: both build, at the JAX package's output widths
    for otype, extra in (("VanillaFrequency", {"n_frequencies": 6, "n_masking_step": 10}),
                         ("VM", {"n_components": 4, "plane_resolution": 16,
                                 "line_resolution": 32, "n_scales": 2})):
        other = {"otype": otype, "include_xyz": True, **extra}
        t_other, j_other = t_nu.get_encoding(3, other), j_nu.get_encoding(3, other)
        assert t_other.n_output_dims == j_other.n_output_dims
        other_params = t_other.init(torch.Generator().manual_seed(0))
        assert tuple(t_other.apply(other_params, x, step=4).shape) == (
            x.shape[0], j_other.n_output_dims)


def _bench():
    spec = importlib.util.spec_from_file_location("bench_encodings", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cp_instantiations_cover_bench_encodings():
    """Every CP entry of bench.py's _ENCODINGS (cp, cp_big, cp_stacked), with
    the bench NeRF density head (bench.py:165-179: 64 wide, one hidden layer,
    16 outputs) and the bench NeuS (bench.py:231-262: include_xyz, the
    composed route), is in the kernels' instantiation lists: the fused head
    (K1/K2, K13/K14 for stacked scales), the product (K5-K8) and the product
    with its Jacobian (K9/K10, K11/K12)."""
    from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
    from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec

    encodings = _bench()._ENCODINGS
    cps = {k: v for k, v in encodings.items() if v["otype"] == "CP"}
    assert set(cps) == {"cp", "cp_big", "cp_stacked"}
    for name, cfg in cps.items():
        spec = CPSpec.from_config(cfg)
        stacked = bool(cfg.get("stack_scales", False))
        head = MLPSpec(dim_in=spec.n_output_dims, dim_out=16, n_neurons=64, n_hidden_layers=1)
        assert t_cp_mlp.fusable(spec, head), name
        t_cp_mlp.check_fused_instantiated(spec, head, stacked)  # the NeRF head
        key = t_cp_mlp.fused_shape(spec, head)
        assert key in (t_cp_mlp.STACKED_INSTANTIATIONS if stacked else t_cp_mlp.INSTANTIATIONS)
        assert spec.n_components in t_cpp.PRODUCT_COMPONENTS, name
        if stacked:
            assert (spec.n_components, spec.n_features, len(spec.resolutions)) in \
                t_cps.STACKED_JAC_SHAPES, name
        else:
            assert (spec.n_components, spec.n_features) in t_cpp.JAC_BASIS_SHAPES, name
        enc = t_nu.CPEncoding(3, cfg)
        enc.check_instantiated()
        enc.check_instantiated(jac=True)
    # the supported strings name the lists
    assert str((128, 16, 3, 64, 1, 16)) in t_cp_mlp.SUPPORTED
    assert "128" in t_cpp.SUPPORTED_PRODUCT and str((128, 16)) in t_cpp.SUPPORTED_JAC


def test_cp_shape_without_kernels_refused_at_build_for_cuda():
    """A CP shape the kernels lack is refused when a model is built for the
    card (before any parameter is allocated), for the fused and the composed
    route, and builds as before on the CPU; fusable does not quietly send it
    elsewhere."""
    from instant_nsr_pl_tpu_torch.models.network_utils import get_encoding_with_network

    mlp = {"otype": "FullyFusedMLP", "activation": "ReLU", "output_activation": "none",
           "n_neurons": 64, "n_hidden_layers": 1}
    odd = {"otype": "CP", "n_components": 96, "resolutions": [128, 2048], "n_features": 16}
    ewn = get_encoding_with_network(3, 16, odd, mlp)
    assert ewn.fused  # fusable keeps the fused route for it
    with pytest.raises(ValueError, match="no CUDA instantiation"):
        ewn.init(torch.Generator().manual_seed(0), "cuda")
    assert ewn.init(torch.Generator().manual_seed(0), "cpu")["encoding"]["cp"]
    composed = get_encoding_with_network(3, 16, {**odd, "include_xyz": True}, mlp)
    assert not composed.fused
    with pytest.raises(ValueError, match="cp_product"):
        composed.init(torch.Generator().manual_seed(0), "cuda")
    enc = t_nu.CPEncoding(3, {**odd, "n_components": 64, "n_features": 8})
    enc.check_instantiated()
    with pytest.raises(ValueError, match="cp_product_jac_basis"):
        enc.check_instantiated(jac=True)
    t_nu.CPEncoding(3, {**odd, "grad_mode": "autodiff"}).check_instantiated(jac=True)
