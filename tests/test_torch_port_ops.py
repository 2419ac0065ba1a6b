"""PyTorch port (instant_nsr_pl_tpu_torch) against the JAX package: rays,
contraction, SH, the composed MLP and CP encode, the occupancy-pruned march
and compositing, fed the same numpy inputs. Plus the port's rules: no JAX
import, CUDA by default."""

import ast
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import contraction as j_con
from instant_nsr_pl_tpu.ops import cp as j_cp
from instant_nsr_pl_tpu.ops import marching as j_march
from instant_nsr_pl_tpu.ops import mlp as j_mlp
from instant_nsr_pl_tpu.ops import ray as j_ray
from instant_nsr_pl_tpu.ops import rendering as j_rend
from instant_nsr_pl_tpu.ops import sh as j_sh
from instant_nsr_pl_tpu_torch.ops import contraction as t_con
from instant_nsr_pl_tpu_torch.ops import cp as t_cp
from instant_nsr_pl_tpu_torch.ops import marching as t_march
from instant_nsr_pl_tpu_torch.ops import mlp as t_mlp
from instant_nsr_pl_tpu_torch.ops import ray as t_ray
from instant_nsr_pl_tpu_torch.ops import rendering as t_rend
from instant_nsr_pl_tpu_torch.ops import sh as t_sh
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "instant_nsr_pl_tpu_torch"
F32_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rays(rs, n, dist=2.5, spread=0.4):
    o = rs.randn(n, 3).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * dist
    d = -o / dist + rs.randn(n, 3).astype(np.float32) * spread
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_ray_aabb_intersect_hits_and_misses():
    rs = np.random.RandomState(0)
    o, d = _rays(rs, 200)
    d[:20] = -d[:20]  # pointing away: misses
    jt = j_ray.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), -1.5, 1.5)
    tt = t_ray.ray_aabb_intersect(_t(o), _t(d), -1.5, 1.5)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (tt[0].numpy() == 1e10).sum() >= 20  # the miss value is kept


def test_get_rays_and_directions():
    rs = np.random.RandomState(1)
    dirs = j_ray.get_ray_directions(7, 5, 6.0, 6.5, 3.5, 2.5)
    np.testing.assert_array_equal(dirs, t_ray.get_ray_directions(7, 5, 6.0, 6.5, 3.5, 2.5))
    c2w = rs.randn(4, 3, 4).astype(np.float32)
    for dd, cc in ((dirs.reshape(-1, 3), c2w[0]), (dirs, c2w[1]), (dirs, c2w),
                   (dirs.reshape(-1, 3)[:4], c2w)):
        jo, jd = j_ray.get_rays(dd, cc)
        to, td = t_ray.get_rays(_t(dd), _t(cc))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=F32_TOL)


def test_contraction_round_trip():
    rs = np.random.RandomState(2)
    x = rs.uniform(-1.5, 1.5, (100, 3)).astype(np.float32)
    aabb = j_con.ContractionType.AABB
    u_j = j_con.contract_to_unisphere(jnp.asarray(x), 1.5, aabb)
    u_t = t_con.contract_to_unisphere(_t(x), 1.5, t_con.ContractionType.AABB)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=F32_TOL)
    back = t_con.uncontract_from_unisphere(u_t, 1.5, t_con.ContractionType.AABB)
    np.testing.assert_allclose(back.numpy(), x, atol=F32_TOL)
    # the unbounded sphere: JAX's UN_BOUNDED_SPHERE branch, out to 20x the radius
    x = x * rs.uniform(0.2, 20.0, (100, 1)).astype(np.float32)
    unb = j_con.ContractionType.UN_BOUNDED_SPHERE
    u_j = j_con.contract_to_unisphere(jnp.asarray(x), 1.5, unb)
    u_t = t_con.contract_to_unisphere(_t(x), 1.5, t_con.ContractionType.UN_BOUNDED_SPHERE)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=F32_TOL)
    back = t_con.uncontract_from_unisphere(u_t, 1.5, t_con.ContractionType.UN_BOUNDED_SPHERE)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=F32_TOL)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encoding(degree):
    rs = np.random.RandomState(3)
    d = rs.randn(300, 3).astype(np.float32)
    d01 = ((d / np.linalg.norm(d, axis=1, keepdims=True)) + 1.0) / 2.0
    ref = np.asarray(j_sh.spherical_harmonics_encoding(jnp.asarray(d01), degree))
    got = t_sh.spherical_harmonics_encoding(_t(d01), degree).numpy()
    assert got.shape == ref.shape == (300, degree * degree)
    np.testing.assert_allclose(got, ref, atol=F32_TOL)


@pytest.mark.parametrize("n_hidden", [1, 2])
def test_mlp_apply_bf16(n_hidden):
    spec = j_mlp.MLPSpec(dim_in=24, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    params = j_mlp.mlp_init(jax.random.PRNGKey(n_hidden), spec)
    rs = np.random.RandomState(4)
    params = [{"w": l["w"], "b": jnp.asarray(rs.randn(*l["b"].shape).astype(np.float32) * 0.1)}
              for l in params]
    x = rs.randn(257, 24).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: j_mlp.mlp_apply(p, v, spec))(params, jnp.asarray(x)))
    tp = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tspec = t_mlp.MLPSpec(dim_in=24, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    got = t_mlp.mlp_apply(tp, _t(x), tspec).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max())


def test_mlp_unported_options_raise():
    """Sphere init is ported (the first layer is zero beyond the xyz rows);
    stacked scales need nested resolutions (the default (128, 2048) is not:
    ValueError, as in the JAX package); the Jacobian of a CP encoding without
    a basis (cp_product_jac, K7/K8) returns the JAX package's shapes."""
    spec = t_mlp.MLPSpec(dim_in=5, dim_out=1, sphere_init=True)
    layers = t_mlp.mlp_init(torch.Generator().manual_seed(0), spec)
    assert float(layers[0]["w"][3:].abs().max()) == 0.0
    from instant_nsr_pl_tpu_torch.models.network_utils import CPEncoding

    with pytest.raises(ValueError, match="nested"):
        CPEncoding(3, {"otype": "CP", "stack_scales": True})
    raw = CPEncoding(3, {"otype": "CP", "n_components": 16, "resolutions": [8], "n_features": 0})
    params = raw.init(torch.Generator().manual_seed(0))
    x = torch.rand(4, 3)
    feat, jac = raw.apply_with_jac(params, x)
    spec_j = j_cp.CPSpec(16, (8,), 0)
    j_params = {k: jnp.asarray(v.numpy()) for k, v in params["cp"].items()}
    j_feat, j_jac = j_cp.cp_encode_with_jac(j_params, jnp.asarray(x.numpy()), spec_j,
                                            impl="pallas")
    assert feat.shape == j_feat.shape == (4, 16) and jac.shape == j_jac.shape == (3, 4, 16)


def test_cp_encode_xla():
    spec_j = j_cp.CPSpec(16, (24, 64), 8)
    params = j_cp.cp_init(jax.random.PRNGKey(0), spec_j)
    rs = np.random.RandomState(5)
    x = rs.uniform(-0.1, 1.1, (515, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.75],
             [1 / 23, 2 / 23, 22 / 23], [3 / 63, 1.0, 0.0], [0.0, 62 / 63, 1.0]]
    ref = np.asarray(jax.jit(lambda p, v: j_cp.cp_encode(p, v, spec_j, impl="xla"))(params, jnp.asarray(x)))
    tp = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = t_cp.cp_encode(tp, _t(x), t_cp.CPSpec(16, (24, 64), 8)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max())


def _grid(res, radius, seed=0, density=0.02):
    rs = np.random.RandomState(seed)
    binary = rs.rand(res**3) < density
    spec_j = j_march.OccGridSpec(res, radius)
    dil_j, bricks = jax.jit(lambda b: j_march._postprocess_binary(b, spec_j))(jnp.asarray(binary))
    spec_t = t_march.OccGridSpec(res, radius)
    dil_t = t_march._postprocess_binary(_t(binary), spec_t)
    np.testing.assert_array_equal(np.asarray(dil_j), dil_t.numpy())
    return binary, (spec_j, dil_j, bricks), (spec_t, dil_t)


@pytest.mark.parametrize(
    "mode,capacity",
    [("group", 96 * 1024), ("group", 4096), ("strided", 96 * 1024), ("per_sample", 8192)],
)
def test_march_rays_exact(mode, capacity):
    """Bench march (1024 samples/ray, radius 1.5, 128^3 grid, k=8): every
    packed output equal, including under capacity truncation (4096)."""
    radius, S, k = 1.5, 1024, 8
    binary, (spec_j, dil_j, bricks), (spec_t, dil_t) = _grid(128, radius)
    o, d = _rays(np.random.RandomState(6), 96)
    d[:4] = -d[:4]
    step = 1.732 * 2.0 * radius / S
    stride = 1 if mode == "per_sample" else k
    kw = dict(render_step_size=step, max_samples=S, capacity=capacity, occ_stride=stride,
              group_compact=mode == "group")
    t0j, t1j = j_ray.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), -radius, radius)
    ref = jax.jit(lambda a, b, c, e: j_march.march_rays(
        a, b, c, e, occ_spec=spec_j, occ_binary=jnp.asarray(binary), occ_dilated=dil_j,
        occ_bricks=bricks, **kw))(jnp.asarray(o), jnp.asarray(d), t0j, t1j)
    t0t, t1t = t_ray.ray_aabb_intersect(_t(o), _t(d), -radius, radius)
    got = t_march.march_rays(_t(o), _t(d), t0t, t1t, occ_spec=spec_t, occ_binary=_t(binary),
                             occ_dilated=dil_t, **kw)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    if capacity == 4096:
        assert not got.ray_kept.numpy().all()  # the case truncates rays
    else:
        assert got.ray_kept.numpy().all()
    assert int(got.valid.sum()) > 0
    pj = j_march.packed_positions(ref, jnp.asarray(o), jnp.asarray(d), group=k if mode == "group" else 1)
    pt = t_march.packed_positions(got, _t(o), _t(d), group=k if mode == "group" else 1)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32_TOL)


@pytest.mark.parametrize("group", [1, 8])
def test_render_weights_and_accumulate(group):
    """Weights and per-ray sums on a packed buffer with k=8 blocks."""
    rs = np.random.RandomState(7)
    n_rays, cap = 40, 1024
    blocks = rs.randint(0, 4, n_rays)  # live k-blocks per ray
    ray_of_block = np.repeat(np.arange(n_rays), blocks)[: cap // 8]
    n_blocks = len(ray_of_block)
    ray_indices = np.full(cap, n_rays - 1, np.int32)
    ray_indices[: n_blocks * 8] = np.repeat(ray_of_block, 8)
    valid = np.zeros(cap, bool)
    valid[: n_blocks * 8] = rs.rand(n_blocks * 8) < 0.8
    ts = np.sort(rs.uniform(0, 3, cap)).astype(np.float32)
    te = (ts + rs.uniform(0.001, 0.02, cap)).astype(np.float32)
    sigma = rs.exponential(20.0, cap).astype(np.float32)
    vals = rs.rand(cap, 5).astype(np.float32)
    ends = np.cumsum(np.bincount(ray_of_block, minlength=n_rays) * 8).astype(np.int32)
    ref_w = jax.jit(lambda *a: j_rend.render_weight_from_density(*a, group=group))(
        ts, te, sigma, ray_indices, valid)
    got_w = t_rend.render_weight_from_density(_t(ts), _t(te), _t(sigma),
                                              _t(ray_indices).long(), _t(valid), group=group)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), atol=F32_TOL)
    ref = jax.jit(lambda w, e: j_rend.accumulate_along_rays(
        w, ray_indices, vals, n_rays=n_rays, valid=valid, group=group, ends=e))(
        ref_w, jnp.asarray(ends))
    got = t_rend.accumulate_along_rays(got_w, _t(vals), _t(ends).long(), valid=_t(valid),
                                       group=group)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)
    # the scatter-add form of the same sums (rays without slots give zero)
    scatter = jax.jit(lambda w: j_rend.accumulate_along_rays(
        w, ray_indices, vals, n_rays=n_rays, valid=valid, group=group))(ref_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(scatter), atol=F32_TOL)


def _autograd_accumulate(weights, values, ends, valid=None, group=1):
    """The per-ray sum before its custom VJP: float64 prefix sums
    differenced under autograd (the forward ``segment_sum_sorted`` keeps)."""
    if valid is not None:
        weights = torch.where(valid, weights, torch.zeros_like(weights))
    src = weights[:, None] * values
    if group > 1:
        src = src.reshape(-1, group, src.shape[1]).sum(dim=1)
        ends = ends // group
    c = torch.cumsum(src.T.contiguous().double(), dim=1)
    c = torch.cat([c.new_zeros((c.shape[0], 1)), c], dim=1)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    out = (c[:, ends] - c[:, starts]).T.float()
    return torch.where((ends > starts)[:, None], out, torch.zeros_like(out))


def _packed_rays(seed, n_rays, cap, group):
    """A packed, ray-sorted buffer: rays of 0-3 k-blocks (some own none),
    invalid slots inside runs, padding slots (ray n_rays - 1) past the last."""
    rs = np.random.RandomState(seed)
    blocks = rs.randint(0, 4, n_rays)
    blocks[[0, n_rays // 2]] = 0  # the first ray and one in the middle own no slots
    ray_of_block = np.repeat(np.arange(n_rays), blocks)[: cap // group - 2]
    n_live = len(ray_of_block) * group
    ray_indices = np.full(cap, n_rays - 1, np.int32)
    ray_indices[:n_live] = np.repeat(ray_of_block, group)
    valid = np.zeros(cap, bool)
    valid[:n_live] = rs.rand(n_live) < 0.8
    ends = np.cumsum(np.bincount(ray_of_block, minlength=n_rays) * group).astype(np.int32)
    weights = rs.rand(cap).astype(np.float32)
    vals = rs.randn(cap, 5).astype(np.float32)
    ct = rs.randn(n_rays, 5).astype(np.float32)
    return ray_indices, valid, ends, weights, vals, ct


@pytest.mark.parametrize("group", [1, 8])
def test_accumulate_vjp_matches_jax(group):
    """The per-ray sum's custom VJP (``segment_sum_sorted``): gradients with
    respect to weights and values against ``jax.vjp`` of the JAX
    ``accumulate_along_rays(..., ends=)``, within 1e-6 x max|grad|, with
    invalid and padding slots and rays that own none; the forward equal to
    the autograd formula it replaced to the bit."""
    n_rays, cap = 48, 1024
    ray_indices, valid, ends, weights, vals, ct = _packed_rays(3, n_rays, cap, group)
    assert ends[-1] < cap and (np.diff(np.concatenate([[0], ends])) == 0).sum() >= 2

    def jax_sum(w, v):
        return j_rend.accumulate_along_rays(w, ray_indices, v, n_rays=n_rays, valid=valid,
                                            group=group, ends=jnp.asarray(ends))

    ref, vjp = jax.vjp(jax_sum, jnp.asarray(weights), jnp.asarray(vals))
    ref_dw, ref_dv = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    w = _t(weights).requires_grad_()
    v = _t(vals).requires_grad_()
    got = t_rend.accumulate_along_rays(w, v, _t(ends).long(), valid=_t(valid), group=group)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=F32_TOL)
    for name, g, r in (("weights", w.grad, ref_dw), ("values", v.grad, ref_dv)):
        tol = 1e-6 * np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=tol, err_msg=name)
    assert np.abs(ref_dv[~valid]).max() == 0  # the mask zeroes padding and invalid slots
    old = _autograd_accumulate(_t(weights), _t(vals), _t(ends).long(), valid=_t(valid),
                               group=group)
    assert torch.equal(got.detach(), old)


@pytest.mark.parametrize("group", [1, 8])
def test_segment_sum_sorted_backward_is_the_gather(group):
    """The backward itself, without the mask: each row gets its ray's
    cotangent exactly (``ct[row_rays]``, the JAX ``_sss_bwd``), padding rows
    the last ray's; the autograd formula agrees up to its float64 rounding."""
    n_rays, cap = 48, 1024
    ray_indices, _, ends, _, vals, ct = _packed_rays(4, n_rays, cap, group)
    rows = ray_indices.reshape(-1, group)[:, 0]
    src = _t(vals[: cap // group]).requires_grad_()
    t_rend.segment_sum_sorted(src, _t(ends // group).long()).backward(_t(ct))
    np.testing.assert_array_equal(src.grad.numpy(), ct[rows])
    _, jvjp = jax.vjp(lambda s: j_rend.segment_sum_sorted(s, jnp.asarray(rows),
                                                          jnp.asarray(ends // group), n_rays),
                      jnp.asarray(vals[: cap // group]))
    np.testing.assert_array_equal(src.grad.numpy(), np.asarray(jvjp(jnp.asarray(ct))[0]))
    old = _t(vals[: cap // group]).requires_grad_()
    _autograd_accumulate(torch.ones(cap // group), old, _t(ends // group).long()).backward(
        _t(ct))
    live = ends[-1] // group
    np.testing.assert_allclose(old.grad.numpy()[:live], ct[rows][:live], rtol=0,
                               atol=1e-6 * np.abs(ct).max())


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^(jax|jaxlib|instant_nsr_pl_tpu)(\.|$)")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_source_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "scripts").glob("profile_torch_*.py"))
    assert ROOT / "scripts" / "profile_torch_train.py" in files
    # the hash grid, its model wiring and the probe script
    for new in ("ops/hashgrid.py", "models/network_utils.py", "tools/microbench_gather.py",
                "tools/__init__.py"):
        assert PORT / new in files, new
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imports(f) if _FORBIDDEN.match(m)]
    assert not bad, bad
    # the package prefix is a prefix of the port's own name
    assert not _FORBIDDEN.match("instant_nsr_pl_tpu_torch.ops")
    assert _FORBIDDEN.match("instant_nsr_pl_tpu.ops")


def test_port_import_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'instant_nsr_pl_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda():
    from instant_nsr_pl_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_march.occupancy_grid_init(t_march.OccGridSpec())
    assert resolve_device("cpu").type == "cpu"
