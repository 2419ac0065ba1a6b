"""The port's training ops against the JAX package, fed the same numpy inputs
(small widths: CP C=16, R=(24, 64), F=8, MLP width 32): the trunc_exp
gradient, the fused density and radiance backwards (plain versions, what a
CPU tensor runs; the Pallas kernels run in interpret mode), the packed
gradient unpacking, the occupancy-grid update in its three modes, the
stratified march, the factor schedules and AdamW.

Random draws cannot match between the two packages, so each test draws them
once (with jax.random, as the JAX code does) and hands them to both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instant_nsr_pl_tpu.config import config_from_dict as j_config
from instant_nsr_pl_tpu.ops import activations as j_act
from instant_nsr_pl_tpu.ops import cp_mlp_pallas as j_cpm
from instant_nsr_pl_tpu.ops import marching as j_march
from instant_nsr_pl_tpu.ops import mlp_pallas_common as j_mpc
from instant_nsr_pl_tpu.ops import ray as j_ray
from instant_nsr_pl_tpu.ops import sh_mlp_pallas as j_shm
from instant_nsr_pl_tpu.ops.cp import CPSpec as JCPSpec
from instant_nsr_pl_tpu.ops.cp import cp_init
from instant_nsr_pl_tpu.ops.mlp import MLPSpec as JMLPSpec
from instant_nsr_pl_tpu.ops.mlp import mlp_init
from instant_nsr_pl_tpu.systems import optimizers as j_opt
from instant_nsr_pl_tpu_torch.config import config_from_dict
from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
from instant_nsr_pl_tpu_torch.ops import activations as t_act
from instant_nsr_pl_tpu_torch.ops import cp_mlp as t_cpm
from instant_nsr_pl_tpu_torch.ops import marching as t_march
from instant_nsr_pl_tpu_torch.ops import mlp_common as t_mpc
from instant_nsr_pl_tpu_torch.ops import ray as t_ray
from instant_nsr_pl_tpu_torch.ops import sh_mlp as t_shm
from instant_nsr_pl_tpu_torch.ops.cp import CPSpec
from instant_nsr_pl_tpu_torch.ops.mlp import MLPSpec
from instant_nsr_pl_tpu_torch.systems import optimizers as t_opt
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict


def _t(a):
    return torch.from_numpy(np.array(a))


def _carry(tree, grad=False):
    params = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, tree)))
    if grad:
        for t in named_leaves(params):
            t[1].requires_grad_(True)
    return params


def _close(got, ref, what=""):
    """The JAX gradient tests' tolerance (tests/test_cp_mlp_pallas.py:83):
    bf16 operands with f32 sums, summed in another order; a sum that lands
    next to a bf16 rounding boundary may round the other way."""
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-2 * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def test_trunc_exp_gradient():
    """exp forward, g * exp(min(x, 15)) backward, also above 15 (exact
    float32 ops on both sides: 1e-6 relative)."""
    x = np.array([-3.0, 0.0, 2.5, 14.9, 15.0, 16.0, 30.0], np.float32)
    g = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    ref = jax.grad(lambda v: (j_act.trunc_exp(v) * g).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = t_act.trunc_exp(xt)
    (y * _t(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp(x), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6)
    assert float(xt.grad[-1]) == pytest.approx(g[-1] * np.exp(15.0), rel=1e-6)


# ---------------------------------------------------------------------------
# the fused density head (K1/K2 plain versions)
# ---------------------------------------------------------------------------


def _cp_case(n_hidden, n, seed=0):
    rs = np.random.RandomState(seed)
    cp_spec = JCPSpec(n_components=16, resolutions=(24, 64), n_features=8)
    mlp_spec = JMLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden)
    cp_params = cp_init(jax.random.PRNGKey(seed), cp_spec)
    mlp_params = [
        {"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
        for l in mlp_init(jax.random.PRNGKey(seed + 1), mlp_spec)
    ]
    x = rs.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[:6] = [[0.0, 1.0, 0.5], [1 / 23, 5 / 23, 22 / 23], [1 / 63, 31 / 63, 62 / 63],
             [-0.1, 1.1, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]
    dout = rs.randn(n, 16).astype(np.float32)
    t_specs = (CPSpec(16, (24, 64), 8),
               MLPSpec(dim_in=16, dim_out=16, n_neurons=32, n_hidden_layers=n_hidden))
    return cp_spec, mlp_spec, cp_params, mlp_params, x, dout, t_specs


@pytest.mark.parametrize("n_hidden,n", [(1, 515), (2, 1024)])
def test_cp_mlp_backward_plain_matches_jax_kernel(n_hidden, n):
    """K2's plain version on the JAX forward's own residuals against the
    Pallas backward: the same bf16 operands, f32 sums in another order."""
    cp_spec, mlp_spec, cp_params, mlp_params, x, dout, (tcp, tmlp) = _cp_case(n_hidden, n)
    _, (u3p, n_, vsave, hsave), _ = j_cpm._fwd_impl(cp_params, mlp_params, jnp.asarray(x),
                                                     cp_spec, mlp_spec)
    saved = (cp_params, mlp_params, u3p, n_, vsave, hsave, jnp.asarray(x))
    d_cp, d_mlp, dx = j_cpm._cp_mlp_bwd(cp_spec, mlp_spec, saved, jnp.asarray(dout))
    assert not np.asarray(dx).any()  # the op's contract: no position cotangent

    tp_cp, tp_mlp = _carry(cp_params), _carry(mlp_params)
    _, basis, ws, _ = t_cpm.cp_mlp_operands(tp_cp, tp_mlp, tcp, tmlp)
    vs = _t(np.asarray(vsave.astype(jnp.float32))[:, :, :n]).bfloat16()
    hs = _t(np.asarray(hsave.astype(jnp.float32))[:, :, :n]).bfloat16()
    dlines, dbasis, dws, dbs = t_cpm.cp_mlp_backward_plain(
        _t(x), vs, hs, _t(dout), basis, ws, tcp, tmlp)
    for s in range(2):
        for ax in range(3):
            _close(dlines[s][ax], d_cp[f"line_{s}_{ax}"], f"line_{s}_{ax}")
        _close(dbasis[s], d_cp[f"basis_{s}"], f"basis_{s}")
    for li, layer in enumerate(t_mpc.unpack_mlp_grads(dws, dbs, [l["w"].shape for l in mlp_params])):
        _close(layer["w"], d_mlp[li]["w"], f"w{li}")
        _close(layer["b"], d_mlp[li]["b"], f"b{li}")


@pytest.mark.parametrize("n_hidden,n", [(1, 515), (2, 333)])
def test_cp_mlp_autograd_matches_jax_grad(n_hidden, n):
    """The port's op under autograd (plain forward and backward on the CPU)
    against jax.grad of cp_mlp_apply; x gets no gradient on either side."""
    cp_spec, mlp_spec, cp_params, mlp_params, x, dout, (tcp, tmlp) = _cp_case(n_hidden, n, seed=3)

    def loss(c, m, v):
        return (j_cpm.cp_mlp_apply(c, m, v, cp_spec, mlp_spec) * dout).sum()

    g_cp, g_mlp, g_x = jax.grad(loss, argnums=(0, 1, 2))(cp_params, mlp_params, jnp.asarray(x))
    assert not np.asarray(g_x).any()
    tp_cp, tp_mlp = _carry(cp_params, grad=True), _carry(mlp_params, grad=True)
    xt = _t(x).requires_grad_(True)
    out = t_cpm.cp_mlp_forward(tp_cp, tp_mlp, xt, tcp, tmlp)
    assert out.grad_fn is not None
    (out * _t(dout)).sum().backward()
    assert xt.grad is None
    for k, v in g_cp.items():
        _close(tp_cp[k].grad, v, k)
    for li in range(n_hidden + 1):
        _close(tp_mlp[li]["w"].grad, g_mlp[li]["w"], f"w{li}")
        _close(tp_mlp[li]["b"].grad, g_mlp[li]["b"], f"b{li}")


def test_cp_mlp_training_residuals_match_jax():
    """The plain forward's residuals equal the JAX kernel's vsave and hsave
    (bf16 values; an f32 sum next to a bf16 boundary may round the other
    way, so at most 0.1% of entries may differ, each by one bf16 step)."""
    cp_spec, mlp_spec, cp_params, mlp_params, x, _, (tcp, tmlp) = _cp_case(2, 515)
    out_j, (_, _, vsave, hsave), _ = j_cpm._fwd_impl(cp_params, mlp_params, jnp.asarray(x),
                                                      cp_spec, mlp_spec)
    out, vs, hs = t_cpm.cp_mlp_forward_plain(_carry(cp_params), _carry(mlp_params), _t(x),
                                             tcp, tmlp, save_residuals=True)
    assert vs.dtype == hs.dtype == torch.bfloat16
    assert vs.shape == (3, 32, 515) and hs.shape == (2, 32, 515)
    for got, ref in ((vs, vsave), (hs, hsave)):
        ref = np.asarray(ref.astype(jnp.float32))[:, :, :515]
        diff = np.abs(got.float().numpy() - ref)
        assert (diff > 0).mean() <= 1e-3
        assert (diff <= np.abs(ref) * 2.0**-7 + 1e-30).all()
    _close(out, np.asarray(out_j), "out")


# ---------------------------------------------------------------------------
# the fused radiance head (K3/K4 plain versions)
# ---------------------------------------------------------------------------


def _sh_case(n_post, n=600, seed=2):
    rs = np.random.RandomState(seed)
    n_feat = 16 + n_post
    spec = JMLPSpec(dim_in=n_feat + 16, dim_out=3, n_neurons=32, n_hidden_layers=2)
    params = [
        {"w": l["w"], "b": jnp.asarray(0.1 * rs.randn(*l["b"].shape).astype(np.float32))}
        for l in mlp_init(jax.random.PRNGKey(seed + 5), spec)
    ]
    feats = rs.randn(n, n_feat).astype(np.float32)
    dirs = rs.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dout = rs.randn(n, 3).astype(np.float32)
    tspec = MLPSpec(dim_in=spec.dim_in, dim_out=3, n_neurons=32, n_hidden_layers=2)
    return spec, params, feats, dirs, dout, tspec


@pytest.mark.parametrize("n_post", [0, 3])
def test_sh_mlp_backward_plain_matches_jax_kernel(n_post):
    """K4's plain version on the JAX forward's hsave against the Pallas
    backward, without and with extras (fpad 16 and 24)."""
    spec, params, feats, dirs, dout, tspec = _sh_case(n_post)
    _, (featp, dirsp, n, hsave), _ = j_shm._fwd_impl(params, feats, dirs, spec, 4, 16)
    saved = (params, featp, dirsp, hsave, jnp.asarray(feats), jnp.asarray(dirs))
    d_mlp, d_feat, d_dirs = j_shm._sh_mlp_bwd(spec, 4, 16, saved, jnp.asarray(dout))
    assert not np.asarray(d_dirs).any()
    tp = _carry(params)
    ws, _, fpad = t_shm.pack_sh_mlp(tp, tspec, 4, 16, 16 + n_post)
    assert fpad == (16 if n_post == 0 else 24)
    hs = _t(np.asarray(hsave.astype(jnp.float32))[:, :, :n]).bfloat16()
    dws, dbs, dfeat = t_shm.sh_mlp_backward_plain(_t(feats), _t(dirs), hs, _t(dout), ws, fpad,
                                                  tspec, 4)
    _close(dfeat, d_feat, "features")
    dws = torch.cat([dws[:16 + n_post], dws[fpad:]])
    layers = t_mpc.unpack_mlp_grads(dws, dbs, [l["w"].shape for l in params],
                                    reorder_first_rows=t_shm._perm(tspec, 4, 16))
    for li, layer in enumerate(layers):
        _close(layer["w"], d_mlp[li]["w"], f"w{li}")
        _close(layer["b"], d_mlp[li]["b"], f"b{li}")


@pytest.mark.parametrize("n_post", [0, 3])
def test_sh_mlp_autograd_matches_jax_grad(n_post):
    """The port's op under autograd against jax.grad of sh_mlp_apply:
    features and weights get gradients, directions none."""
    spec, params, feats, dirs, dout, tspec = _sh_case(n_post, n=421, seed=7)

    def loss(p, f, d):
        return (j_shm.sh_mlp_apply(p, f, d, spec, 4, 16) * dout).sum()

    g_p, g_f, g_d = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(feats), jnp.asarray(dirs))
    assert not np.asarray(g_d).any()
    tp = _carry(params, grad=True)
    ft, dt = _t(feats).requires_grad_(True), _t(dirs).requires_grad_(True)
    out = t_shm.sh_mlp_forward(tp, ft, dt, tspec, 4, 16)
    (out * _t(dout)).sum().backward()
    assert dt.grad is None
    _close(ft.grad, g_f, "features")
    for li in range(3):
        _close(tp[li]["w"].grad, g_p[li]["w"], f"w{li}")
        _close(tp[li]["b"].grad, g_p[li]["b"], f"b{li}")


def test_unpack_mlp_grads_with_reorder():
    """Packed gradients sliced back into layers, the first layer's row
    permutation inverted: equal to the JAX package's unpacking, exactly."""
    rs = np.random.RandomState(4)
    shapes = [(35, 32), (32, 32), (32, 3)]
    dws = rs.randn(35 + 64, 32).astype(np.float32)
    dbs = rs.randn(3, 32).astype(np.float32)
    perm = t_shm._perm(MLPSpec(dim_in=35, dim_out=3, n_neurons=32, n_hidden_layers=2), 4, 16)
    assert sorted(perm.tolist()) == list(range(35)) and perm.tolist() != list(range(35))
    params = [{"w": np.zeros(s, np.float32), "b": np.zeros(s[1], np.float32)} for s in shapes]
    ref = j_mpc.unpack_mlp_grads(jnp.asarray(dws), jnp.asarray(dbs), params,
                                 reorder_first_rows=perm)
    got = t_mpc.unpack_mlp_grads(_t(dws), _t(dbs), shapes, reorder_first_rows=perm)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["w"].numpy(), np.asarray(r["w"]))
        np.testing.assert_array_equal(g["b"].numpy(), np.asarray(r["b"]))
    # the inverse really undoes the packing: pack_mlp row k is layer row perm[k]
    w0 = rs.randn(35, 32).astype(np.float32)
    back = t_mpc.unpack_mlp_grads(_t(w0[perm]), _t(dbs[:1]), shapes[:1], reorder_first_rows=perm)
    np.testing.assert_array_equal(back[0]["w"].numpy(), w0)


# ---------------------------------------------------------------------------
# occupancy grid update and the stratified march
# ---------------------------------------------------------------------------


def _field(world):
    """An occupancy field of world points, in numpy float32 for both
    packages: a soft ball of radius 0.6 plus a thin shell."""
    w = np.asarray(world, np.float32)
    r = np.sqrt((w * w).sum(-1))
    return (0.05 * np.exp(-8.0 * (r - 0.6) ** 2) + 0.02 * (r < 0.3)).astype(np.float32)


@pytest.mark.parametrize("mode", ["warmup", "slab", "random"])
def test_occupancy_grid_update_matches_jax(mode):
    """Both packages update the same 32^3 grid from the same draws: occs
    within 1e-6, binary and dilated fields equal."""
    res, radius = 32, 1.5
    rs = np.random.RandomState(5)
    occs0 = (rs.rand(res**3) * 0.02).astype(np.float32)
    binary0 = occs0 > 0.015
    spec_j = j_march.OccGridSpec(res, radius)
    dil0, bricks0 = j_march._postprocess_binary(jnp.asarray(binary0), spec_j)
    state_j = j_march.OccupancyGridState(jnp.asarray(occs0), jnp.asarray(binary0), dil0, bricks0)
    key = jax.random.PRNGKey(11)
    warmup = mode == "warmup"
    phase = 3 if mode == "slab" else None
    ref = j_march.occupancy_grid_update(
        state_j, spec_j, key, lambda w: jnp.asarray(_field(w)), occ_thre=0.01,
        warmup=warmup, phase=phase)

    # the JAX update's own draws, from the same key splits
    n, m = res**3, res**3 // 8
    k_idx, k_occ, k_jit = jax.random.split(key, 3)
    if mode == "random":
        total = int(binary0.sum())
        draws = {
            "uniform": _t(jax.random.randint(k_idx, (m,), 0, n, dtype=jnp.int32)),
            "occupied": _t(jax.random.randint(k_occ, (m,), 0, max(total, 1))),
            "jitter": _t(jax.random.uniform(k_jit, (2 * m, 3))),
        }
    else:
        draws = {"jitter": _t(jax.random.uniform(k_jit, (n if warmup else m, 3)))}
    spec_t = t_march.OccGridSpec(res, radius)
    state_t = t_march.OccupancyGridState(
        _t(occs0), _t(binary0), t_march._postprocess_binary(_t(binary0), spec_t))
    got = t_march.occupancy_grid_update(
        state_t, spec_t, lambda w: torch.from_numpy(_field(w.numpy())), draws=draws,
        occ_thre=0.01, warmup=warmup, phase=phase)
    np.testing.assert_allclose(got.occs.numpy(), np.asarray(ref.occs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.binary.numpy(), np.asarray(ref.binary))
    np.testing.assert_array_equal(got.binary_dilated.numpy(), np.asarray(ref.binary_dilated))
    changed = (got.occs.numpy() != occs0).mean()
    assert changed > (0.5 if warmup else 0.05)


def test_occupancy_update_draws_from_generator():
    """Without given draws the update draws from the generator: the same
    seed gives the same grid, every mode changes it."""
    spec = t_march.OccGridSpec(16, 1.0)
    state = t_march.occupancy_grid_init(spec, "cpu")
    fn = lambda w: torch.from_numpy(_field(w.numpy()))  # noqa: E731
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        s1 = t_march.occupancy_grid_update(state, spec, fn, gen, warmup=True)
        s2 = t_march.occupancy_grid_update(s1, spec, fn, gen, phase=1)
        s3 = t_march.occupancy_grid_update(s2, spec, fn, gen)
        outs.append(s3)
    assert torch.equal(outs[0].occs, outs[1].occs)
    assert s1.binary.any() and not s1.binary.all()
    assert not torch.equal(s2.occs, s1.occs) and not torch.equal(s3.occs, s2.occs)


def test_stratified_march_matches_jax_bitwise():
    """The jittered march (bench march: 1024 samples/ray, 128^3 grid, k=8,
    group compaction) with the JAX draw injected: every packed output
    equal."""
    radius, S, k = 1.5, 1024, 8
    rs = np.random.RandomState(6)
    binary = rs.rand(128**3) < 0.02
    spec_j = j_march.OccGridSpec(128, radius)
    dil_j, bricks = jax.jit(lambda b: j_march._postprocess_binary(b, spec_j))(jnp.asarray(binary))
    spec_t = t_march.OccGridSpec(128, radius)
    dil_t = t_march._postprocess_binary(_t(binary), spec_t)
    o = rs.randn(64, 3).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5
    d = -o / 2.5 + rs.randn(64, 3).astype(np.float32) * 0.4
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    step = 1.732 * 2.0 * radius / S
    key = jax.random.PRNGKey(9)
    kw = dict(render_step_size=step, max_samples=S, capacity=64 * 1024, occ_stride=k,
              group_compact=True)
    t0j, t1j = j_ray.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), -radius, radius)
    ref = jax.jit(lambda a, b, c, e: j_march.march_rays(
        a, b, c, e, occ_spec=spec_j, occ_binary=jnp.asarray(binary), occ_dilated=dil_j,
        occ_bricks=bricks, stratified=True, rng=key, **kw))(jnp.asarray(o), jnp.asarray(d), t0j, t1j)
    t0t, t1t = t_ray.ray_aabb_intersect(_t(o), _t(d), -radius, radius)
    jitter = _t(jax.random.uniform(key, (64,)))
    got = t_march.march_rays(_t(o), _t(d), t0t, t1t, occ_spec=spec_t, occ_binary=_t(binary),
                             occ_dilated=dil_t, jitter=jitter, **kw)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    plain = t_march.march_rays(_t(o), _t(d), t0t, t1t, occ_spec=spec_t, occ_binary=_t(binary),
                               occ_dilated=dil_t, **kw)
    assert int(got.valid.sum()) > 0 and not torch.equal(got.t_starts, plain.t_starts)


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

_SCHEDULES = [
    {"name": "ConstantLR", "args": {"factor": 0.25, "total_iters": 7}},
    {"name": "LinearLR", "args": {"start_factor": 0.1, "end_factor": 1.0, "total_iters": 20}},
    {"name": "ExponentialLR", "args": {"gamma": 0.97}},
    {"name": "MultiStepLR", "args": {"milestones": [10, 25], "gamma": 0.33}},
    {"name": "StepLR", "args": {"step_size": 9, "gamma": 0.5}},
    {"name": "CosineAnnealingLR", "args": {"T_max": 30, "eta_min": 0.05}},
    {"name": "SequentialLR", "milestones": [12],
     "schedulers": [{"name": "LinearLR", "args": {"start_factor": 0.01, "total_iters": 12}},
                    {"name": "ExponentialLR", "args": {"gamma": 0.95}}]},
    {"name": "ChainedScheduler",
     "schedulers": [{"name": "ConstantLR", "args": {"factor": 0.5, "total_iters": 4}},
                    {"name": "StepLR", "args": {"step_size": 10, "gamma": 0.1}}]},
    {"name": "ExponentialLR", "interval": "epoch", "args": {"gamma": 0.9}},
]


@pytest.mark.parametrize("cfg", _SCHEDULES, ids=lambda c: c["name"] + c.get("interval", ""))
def test_factor_schedules_match_jax(cfg):
    """Host float64 factors against the JAX package's float32 ones."""
    j = j_opt.make_factor_schedule(j_config(cfg), epoch_steps=4)
    t = t_opt.make_factor_schedule(config_from_dict(cfg), epoch_steps=4)
    for step in range(0, 45):
        assert t(step) == pytest.approx(float(j(jnp.float32(step))), rel=1e-5, abs=1e-7), step


def test_adamw_groups_match_jax():
    """Three AdamW updates with two parameter groups (a group lr override
    and a MultiStepLR milestone after the first update): the port's params
    and Adam moments against optax's, within float32 rounding (1e-5 of the
    parameter scale)."""
    rs = np.random.RandomState(8)
    params = {"geometry": {"a": rs.randn(5, 3).astype(np.float32),
                           "b": [rs.randn(4).astype(np.float32)]},
              "texture": {"c": rs.randn(6).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda p: rs.randn(*p.shape).astype(np.float32), params)
             for _ in range(3)]
    ocfg = {"name": "AdamW", "args": {"lr": 0.01, "betas": [0.9, 0.99], "eps": 1e-15},
            "params": {"texture": {"lr": 0.05}}}
    scfg = {"name": "MultiStepLR", "interval": "step", "args": {"milestones": [1], "gamma": 0.3}}
    tx, lr_fn = j_opt.make_optimizer(j_config(ocfg), j_config(scfg), params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = params_from_state_dict(params_from_jax(params))
    leaves = named_leaves(tp)
    for _, t in leaves:
        t.requires_grad_(True)
    opt, t_lr = t_opt.make_optimizer(config_from_dict(ocfg), config_from_dict(scfg), tp)
    assert [g["name"] for g in opt.optimizer.param_groups] == ["geometry", "texture"]
    assert opt.optimizer.defaults["weight_decay"] == 0.01
    for count, g in enumerate(grads):
        for (key, t), (_, gv) in zip(leaves, named_leaves(g)):
            t.grad = _t(gv)
        opt.step(count)
        assert t_lr(count) == pytest.approx(float(lr_fn(count)), rel=1e-6)
    for (key, t), (_, ref) in zip(leaves, named_leaves(jax.tree_util.tree_map(np.asarray, jp))):
        np.testing.assert_allclose(t.detach().numpy(), ref, rtol=0, atol=1e-5, err_msg=key)
    mu = st.inner_states["geometry"].inner_state[0].mu["geometry"]
    state = opt.optimizer.state[tp["geometry"]["a"]]
    np.testing.assert_allclose(state["exp_avg"].numpy(), np.asarray(mu["a"]), rtol=1e-6, atol=1e-7)
    assert int(state["step"]) == 3
