"""The plain versions of HG3 / HG4 (``instant_nsr_pl_tpu_torch/ops/hashgrid.py``
``hashgrid_jac_forward_plain`` / ``hashgrid_jac_backward_plain``: the CPU side
of ``hashgrid_encode_with_jac``) against the JAX package's
``hashgrid_encode_with_jac`` and its VJP (``instant_nsr_pl_tpu/ops/hashgrid.py``,
jitted on the CPU), at the sizes and level counts the kernels' schedules cut
along: N = 0, 1, 127, 128, 129 and 3 x 128 + 5 (HG3 and HG4 take 128 samples
a block; the table gradient at N = 0, 1, 129 and 3 x 128 + 5), 12, 6 and 5
levels (HG3 takes 4, 2 or 1 levels a thread; HG4 tiles of 4 levels, the last
one short at 6 and 5 levels), dense and hashed levels, points on the box's
faces, a run of equal samples that spans blocks of 128, samples with zero
cotangents (a training step's empty slots), with and without a band mask of
5 levels of 12, and with d x.

Each spec's JAX function is jitted once, at the largest N: every output of a
sample depends on that sample alone, so the first n rows of the JAX outputs
are the outputs of the first n samples, and the JAX table gradient and d x of
the first n samples are those of all samples with the cotangents of the others
set to zero.

Tolerances (those of ``tests/test_torch_port_hashgrid_jac_ops.py``): the
features equal to the jitted JAX features to the bit, the Jacobian within
1e-5 of its largest value; the table gradient and d x within 2.5e-2 of their
largest value (the JAX fast path rounds the updates to bf16 on its one-hot
matmul levels)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import hashgrid as jh
from instant_nsr_pl_tpu_torch.ops import hashgrid as th
from instant_nsr_pl_tpu_torch.utils.transplant import port_layout

# configs/neus-synthetic.yaml's level count and scale at a small table (3
# dense levels, 9 hashed), tests/test_hashgrid_jac.py:18's 6 levels (5
# dense, 1 hashed) and a 5-level spec (2 dense, 3 hashed)
SPECS = {
    "12": dict(n_levels=12, n_features_per_level=2, log2_hashmap_size=12, base_resolution=4,
               per_level_scale=1.3195079107728942),
    "6": dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=14, base_resolution=4,
              per_level_scale=1.5),
    "5": dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=11, base_resolution=4,
              per_level_scale=1.9),
}
SIZES = (0, 1, 127, 128, 129, 3 * 128 + 5)
N = max(SIZES)
# (spec, band mask): the mask (5 levels of 12) at the 12-level spec
CASES = [("12", False), ("12", True), ("6", False), ("5", False)]
# the sizes the table gradient is held against jax.vjp at (a call of the
# JAX VJP takes ~1 s on the CPU), besides N = 0
VJP_SIZES = (1, 129, N)
RUN = slice(100, 350)  # one point, across the block boundaries at 128 and 256
EMPTY = slice(200, 260)  # zero cotangents


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(name, masked):
    """The specs, a (F, T) table of order 0.1, N positions (the box's
    corners and faces first, then ``RUN`` on one point), both cotangents
    (zero over ``EMPTY``) and the band mask (the first 5 levels, as a
    ProgressiveBandHashGrid at level 5) or None, as numpy."""
    kw = SPECS[name]
    js, ts = jh.HashGridSpec(**kw), th.HashGridSpec(**kw)
    assert any(ts.level_hashed) and not all(ts.level_hashed)
    rs = np.random.RandomState(int(name) * 7 + masked)
    table = ((rs.rand(js.n_features_per_level, js.total_params) - 0.5) * 2e-1).astype(np.float32)
    x = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    x[:8] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.0, 0.125],
             [0.5, 0.5, 0.0], [0.25, 1.0, 0.75], [1.0, 0.3, 0.6], [0.999999, 1e-7, 0.5]]
    x[RUN] = [0.3, 0.71, 0.52]
    ct_f = rs.randn(N, ts.n_output_dims).astype(np.float32)
    ct_j = rs.randn(3, N, ts.n_output_dims).astype(np.float32)
    ct_f[EMPTY] = 0.0
    ct_j[:, EMPTY] = 0.0
    mask = (np.arange(ts.n_levels) < 5).astype(np.float32) if masked else None
    return js, ts, table, x, ct_f, ct_j, mask


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
    """jit of the JAX encoding with its Jacobian and of its VJP (d table,
    d x) for both cotangents, each a function of the level mask too (a mask
    of ones computes what no mask does, to the bit: one compile each per
    spec)."""
    js = _case(name, False)[0]

    def forward(t, a, m):
        return jh.hashgrid_encode_with_jac(t, a, js, m)

    def grads(t, a, m, cf, cj):
        _, vjp = jax.vjp(lambda t, a: forward(t, a, m), t, a)
        return vjp((cf, cj))
    return jax.jit(forward), jax.jit(grads)


def _jax_mask(ts, mask):
    return jnp.ones((ts.n_levels,), jnp.float32) if mask is None else jnp.asarray(mask)


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _torch(name, masked, n):
    _, ts, table, x, ct_f, ct_j, mask = _case(name, masked)
    t = torch.from_numpy(np.ascontiguousarray(table.T))
    return (ts, t, torch.from_numpy(x[:n]), torch.from_numpy(ct_f[:n]),
            torch.from_numpy(np.ascontiguousarray(ct_j[:, :n])),
            None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("name,masked", CASES)
def test_forward_at_schedule_edges_matches_jax(name, masked):
    """At every N of ``SIZES``: the features equal to the jitted JAX
    features to the bit (and to the plain hash encode's), the Jacobian
    within 1e-5 of its largest value, the shapes (N, L F) and (3, N, L F)
    also at N = 0."""
    js, ts, table, x, _, _, mask = _case(name, masked)
    forward, _ = _jax_fns(name)
    j_feat, j_jac = (np.asarray(a) for a in forward(table, x, _jax_mask(ts, mask)))
    for n in SIZES:
        ts, t, xn, _, _, m = _torch(name, masked, n)
        feat, jac = th.hashgrid_jac_forward_plain(t, xn, ts, m)
        assert feat.shape == (n, ts.n_output_dims) and jac.shape == (3, n, ts.n_output_dims)
        np.testing.assert_array_equal(feat.numpy(), j_feat[:n], err_msg=f"feat, N={n}")
        assert torch.equal(feat, th.hashgrid_encode(t, xn, ts, m))
        if n:
            _close(jac, j_jac[:, :n], 1e-5, f"jac, N={n}")


@pytest.mark.parametrize("name,masked", CASES)
def test_backward_at_schedule_edges_matches_jax(name, masked):
    """At N = 0 and every N of ``VJP_SIZES``: the table gradient and d x of
    the first N samples against jax.vjp with the other samples' cotangents
    zero, within 2.5e-2 of their largest value; the table gradient without
    d x equal to the one with it; the masked levels get no gradient; N = 0
    gives a zero gradient and an empty d x."""
    _, ts, table, x, ct_f, ct_j, mask = _case(name, masked)
    _, grads = _jax_fns(name)
    for n in (0, *VJP_SIZES):
        cf, cj = ct_f.copy(), ct_j.copy()
        cf[n:], cj[:, n:] = 0.0, 0.0
        jt, jx = grads(table, x, _jax_mask(ts, mask), cf, cj) if n else (None, None)
        ts, t, xn, tcf, tcj, m = _torch(name, masked, n)
        dt, dx = th.hashgrid_jac_backward_plain(t, xn, tcf, tcj, ts, m, with_dx=True)
        dt_only, no_dx = th.hashgrid_jac_backward_plain(t, xn, tcf, tcj, ts, m)
        assert no_dx is None and torch.equal(dt_only, dt)
        assert dx.shape == (n, 3)
        if not n:
            assert not bool(dt.any())
            continue
        _close(dt, port_layout("table", jt), 2.5e-2, f"d table, N={n}")
        _close(dx, np.asarray(jx)[:n], 2.5e-2, f"d x, N={n}")
        if m is not None:
            assert not bool(dt[ts.level_offsets[5]:].any())


@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_across_blocks_and_empty_slots(name):
    """The samples of ``RUN`` on one point, across two block boundaries,
    with the slots of ``EMPTY`` among them: the table gradient of the run
    alone, summed in float32 by the plain version, within 1e-5 of its
    largest value of the float64 sum of the same float32 updates; the empty
    slots add nothing (the gradient of the run with them equals the gradient
    without them to the bit) and get a zero d x."""
    ts, t, xn, cf, cj, _ = _torch(name, False, N)
    run = torch.arange(N)[RUN]
    full = th.hashgrid_jac_backward_plain(t, xn[run], cf[run], cj[:, run].contiguous(), ts,
                                          with_dx=True)
    exact, _ = th.hashgrid_jac_backward_plain(t, xn[run], cf[run], cj[:, run].contiguous(), ts,
                                              accumulate=torch.float64)
    for lv in range(ts.n_levels):
        sl = slice(ts.level_offsets[lv], ts.level_offsets[lv] + ts.level_sizes[lv])
        ref = exact[sl]
        assert float((full[0][sl].double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    live = run[(run < EMPTY.start) | (run >= EMPTY.stop)]
    without, _ = th.hashgrid_jac_backward_plain(t, xn[live], cf[live], cj[:, live].contiguous(),
                                                ts)
    assert torch.equal(full[0], without)
    empty = full[1][EMPTY.start - RUN.start:EMPTY.stop - RUN.start]
    assert not bool(empty.any())
    others = torch.cat([full[1][:EMPTY.start - RUN.start], full[1][EMPTY.stop - RUN.start:]])
    assert bool(others.any())


def test_dx_is_a_function_of_each_sample():
    """d x of a sample depends on that sample alone: the plain version's d x
    of a permuted batch equals the permuted d x within 1e-6 of its largest
    value (its vectorised sums may round a sample's terms in another order
    at another position; HG4 sums each sample's levels in level order, and
    the card tests hold its d x to the bit across two calls and a
    permutation)."""
    ts, t, xn, cf, cj, m = _torch("12", True, N)
    _, dx = th.hashgrid_jac_backward_plain(t, xn, cf, cj, ts, m, with_dx=True)
    perm = torch.from_numpy(np.random.RandomState(3).permutation(N))
    _, dx_p = th.hashgrid_jac_backward_plain(t, xn[perm], cf[perm], cj[:, perm].contiguous(), ts,
                                             m, with_dx=True)
    _close(dx_p, dx[perm].numpy(), 1e-6, "d x, permuted")
