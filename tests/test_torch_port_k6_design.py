"""CPU checks around the redesigned K6 (the CP product's backward: the
line-table instantiation of K10's 64-sample tiles, ``csrc/cp_jac_basis_bwd.cu``).

K6's plain version (what a CPU tensor runs, and what the card tests hold the
kernel against) against the JAX package's Pallas backward ``_cp_product_bwd``,
reached through ``jax.vjp`` of ``cp_pallas.cp_product`` in interpret mode, so
it is fed the JAX forward's own residual:

- on the finite-difference NeuS's operands, built as ``models/geometry.py``
  builds its stencil: ray-ordered points in the world box of radius 1.5, each
  expanded into its six points x +- eps along each axis (eps 1e-3) and
  clipped to the box, a sample's six points next to each other, so that four
  of them share each axis's coordinate to the bit (the rows the kernel's
  window merges); at N around the card kernel's 64-sample tile and its
  scatter run (63, 64, 65, 6 x 64 + 1), at R = 128 and 2048 (the bench
  scales), with points on the box's faces (u exactly 0 after the clip), and
  with every sample at one point: d lines and d u within 2.5e-2 x max|ref|
  (the JAX kernel tests' gradient limit);
- at the stacked scales' R = 129 and 2049 away from u = 1, and at u exactly
  1, where the two packages differ on purpose: the JAX kernel takes its
  diff-hot operand over the table padded to a multiple of 8 rows, so its
  derivative pair at u = 1 is (R - 1, zero pad) while the port keeps (R - 2,
  R - 1). There d u differs by s * sum_C d v * (2 L[R - 1] - L[R - 2]), s =
  (R - 1) / 2, to f32 rounding, which the test checks; d lines agree (the tent puts
  all weight on row R - 1 in both). At R = 128 (a multiple of 8) the two agree
  at u = 1 as well.

The finite-difference geometry's SDF gradient through ``cp_product`` is held
against the JAX package's by ``tests/test_torch_port_neus.py``
(``test_volume_sdf_matches_jax[finite_difference]``). The kernel itself runs
only on the card (``tests/test_torch_port_cuda.py``, the ``k6_`` cases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp

TILE = 64  # samples per tile of the card's K6 (csrc/mma_common.cuh kT)
RUN = 6 * TILE  # the (axis, row) items a tile gathers; 3 x 64 (axis, sample) rows a scatter
C = 16  # the small test model's components: the tile and the scatter do not depend on C
RADIUS = 1.5  # the bench NeuS's world box (neus-cp-synthetic.yaml model.radius)
EPS = 1e-3  # its geometry's finite_difference_eps
_STENCIL = np.array(((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)),
                    np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _stencil_u3(n, rs, hi=RADIUS, faces=False, one_point=False):
    """(3, n) unit-box coordinates of the finite-difference stencil: ray
    samples x in the world box [-RADIUS, hi]^3 (two rays, evenly spaced),
    each expanded into its six points x + EPS * offset, clipped to the box and
    mapped to [0, 1] (``models/geometry.py`` and ``contract_to_unisphere``);
    the first n points. ``faces`` puts some samples on the box's faces (u
    exactly 0 after the clip); ``one_point`` puts every sample at one point."""
    m = -(-n // 6)
    ends = rs.uniform(-RADIUS, hi, (2, 2, 3)).astype(np.float32)  # two rays' ends
    t = ((np.arange(m) + 0.5) / m).astype(np.float32)[:, None]
    x = np.where(np.arange(m)[:, None] < m // 2, ends[0, 0] + t * (ends[0, 1] - ends[0, 0]),
                 ends[1, 0] + t * (ends[1, 1] - ends[1, 0])).astype(np.float32)
    if faces:
        x[::5, 0] = -RADIUS
        x[1::7, 1] = -RADIUS
        x[2::9, 2] = -RADIUS + 0.5 * EPS
    if one_point:
        x[:] = np.array([0.3, -0.71, 0.52], np.float32)
    pts = np.minimum(np.maximum(x[:, None, :] + np.float32(EPS) * _STENCIL, -RADIUS), RADIUS)
    u = (pts.reshape(-1, 3) + np.float32(RADIUS)) / np.float32(2 * RADIUS)
    return np.ascontiguousarray(u[:n].T.astype(np.float32))


def _both(res, u3, rs):
    """K6's plain version and ``jax.vjp`` of the JAX op on the same tables,
    coordinates and cotangent: ((d lines, d u) of each, and the inputs)."""
    n = u3.shape[1]
    lines = [(rs.randn(res, C) * 0.1).astype(np.float32) for _ in range(3)]
    dprod = rs.randn(C, n).astype(np.float32)
    jl = [jnp.asarray(a) for a in lines]
    _, vjp = jax.vjp(lambda lx, ly, lz, u: j_cpp.cp_product(lx, ly, lz, u, res),
                     *jl, jnp.asarray(u3))
    ref = vjp(jnp.asarray(dprod))
    _, vsave = j_cpp._cp_product_fwd_impl(*jl, jnp.asarray(u3), res)
    t_v = _t(np.asarray(vsave[:, :, :n]).astype(np.float32)).to(torch.bfloat16)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    got = t_cpp.cp_product_backward_plain(stack, _t(u3), t_v, _t(dprod), res)
    return got, ref, (stack, t_v, dprod)


def _check(got, ref, res, n):
    dlines, du = got
    assert dlines.shape == (3, res, C) and du.shape == (3, n)
    for ax in range(3):
        _close(dlines[ax], ref[ax], 2.5e-2, f"d line {ax}")
    _close(du, ref[3], 2.5e-2, "du")


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, RUN + 1])
@pytest.mark.parametrize("res", [128, 2048])
def test_k6_plain_matches_jax_on_stencil_operands(res, n):
    """Stencil-ordered operands around the tile and the run, with samples on
    the box's faces: d lines and d u within 2.5e-2."""
    rs = np.random.RandomState(res + n)
    u3 = _stencil_u3(n, rs, faces=True)
    assert (u3 == 0.0).any()
    # four of a sample's six points share each axis's coordinate to the bit
    full = _stencil_u3(6 * 8, np.random.RandomState(1)).T.reshape(8, 6, 3)
    for a in range(3):
        assert all(len(set(full[s, :, a].tolist())) <= 3 for s in range(8))
    got, ref, _ = _both(res, u3, rs)
    _check(got, ref, res, n)


@pytest.mark.parametrize("res", [128, 2048])
def test_k6_plain_matches_jax_one_point(res):
    """Every sample at one point (the stencil of one point repeated): each
    axis's rows collapse to a few, all of a tile's on the same rows."""
    n = 2 * RUN + 5
    rs = np.random.RandomState(7)
    u3 = _stencil_u3(n, rs, one_point=True)
    got, ref, _ = _both(res, u3, rs)
    for ax in range(3):
        assert int((got[0][ax].abs().sum(1) > 0).sum()) <= 4
    _check(got, ref, res, n)


@pytest.mark.parametrize("n", [TILE + 1, RUN + 1])
@pytest.mark.parametrize("res", [129, 2049])
def test_k6_plain_matches_jax_stacked_scales_below_one(res, n):
    """The stacked scales' R = 129 and 2049 (not a multiple of 8) on stencil
    operands that stay below u = 1 (and touch u = 0): within 2.5e-2."""
    rs = np.random.RandomState(res + 3 * n)
    u3 = _stencil_u3(n, rs, hi=RADIUS - 0.01, faces=True)
    assert float(u3.max()) < 1.0 and (u3 == 0.0).any()
    got, ref, _ = _both(res, u3, rs)
    _check(got, ref, res, n)


@pytest.mark.parametrize("res", [128, 129, 2049])
def test_k6_u_one_pair_departure(res):
    """u exactly 1 (a stencil point clipped onto the box's far face): d lines
    agree; d u agrees away from u = 1 and, at u = 1, equals the JAX kernel's
    plus s * sum_C d v * (2 L[R - 1] - L[R - 2]) (its pair is (R - 1, zero
    pad), the port's (R - 2, R - 1)) where R is not a multiple of 8, to f32
    rounding, and the JAX kernel's itself at R = 128."""
    n = 2 * TILE + 7
    rs = np.random.RandomState(res)
    u3 = _stencil_u3(n, rs, hi=RADIUS - 0.01)
    at_one = np.zeros_like(u3, dtype=bool)
    for a in range(3):  # a few points of each axis on the far face
        cols = np.arange(a, n, 11)
        u3[a, cols] = 1.0
        at_one[a, cols] = True
    got, ref, (stack, vsave, dprod) = _both(res, u3, rs)
    for ax in range(3):
        _close(got[0][ax], ref[ax], 2.5e-2, f"d line {ax}")
    du, du_ref = got[1].double().numpy(), np.asarray(ref[3], np.float64)
    scale = 2.5e-2 * np.abs(du_ref).max()
    np.testing.assert_allclose(du[~at_one], du_ref[~at_one], rtol=0, atol=scale)
    table = stack.double().numpy()  # (3, R, C)
    v = vsave.double().numpy()
    others = (v[1] * v[2], v[0] * v[2], v[0] * v[1])
    for a in range(3):
        cols = at_one[a]
        d_v = dprod.astype(np.float64)[:, cols] * others[a][:, cols]  # (C, k)
        pair = 2.0 * table[a, res - 1] - table[a, res - 2] if res % 8 else 0.0 * table[a, 0]
        expected = 0.5 * (res - 1) * (pair[:, None] * d_v).sum(0)
        if res % 8:  # the departure exceeds the gradient limit: it is not hidden by it
            assert np.abs(expected).max() > scale
        # and it is that difference, to f32 rounding of the two sums
        np.testing.assert_allclose(du[a, cols] - du_ref[a, cols], expected, rtol=0,
                                   atol=1e-4 * np.abs(du_ref).max(), err_msg=f"axis {a} at u = 1")
