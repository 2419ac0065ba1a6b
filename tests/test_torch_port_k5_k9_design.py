"""CPU checks around the redesigned forwards K5 (the CP product,
``csrc/cp_product_fwd.cu``) and K9 / K11 (the CP product with its Jacobian and
the basis projection, ``csrc/cp_jac_basis_fwd.cu``, per scale and stacked):
64-sample tiles, whole-row gathers, the projection on the tensor cores.

The plain versions (what a CPU tensor runs, and what the card tests and
``chip_smoke.py`` hold the kernels against) against the JAX package's Pallas
forwards ``_cp_product_fwd_impl``, ``_cp_jacb_fwd_impl`` and
``_cp_jacs_fwd_impl`` in interpret mode, on numpy inputs from a seed:

- at N = 63, 64, 65 and 6 x 64 + 1, around the card kernels' tile and a
  block's six tiles, with u exactly 0, 1 and 0.5, out-of-range values and
  every knot; at N = 0 the JAX forwards cannot run (their block slice needs a
  sample), so the plain versions are held to empty outputs of the right
  shapes;
- at R = 128 and 2048 (the bench scales), K5 also at the stacked scales'
  per-scale R = 129 and 2049 (its tent has no diff-hot pair, so it agrees at
  u = 1 too), and K11 at the stacked R = (129, 2049) on points below u = 1
  (at u = 1 the JAX stacked kernel takes its diff-hot pair over the table
  padded to a multiple of 8 rows; ``tests/test_torch_port_k6_design.py`` and
  ROADMAP section 3 explain the departure);
- on the finite-difference stencil's operands, built as
  ``tests/test_torch_port_k6_design.py`` builds them, with points on the
  box's faces.

prod and the residuals vsave / gdsave are held equal to the bit (no sum is
involved) in every sample but one kind. The JAX kernel builds a dense (R, BN)
tent, each row's ``r - clip(u) * (R - 1)`` rounded once (this CPU build
contracts it as the port's ``tent_coords`` does), so its two non-zeros sit at
the floor of the exact p; the port reads rows ``floor(fl(p))`` and the next
(the JAX kernel's diff-hot convention). They differ only where ``fl(p)``
rounds up onto a knot k while the exact p lies just below it: there the JAX
tent puts a weight of k - p (below ulp(p), 6e-5 at R = 2048) on row k - 1,
the port's none. The tests place samples on knots, check that such samples
occur, hold prod and the residuals equal to the bit everywhere else and
within 1e-3 x max|ref| there. enc and jac are held within 2e-2 x max|ref|
(bf16 products summed in f32, in the tensor cores' order on the card).
Also: the build log of a
library survives its building process (``cuda_build.build_log``), and a
NeuS step's K9 launches saved by ``chip_smoke.py`` ``_step_entry`` come back
through ``torch.save`` as ``tools/bwd_bench.py`` ``step_cases`` with the
same arguments. The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``, the ``k5_`` and ``k9_`` cases)."""

import importlib.util
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import cp as j_cp
from instant_nsr_pl_tpu.ops import cp_pallas as j_cpp
from instant_nsr_pl_tpu_torch.ops import cp_product as t_cpp
from instant_nsr_pl_tpu_torch.ops import cp_stacked as t_cps
from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops import cp as t_cp
from instant_nsr_pl_tpu_torch.tools import bwd_bench
from instant_nsr_pl_tpu_torch.utils.transplant import params_from_jax, params_from_state_dict

ROOT = Path(__file__).resolve().parents[1]
TILE = 64  # samples per tile of the card kernels (csrc/mma_common.cuh kT)
SIZES = [TILE - 1, TILE, TILE + 1, 6 * TILE + 1]
C, F = 16, 8  # the small test model: the tiles do not depend on C
STACKED_RES = (129, 2049)
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


def _equal(got, ref, what):
    ref = np.asarray(ref).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _close(got, ref, what, rel=2e-2):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-8),
                               err_msg=what)


def _coords(res, n, rs, below_one=False):
    """(3, n) coordinates in [-0.05, 1.05]: in the even columns exact 0, 1
    and 0.5, out-of-range values and knots spread over the whole table (as
    many as fit), in the odd ones uniform values; ``below_one`` moves u = 1
    and above just below 1."""
    u3 = rs.uniform(-0.05, 1.05, (3, n)).astype(np.float32)
    m = (n + 1) // 2
    knots = np.linspace(0, res - 1, max(m - 5, 1)).round().astype(np.float32)
    special = np.concatenate([np.array([0.0, 1.0, 0.5, -0.03, 1.04], np.float32),
                              knots / np.float32(res - 1)])[:m]
    u3[0, 0:2 * special.size:2] = special
    u3[1, 0:2 * special.size:2] = special[::-1]
    u3[2, 0:2 * special.size:2] = np.roll(special, 5)
    if below_one:
        u3 = np.minimum(u3, np.float32(1.0 - 2**-20))
    return u3


def _pair_moves(u3, res):
    """(n,) True where, on some axis, the rows the port reads (from the
    float32 ``p``) are not the two non-zero rows of the JAX kernel's dense
    tent (from the exact ``p``): ``fl(p)`` rounded up onto a knot."""
    cu = np.clip(u3, 0.0, 1.0)
    i32 = np.minimum(np.floor(cu * np.float32(res - 1)), res - 2)
    i64 = np.minimum(np.floor(cu.astype(np.float64) * (res - 1)), res - 2)
    return (i32 != i64).any(0)


def _stencil_u3(n, rs):
    """(3, n) unit-box coordinates of the finite-difference stencil
    (``tests/test_torch_port_k6_design.py``): two rays' samples in the world
    box, some on its faces, each expanded into its six points x +- EPS along
    each axis, clipped to the box and mapped to [0, 1]; the first n points."""
    m = -(-n // 6)
    ends = rs.uniform(-RADIUS, RADIUS, (2, 2, 3)).astype(np.float32)
    t = ((np.arange(m) + 0.5) / m).astype(np.float32)[:, None]
    x = np.where(np.arange(m)[:, None] < m // 2, ends[0, 0] + t * (ends[0, 1] - ends[0, 0]),
                 ends[1, 0] + t * (ends[1, 1] - ends[1, 0])).astype(np.float32)
    x[::5, 0] = -RADIUS
    x[1::7, 1] = RADIUS
    x[2::9, 2] = -RADIUS + 0.5 * EPS
    pts = np.minimum(np.maximum(x[:, None, :] + np.float32(EPS) * _STENCIL, -RADIUS), RADIUS)
    u = (pts.reshape(-1, 3) + np.float32(RADIUS)) / np.float32(2 * RADIUS)
    return np.ascontiguousarray(u[:n].T.astype(np.float32))


def _tables(res, rs):
    lines = [(rs.randn(res, C) * 0.1).astype(np.float32) for _ in range(3)]
    basis = (rs.randn(C, F) / np.sqrt(C)).astype(np.float32)
    return lines, basis


def _bitwise(got, ref, moved, what):
    """got equal to ref to the bit in the samples (last axis) whose tent rows
    agree, within 1e-3 x max|ref| in the others."""
    ref = np.asarray(ref).astype(np.float32)
    _equal(got[..., ~moved], ref[..., ~moved], what)
    _close(got, ref, what, rel=1e-3)


def _check_k5(res, u3, rs):
    """K5's plain version against _cp_product_fwd_impl: prod and vsave to the
    bit (within 1e-3 where the tent rows move). Returns the moved samples."""
    n = u3.shape[1]
    lines, _ = _tables(res, rs)
    prod, vsave = j_cpp._cp_product_fwd_impl(*[jnp.asarray(a) for a in lines],
                                             jnp.asarray(u3), res)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    t_prod, t_vsave = t_cpp.cp_product_plain(stack, _t(u3), res, save_residuals=True)
    moved = _pair_moves(u3, res)
    _bitwise(t_prod, prod, moved, "prod")
    _bitwise(t_vsave, np.asarray(vsave)[:, :, :n], moved, "vsave")
    # eval mode (no residual) gives the same prod
    assert torch.equal(t_cpp.cp_product_plain(stack, _t(u3), res), t_prod)
    return moved


def _check_k9(res, u3, rs):
    """K9's plain version against _cp_jacb_fwd_impl: the residuals to the
    bit (within 1e-3 where the tent rows move), enc and jac within 2e-2.
    Returns the moved samples."""
    n = u3.shape[1]
    lines, basis = _tables(res, rs)
    enc, jac, vsave, gdsave = j_cpp._cp_jacb_fwd_impl(*[jnp.asarray(a) for a in lines],
                                                      jnp.asarray(basis), jnp.asarray(u3), res)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    bas = _t(basis).to(torch.bfloat16)
    got = t_cpp.cp_product_jac_basis_plain(stack, bas, _t(u3), res, save_residuals=True)
    moved = _pair_moves(u3, res)
    for label, a, b in zip(("vsave", "gdsave"), got[2:], (vsave, gdsave)):
        _bitwise(a, np.asarray(b)[:, :, :n], moved, label)
    _close(got[0], enc, "enc")
    _close(got[1], jac, "jac")
    ev = t_cpp.cp_product_jac_basis_plain(stack, bas, _t(u3), res)
    assert torch.equal(ev[0], got[0]) and torch.equal(ev[1], got[1])
    return moved


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("res", [128, 2048])
def test_k5_plain_matches_jax_around_the_tile(res, n):
    rs = np.random.RandomState(res + n)
    moved = _check_k5(res, _coords(res, n, rs), rs)
    assert moved.any() and not moved.all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("res", [128, 2048])
def test_k9_plain_matches_jax_around_the_tile(res, n):
    rs = np.random.RandomState(2 * res + n)
    moved = _check_k9(res, _coords(res, n, rs), rs)
    assert moved.any() and not moved.all()


@pytest.mark.parametrize("n", [TILE + 1, 6 * TILE + 1])
@pytest.mark.parametrize("res", STACKED_RES)
def test_k5_plain_matches_jax_at_stacked_scales(res, n):
    """The stacked encoding's per-scale products (grid updates, finite
    differences) at R = 129 and 2049, not a multiple of 8, u = 1 included:
    the tent has no padded diff-hot pair, so the two agree there too."""
    rs = np.random.RandomState(3 * res + n)
    u3 = _coords(res, n, rs)
    assert (u3 == 1.0).any()
    _check_k5(res, u3, rs)


@pytest.mark.parametrize("kernel", ["k5", "k9"])
@pytest.mark.parametrize("n", [TILE + 1, 6 * TILE + 1])
@pytest.mark.parametrize("res", [128, 2048])
def test_plain_matches_jax_on_stencil_operands(res, n, kernel):
    """The finite-difference stencil's points (some on the box's faces,
    u exactly 0 and 1 after the clip)."""
    rs = np.random.RandomState(5 * res + n)
    u3 = _stencil_u3(n, rs)
    assert (u3 == 0.0).any() and (u3 == 1.0).any()
    (_check_k5 if kernel == "k5" else _check_k9)(res, u3, rs)


def _stacked_params(seed):
    """JAX CP params at the stacked scales (C=16, R=(129, 2049), F=8) and the
    port's copy of them."""
    j_spec = j_cp.CPSpec(C, STACKED_RES, F)
    params = j_cp.cp_init(jax.random.PRNGKey(seed), j_spec)
    tp = params_from_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, j_spec, tp, t_cp.CPSpec(C, STACKED_RES, F)


@pytest.mark.parametrize("n", [TILE + 1, 6 * TILE + 1])
def test_k11_plain_matches_jax_below_one(n):
    """K11's plain version against _cp_jacs_fwd_impl at the stacked scales,
    on points below u = 1 (and at and below u = 0): the residuals to the bit (within
    1e-3 where the tent rows move), enc and jac within 2e-2."""
    rs = np.random.RandomState(7 + n)
    params, j_spec, tp, t_spec = _stacked_params(n)
    rmax = max(STACKED_RES)
    u3 = _coords(rmax, n, rs, below_one=True)
    assert float(u3.max()) < 1.0 and (u3 < 0.0).any() and (u3 == 0.0).any()
    enc, jac, vsave, gdsave = j_cpp._cp_jacs_fwd_impl(params, jnp.asarray(u3), j_spec)
    lines, basis = t_cps.stack_lines_fine(tp, t_spec), t_cps.basis_stack(tp, t_spec)
    got = t_cps.cp_jac_basis_stacked_plain(lines, basis, _t(u3), rmax, save_residuals=True)
    moved = _pair_moves(u3, rmax)
    for label, a, b in zip(("vsave", "gdsave"), got[2:], (vsave, gdsave)):
        _bitwise(a, np.asarray(b)[:, :, :n], moved, label)
    _close(got[0], enc, "enc")
    _close(got[1], jac, "jac")


def test_plain_versions_without_samples():
    """N = 0: empty outputs and residuals of the right shapes."""
    rs = np.random.RandomState(0)
    lines, basis = _tables(128, rs)
    stack = t_cpp.line_stack(*[_t(a) for a in lines])
    u3 = torch.zeros((3, 0))
    prod, vsave = t_cpp.cp_product_plain(stack, u3, 128, save_residuals=True)
    assert tuple(prod.shape) == (C, 0) and tuple(vsave.shape) == (3, C, 0)
    enc, jac, v, gd = t_cpp.cp_product_jac_basis_plain(stack, _t(basis).to(torch.bfloat16), u3,
                                                       128, save_residuals=True)
    assert (tuple(enc.shape), tuple(jac.shape)) == ((F, 0), (3, F, 0))
    assert tuple(v.shape) == tuple(gd.shape) == (3, C, 0)
    _, _, tp, t_spec = _stacked_params(0)
    got = t_cps.cp_jac_basis_stacked_plain(t_cps.stack_lines_fine(tp, t_spec),
                                           t_cps.basis_stack(tp, t_spec), u3, max(STACKED_RES),
                                           save_residuals=True)
    assert [tuple(t.shape) for t in got] == [(2 * F, 0), (3, 2 * F, 0), (3, 2 * C, 0),
                                             (3, 2 * C, 0)]


class _FakeNvcc:
    """Stands in for an nvcc process: writes the library file it is asked
    for and prints ptxas-like lines."""

    def __init__(self, cmd, **_):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        self.out = f"ptxas info    : Used 40 registers, compiling {Path(cmd[-1]).name}\n"
        self.returncode = 0

    def communicate(self):
        return self.out, None


def test_build_log_survives_the_building_process(monkeypatch, tmp_path):
    """A build keeps each library's nvcc / ptxas output beside it, named by
    the same hash; a later process (``BUILD_LOG`` empty) reads it from there
    (no nvcc here: a stand-in writes the files)."""
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _FakeNvcc)
    assert cuda_build.build_log("cp_product_fwd") is None
    cuda_build.build_all()
    lib = cuda_build._library_path(cuda_build.CSRC / "cp_product_fwd.cu")
    assert lib.exists() and lib.with_suffix(".log").exists()
    assert cuda_build.build_log("cp_product_fwd") == cuda_build.BUILD_LOG["cp_product_fwd"]
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})  # a later process
    log = cuda_build.build_log("cp_jac_basis_fwd")
    assert log is not None and "Used 40 registers" in log and "cp_jac_basis_fwd.cu" in log
    # a library built with other sources or flags has another log
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", (*cuda_build.NVCC_FLAGS, "-lineinfo"))
    assert cuda_build.build_log("cp_jac_basis_fwd") is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k9_step_entry_round_trips_to_bwd_bench(monkeypatch, tmp_path):
    """A NeuS step's K9 launches (one per scale, training mode) as
    ``chip_smoke.py`` records and saves them come back from
    ``tools/bwd_bench.py`` ``step_cases`` as one case that launches each with
    the same arguments, in training mode."""
    rs = np.random.RandomState(3)
    u3 = _t(_coords(128, TILE + 1, rs))
    calls = []
    for res in (128, 2048):
        lines, basis = _tables(res, rs)
        calls.append(((t_cpp.line_stack(*[_t(a) for a in lines]),
                       _t(basis).to(torch.bfloat16), u3, res), {"train": True}))
    entry = _chip_smoke()._step_entry("cp_jac_basis_forward", calls)
    path = tmp_path / "step_operands.pt"
    torch.save({"k9": entry}, path)
    cases = bwd_bench.step_cases(str(path), torch.device("cpu"))
    assert set(cases) == {"k9"} and cases["k9"][1] == "N=65 + 65"
    seen = []

    def launch(lines, basis, u, res, train=False):
        seen.append((lines, basis, u, res, train))
        return t_cpp.cp_product_jac_basis_plain(lines, basis, u, res, save_residuals=train)

    monkeypatch.setattr(t_cpp, "cp_product_jac_basis_launch", launch)
    outs = cases["k9"][0]()
    assert len(outs) == len(seen) == 2
    for (args, _), got, out in zip(calls, seen, outs):
        assert all(torch.equal(a, b) for a, b in zip(args[:3], got[:3]))
        assert got[3:] == (args[3], True) and len(out) == 4
