"""VM2's merge window (``csrc/vm_bwd.cu``), emulated on the CPU by
``instant_nsr_pl_tpu_torch/tools/bwd_bench.py`` ``vm_window_merge`` /
``vm_emulated_backward``: each lane group walks a run of 16 consecutive
samples on one plane, a tap on one of the previous sample's rows takes over
that row's running sum, and a row no tap takes over is added with one atomic.

The emulated table gradients against ``jax.vjp`` of the JAX package's
``vm_encode_fast`` (``instant_nsr_pl_tpu/ops/vm.py``, its two-sort segment
sum), at ``VMSpec(C=4, plane 16, line 32, 2 scales)`` (``tests/test_vm.py``)
and at C = 8 with 1 scale, on ray-ordered samples with long runs on one
point (whole warps' runs in one cell, runs that cross the runs' and the
tiles' boundaries), samples on the cells' edges and at u = 0 and 1, and N =
0, 1, 15, 16, 17, 129 and 3 x 128 + 5 (runs of 16, tiles of 128 and 512
samples). One jitted JAX VJP per spec, at the largest N: the gradient of the
first n samples is that of all with the others' cotangents zeroed.

Tolerances: the table gradients within rtol 2e-4 / atol 2e-5 of JAX's
(``tests/test_vm.py:69``, as ``tests/test_torch_port_vm.py``). The number of
atomics: on samples along straight rays the window leaves exactly the
distinct rows of each run (a row left behind is never met again), and
every run adds at least one row per tap slot."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nsr_pl_tpu.ops import vm as j_vm
from instant_nsr_pl_tpu_torch.ops import vm as t_vm
from instant_nsr_pl_tpu_torch.tools import bwd_bench

SPECS = {
    "c4": dict(n_components=4, plane_resolution=16, line_resolution=32, n_scales=2),
    "c8": dict(n_components=8, plane_resolution=24, line_resolution=40, n_scales=1),
}
SIZES = (0, 1, 15, 16, 17, 129, 3 * 128 + 5)
N = max(SIZES)
RUN = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(rs, n, per_ray=40):
    """n samples along straight rays across the unit box, per_ray evenly
    spaced samples a ray, in ray order."""
    out = []
    while sum(len(r) for r in out) < n:
        o, d = rs.rand(3), rs.randn(3)
        d /= np.linalg.norm(d)
        t = np.linspace(0.0, 0.6, per_ray)[:, None]
        out.append(np.clip(o + t * d, 0.0, 1.0))
    return np.concatenate(out)[:n].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name):
    """Numpy tables, N ray-ordered positions with special runs, cotangents."""
    kw = SPECS[name]
    spec = t_vm.VMSpec(**kw)
    rs = np.random.RandomState(len(name) + kw["n_components"])
    params = {}
    for s in range(spec.n_scales):
        rp = spec.plane_res(s)
        for k in range(3):
            params[f"plane_{s}_{k}"] = rs.randn(rp * rp, kw["n_components"]).astype(np.float32)
            params[f"line_{s}_{k}"] = (1.0 + 0.3 * rs.randn(kw["line_resolution"],
                                                            kw["n_components"])).astype(np.float32)
    x = _rays(rs, N)
    x[:6] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.25, 0.0],
             [0.5, 1.0, 1.0], [1 / 15, 0.5, 1.0]]
    x[6:12] = np.array([3, 5, 7]) / np.array([kw["plane_resolution"] - 1] * 2
                                              + [kw["line_resolution"] - 1])  # cell edges
    x[12:12 + 2 * RUN + 3] = [0.3, 0.6, 0.2]  # a run on one point across two runs' ends
    x[128 - 40:128 + 40] = [0.71, 0.05, 0.9]  # one cell across the first tile's end
    ct = rs.randn(N, spec.n_output_dims).astype(np.float32)
    jspec = j_vm.VMSpec(**kw)
    vjp = jax.jit(lambda p, xx, c: jax.vjp(lambda pp: j_vm.vm_encode_fast(pp, xx, jspec), p)[1](c))
    return spec, params, x, ct, vjp


@pytest.mark.parametrize("name", sorted(SPECS))
def test_merge_window_matches_jax(name):
    """The emulated VM2 table gradients of the first n samples against
    ``jax.vjp`` of JAX ``vm_encode_fast`` for every n of SIZES."""
    spec, params, x, ct, vjp = _case(name)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for n in SIZES:
        cz = ct.copy()
        cz[n:] = 0.0
        (ref,) = vjp(jp, jnp.asarray(x), jnp.asarray(cz))
        got, atomics = bwd_bench.vm_emulated_backward(tp, torch.from_numpy(x[:n]),
                                                      torch.from_numpy(ct[:n]), spec, RUN)
        for k in spec.keys():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{name} n={n} {k}")
            slots = 4 if k.startswith("plane") else 2
            runs = -(-n // RUN)
            assert runs * slots <= atomics[k] <= n * slots, (n, k, atomics[k])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_merge_window_leaves_distinct_rows_on_rays(name):
    """Along straight rays the window adds each distinct row of a run once:
    its atomics equal the distinct rows of each run of 16 samples, fewer
    than one per tap and sample."""
    spec, _, x, _, _ = _case(name)
    x = torch.from_numpy(_rays(np.random.RandomState(7), 40 * RUN, per_ray=RUN * 5))
    for s in range(spec.n_scales):
        for axes in t_vm.VMSpec.AXES:
            for rows, _ in (t_vm._plane_taps(x, axes, spec.plane_res(s)),
                            t_vm._line_taps(x, axes, spec.line_resolution)):
                flushed, _ = bwd_bench.vm_window_merge(rows, run=RUN)
                per_run = rows.reshape(rows.shape[0], -1, RUN).permute(1, 0, 2)
                distinct = sum(len(torch.unique(r)) for r in per_run)  # per run of 16
                assert flushed.numel() == distinct < rows.numel()
