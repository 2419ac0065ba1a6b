"""Fused SH-encode -> concat -> bf16 ReLU MLP forward (the radiance head).

Port of ``instant_nsr_pl_tpu/ops/sh_mlp_pallas.py`` ``sh_mlp_apply``,
forward only. On a CUDA tensor the op launches the hand-written kernel
``csrc/sh_mlp_fwd.cu``; on a CPU tensor it runs the plain PyTorch version
below, which mirrors ``sh_mlp_reference`` (composed row order, the
``ops/mlp.py`` chain). There is no fallback from one to the other.

Input-row order: the composed path feeds the MLP ``[features | SH | extras]``
(``models/texture.py``); the kernel reads ``[features | extras | padding |
SH]``, so the host permutes the first layer's rows (``_perm``) and inserts
zero rows that pad the feature block to a multiple of 8. Weights keep the
composed order everywhere else, so transplanted weights need no change.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.mlp import mlp_apply
from instant_nsr_pl_tpu_torch.ops.mlp_common import mlp_wmax, pack_mlp
from instant_nsr_pl_tpu_torch.ops.sh import sh_basis, sh_output_dim

SUPPORTED = ("(padded features, degree, width, hidden layers, D) in "
             "{(16, 4, 64, 2, 3), (16, 4, 32, 2, 3), (24, 4, 32, 2, 3)}")


def fusable(mlp_spec, n_feat: int, degree: int) -> bool:
    """Static check for the fused radiance op. ``n_feat`` counts ALL feature
    columns (features + extras)."""
    return (
        1 <= degree <= 4
        and mlp_spec.dim_in == n_feat + sh_output_dim(degree)
        and mlp_spec.n_neurons % 8 == 0
        and mlp_spec.dim_out <= mlp_spec.n_neurons
        and mlp_spec.activation.lower() == "relu"
        and mlp_spec.precision == "bf16"
        and not mlp_spec.weight_norm
        and not mlp_spec.sphere_init
        and mlp_spec.n_hidden_layers >= 1
    )


def sh_mlp_forward(mlp_params, features, dirs, mlp_spec, degree, n_pre):
    """Fused radiance eval: (..., F) features + (..., 3) unit dirs ->
    (..., D) float32. ``n_pre``: how many feature columns precede the SH block
    in the composed MLP input (the rest follow it, e.g. NeuS normals)."""
    if features.device.type == "cuda":
        n_feat = features.shape[-1]
        if not fusable(mlp_spec, n_feat, degree):
            raise ValueError(f"sh_mlp_forward: not fusable: {mlp_spec}, n_feat={n_feat}")
        operands = pack_sh_mlp(mlp_params, mlp_spec, degree, n_pre, n_feat)
        return sh_mlp_launch(operands, features, dirs, mlp_spec, degree)
    if features.device.type == "cpu":
        return sh_mlp_forward_plain(
            mlp_params, features, dirs, mlp_spec, degree, n_pre
        )
    raise ValueError(f"sh_mlp_forward: unsupported device {features.device}")


sh_mlp_forward.launches = 0


def sh_mlp_forward_plain(mlp_params, features, dirs, mlp_spec, degree, n_pre):
    """Plain PyTorch version: SH of the raw unit dirs in f32 (the kernel's
    ``_kernel_sh`` expressions), the composed input order
    ``[pre | SH | post]`` and the bf16 MLP chain of ``ops/mlp.py``."""
    d = dirs.reshape(-1, 3).float()
    sh = torch.stack(sh_basis(d[:, 0], d[:, 1], d[:, 2], degree), dim=-1)
    f = features.reshape(-1, features.shape[-1]).float()
    inp = torch.cat([f[:, :n_pre], sh, f[:, n_pre:]], dim=-1)
    out = mlp_apply(mlp_params, inp, mlp_spec)
    return out.reshape(*features.shape[:-1], mlp_spec.dim_out)


def _perm(mlp_spec, degree, n_pre):
    """Permutation p with w_packed = w[p]: kernel row order
    [pre-features, post-features (extras), SH]."""
    s = sh_output_dim(degree)
    pre = list(range(n_pre))
    sh_rows = list(range(n_pre, n_pre + s))
    post = list(range(n_pre + s, mlp_spec.dim_in))
    return np.array(pre + post + sh_rows, dtype=np.int64)


def pack_sh_mlp(mlp_params, mlp_spec, degree, n_pre, n_feat):
    """Packed (rows, Wmax) bf16 weights in kernel order, with zero rows
    padding the feature block to ``fpad`` (a multiple of 8), and the biases."""
    fpad = -(-n_feat // 8) * 8
    wmax = mlp_wmax(mlp_spec)
    ws, bs = pack_mlp(mlp_params, wmax, reorder_first_rows=_perm(mlp_spec, degree, n_pre))
    if fpad > n_feat:
        zrows = torch.zeros((fpad - n_feat, wmax), dtype=ws.dtype, device=ws.device)
        ws = torch.cat([ws[:n_feat], zrows, ws[n_feat:]], dim=0).contiguous()
    return ws, bs, fpad


def sh_mlp_launch(operands, features, dirs, mlp_spec, degree):
    """Launch ``csrc/sh_mlp_fwd.cu`` on packed ``operands`` (from
    :func:`pack_sh_mlp`) for CUDA features and dirs."""
    ws, bs, fpad = operands
    n_feat = features.shape[-1]
    if features.dtype != torch.float32 or dirs.dtype != torch.float32:
        raise ValueError("sh_mlp_forward: features and dirs must be float32")
    if dirs.shape[-1] != 3 or dirs.shape[:-1] != features.shape[:-1]:
        raise ValueError(f"sh_mlp_forward: dirs {tuple(dirs.shape)} do not match "
                         f"features {tuple(features.shape)}")
    w = mlp_wmax(mlp_spec)
    expect = [(fpad + sh_output_dim(degree) + mlp_spec.n_hidden_layers * w, w),
              (mlp_spec.n_hidden_layers + 1, w)]
    for t, shape in zip((ws, bs), expect):
        if t.device != features.device or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"sh_mlp_forward: operand {tuple(t.shape)} on {t.device} "
                             f"does not match {shape} contiguous on {features.device}")
    if dirs.device != features.device:
        raise ValueError("sh_mlp_forward: features and dirs on different devices")
    feat = features.reshape(-1, n_feat).contiguous()
    d = dirs.reshape(-1, 3).contiguous()
    n = feat.shape[0]
    out = torch.empty((n, mlp_spec.dim_out), dtype=torch.float32, device=feat.device)
    fn = cuda_build.library("sh_mlp_fwd").sh_mlp_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(
            feat.data_ptr(), n_feat, fpad, d.data_ptr(), n, degree,
            ws.data_ptr(), bs.data_ptr(), out.data_ptr(), mlp_spec.n_neurons,
            mlp_spec.n_hidden_layers, mlp_spec.dim_out, stream,
        )
    cuda_build.check(rc, "sh_mlp_forward", SUPPORTED)
    sh_mlp_forward.launches += 1
    return out.reshape(*features.shape[:-1], mlp_spec.dim_out)
