"""Fused SH-encode -> concat -> bf16 ReLU MLP (the radiance head), forward and
backward.

Port of ``instant_nsr_pl_tpu/ops/sh_mlp_pallas.py`` ``sh_mlp_apply`` and its
custom VJP. On CUDA tensors the op launches the hand-written kernels
``csrc/sh_mlp_fwd.cu`` (K3) and, in its backward, ``csrc/sh_mlp_bwd.cu``
(K4); on CPU tensors it runs the plain PyTorch versions below (the forward
mirrors ``sh_mlp_reference``: composed row order, the ``ops/mlp.py`` chain).
There is no fallback from one to the other.

Input-row order: the composed path feeds the MLP ``[features | SH | extras]``
(``models/texture.py``); the kernels read ``[features | extras | padding |
SH]``, so the host permutes the first layer's rows (``_perm``) and inserts
zero rows that pad the feature block to a multiple of 8. Weights keep the
composed order everywhere else, so transplanted weights need no change;
gradients drop the padding rows and undo the permutation on the way out.

Differentiable with respect to the MLP parameters and the features
(geometry features and extras); the directions get no cotangent
(``sh_mlp_pallas.py:11-17``), and SH is recomputed in the backward.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops import cuda_build
from instant_nsr_pl_tpu_torch.ops.mlp import mlp_apply
from instant_nsr_pl_tpu_torch.ops.mlp_common import (
    mlp_backward_plain,
    mlp_wmax,
    pack_mlp,
    unpack_mlp_grads,
)
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
    in the composed MLP input (the rest follow it, e.g. NeuS normals).

    With grad mode on and the features or a parameter requiring grad, the op
    records its backward: the forward then also writes the residual (K3
    training mode) and the backward runs K4 (or the plain versions, on CPU
    tensors)."""
    n_feat = features.shape[-1]
    if not fusable(mlp_spec, n_feat, degree):
        raise ValueError(f"sh_mlp_forward: not fusable: {mlp_spec}, n_feat={n_feat}")
    flat = [t for layer in mlp_params for t in (layer["w"], layer["b"])]
    if torch.is_grad_enabled() and (features.requires_grad
                                    or any(t.requires_grad for t in flat)):
        return _SHMLP.apply(features, dirs, mlp_spec, degree, n_pre, *flat)
    if features.device.type == "cuda":
        operands = pack_sh_mlp(mlp_params, mlp_spec, degree, n_pre, n_feat)
        return sh_mlp_launch(operands, features, dirs, mlp_spec, degree)[0]
    if features.device.type == "cpu":
        return sh_mlp_forward_plain(
            mlp_params, features, dirs, mlp_spec, degree, n_pre
        )
    raise ValueError(f"sh_mlp_forward: unsupported device {features.device}")


sh_mlp_forward.launches = 0


class _SHMLP(torch.autograd.Function):
    """The op with its custom backward (``sh_mlp_apply``'s VJP). The packed
    bf16 weights are built once in the forward and handed to the backward."""

    @staticmethod
    def forward(ctx, features, dirs, mlp_spec, degree, n_pre, *flat):
        mlp_params = [{"w": flat[k], "b": flat[k + 1]} for k in range(0, len(flat), 2)]
        n_feat = features.shape[-1]
        operands = pack_sh_mlp(mlp_params, mlp_spec, degree, n_pre, n_feat)
        if features.device.type == "cuda":
            out, hsave = sh_mlp_launch(operands, features, dirs, mlp_spec, degree, train=True)
        elif features.device.type == "cpu":
            out, hsave = sh_mlp_forward_plain(
                mlp_params, features, dirs, mlp_spec, degree, n_pre, save_residuals=True
            )
        else:
            raise ValueError(f"sh_mlp_forward: unsupported device {features.device}")
        ws, _, fpad = operands
        ctx.save_for_backward(features, dirs, hsave, ws)
        ctx.args = (mlp_spec, degree, n_pre, fpad)
        ctx.layer_shapes = [tuple(layer["w"].shape) for layer in mlp_params]
        return out

    @staticmethod
    def backward(ctx, dout):
        features, dirs, hsave, ws = ctx.saved_tensors
        mlp_spec, degree, n_pre, fpad = ctx.args
        n_feat = features.shape[-1]
        dws, dbs, dfeat = sh_mlp_backward(
            features, dirs, hsave, dout.contiguous(), ws, fpad, mlp_spec, degree
        )
        if fpad > n_feat:  # drop the padding rows of the packed first layer
            dws = torch.cat([dws[:n_feat], dws[fpad:]], dim=0)
        layers = unpack_mlp_grads(dws, dbs, ctx.layer_shapes,
                                  reorder_first_rows=_perm(mlp_spec, degree, n_pre))
        grads = [t for layer in layers for t in (layer["w"], layer["b"])]
        d_features = dfeat.reshape(features.shape) if ctx.needs_input_grad[0] else None
        return (d_features, None, None, None, None, *grads)


def sh_mlp_backward(features, dirs, hsave, dout, ws, fpad, mlp_spec, degree):
    """The op's backward (K4): ``(dws, dbs, dfeat)``, the packed gradients in
    kernel row order ((fpad + SH + NH*W, Wmax), padding rows included) and
    the (N, n_feat) feature cotangent."""
    if features.device.type == "cuda":
        return sh_mlp_backward_launch(features, dirs, hsave, dout, ws, fpad, mlp_spec, degree)
    if features.device.type == "cpu":
        return sh_mlp_backward_plain(features, dirs, hsave, dout, ws, fpad, mlp_spec, degree)
    raise ValueError(f"sh_mlp_backward: unsupported device {features.device}")


sh_mlp_backward.launches = 0


def _sh_of(dirs, degree):
    d = dirs.reshape(-1, 3).float()
    return torch.stack(sh_basis(d[:, 0], d[:, 1], d[:, 2], degree), dim=-1)


def sh_mlp_forward_plain(mlp_params, features, dirs, mlp_spec, degree, n_pre,
                         save_residuals=False):
    """Plain PyTorch version: SH of the raw unit dirs in f32 (the kernel's
    ``_kernel_sh`` expressions), the composed input order
    ``[pre | SH | post]`` and the bf16 MLP chain of ``ops/mlp.py``. With
    ``save_residuals`` returns ``(out, hsave)``, hsave the (NH, W, N) bf16
    hidden activations of K3's training mode."""
    sh = _sh_of(dirs, degree)
    f = features.reshape(-1, features.shape[-1]).float()
    inp = torch.cat([f[:, :n_pre], sh, f[:, n_pre:]], dim=-1)
    hidden = [] if save_residuals else None
    out = mlp_apply(mlp_params, inp, mlp_spec, hidden=hidden)
    out = out.reshape(*features.shape[:-1], mlp_spec.dim_out)
    if not save_residuals:
        return out
    return out, torch.stack([h.T for h in hidden]).to(torch.bfloat16).contiguous()


def sh_mlp_backward_plain(features, dirs, hsave, dout, ws, fpad, mlp_spec, degree):
    """Plain PyTorch version of K4 (``_bwd_kernel``) at the TPU kernel's
    rounding points, in kernel row order: the MLP input is ``[features |
    zero padding to fpad | SH]`` and ``ws`` the packed weights of
    :func:`pack_sh_mlp`. Returns ``(dws, dbs, dfeat)`` as
    :func:`sh_mlp_backward`."""
    n_feat = features.shape[-1]
    f = features.reshape(-1, n_feat).float()
    n = f.shape[0]
    x0 = torch.cat([f, f.new_zeros((n, fpad - n_feat)), _sh_of(dirs, degree)], dim=-1)
    acts = [x0] + [h.float().T for h in hsave]
    dx0, dws, dbs = mlp_backward_plain(ws, acts, dout.reshape(n, mlp_spec.dim_out).float())
    return dws, dbs, dx0[:, :n_feat]


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
    with torch.no_grad():
        ws, bs = pack_mlp(mlp_params, wmax, reorder_first_rows=_perm(mlp_spec, degree, n_pre))
        if fpad > n_feat:
            zrows = torch.zeros((fpad - n_feat, wmax), dtype=ws.dtype, device=ws.device)
            ws = torch.cat([ws[:n_feat], zrows, ws[n_feat:]], dim=0).contiguous()
    return ws, bs, fpad


def _check_inputs(name, features, dirs):
    if features.dtype != torch.float32 or dirs.dtype != torch.float32:
        raise ValueError(f"{name}: features and dirs must be float32")
    if dirs.shape[-1] != 3 or dirs.shape[:-1] != features.shape[:-1]:
        raise ValueError(f"{name}: dirs {tuple(dirs.shape)} do not match "
                         f"features {tuple(features.shape)}")
    if dirs.device != features.device:
        raise ValueError(f"{name}: features and dirs on different devices")


def sh_mlp_launch(operands, features, dirs, mlp_spec, degree, train=False):
    """Launch ``csrc/sh_mlp_fwd.cu`` on packed ``operands`` (from
    :func:`pack_sh_mlp`) for CUDA features and dirs. Returns ``(out,
    hsave)``; the residual is written only with ``train`` (else None)."""
    ws, bs, fpad = operands
    n_feat = features.shape[-1]
    _check_inputs("sh_mlp_forward", features, dirs)
    w = mlp_wmax(mlp_spec)
    nh = mlp_spec.n_hidden_layers
    cuda_build.check_operands("sh_mlp_forward", (ws, bs),
                              ((fpad + sh_output_dim(degree) + nh * w, w), (nh + 1, w)),
                              features.device)
    feat = features.reshape(-1, n_feat).contiguous()
    d = dirs.reshape(-1, 3).contiguous()
    n = feat.shape[0]
    out = torch.empty((n, mlp_spec.dim_out), dtype=torch.float32, device=feat.device)
    hsave = (torch.empty((nh, mlp_spec.n_neurons, n), dtype=torch.bfloat16, device=feat.device)
             if train else None)
    fn = cuda_build.library("sh_mlp_fwd").sh_mlp_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(
            feat.data_ptr(), n_feat, fpad, d.data_ptr(), n, degree,
            ws.data_ptr(), bs.data_ptr(), out.data_ptr(), mlp_spec.n_neurons,
            nh, mlp_spec.dim_out, hsave.data_ptr() if train else None, stream,
        )
    cuda_build.check(rc, "sh_mlp_forward", SUPPORTED)
    sh_mlp_forward.launches += 1
    return out.reshape(*features.shape[:-1], mlp_spec.dim_out), hsave


def sh_mlp_backward_launch(features, dirs, hsave, dout, ws, fpad, mlp_spec, degree):
    """Launch ``csrc/sh_mlp_bwd.cu`` (K4) for CUDA tensors; see
    :func:`sh_mlp_backward` for the outputs. The kernel writes each block's
    partial dW and db to a (blocks, count) scratch and a second kernel sums
    them in block order. With no samples it returns zeros and launches
    nothing."""
    n_feat = features.shape[-1]
    _check_inputs("sh_mlp_backward", features, dirs)
    w = mlp_wmax(mlp_spec)
    nh = mlp_spec.n_hidden_layers
    dim_out = mlp_spec.dim_out
    feat = features.reshape(-1, n_feat).contiguous()
    d = dirs.reshape(-1, 3).contiguous()
    n = feat.shape[0]
    if dout.dtype != torch.float32:
        raise ValueError(f"sh_mlp_backward: dout must be float32, got {dout.dtype}")
    dflat = dout.reshape(n, dim_out).contiguous()
    dev = feat.device
    cuda_build.check_operands("sh_mlp_backward", (hsave, ws),
                              ((nh, mlp_spec.n_neurons, n),
                               (fpad + sh_output_dim(degree) + nh * w, w)), dev)
    rows = ws.shape[0]
    dfeat = torch.empty((n, n_feat), dtype=torch.float32, device=dev)
    if n == 0:
        return (torch.zeros((rows, w), dtype=torch.float32, device=dev),
                torch.zeros((nh + 1, w), dtype=torch.float32, device=dev), dfeat)
    fn = cuda_build.entry("sh_mlp_bwd", "sh_mlp_bwd", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(part, blocks, out, info, n_):
            return fn(feat.data_ptr(), n_feat, fpad, d.data_ptr(), n_, degree,
                      hsave.data_ptr(), dflat.data_ptr(), ws.data_ptr(), dfeat.data_ptr(),
                      part, blocks, out, info, mlp_spec.n_neurons, nh, dim_out, stream)

        out = cuda_build.launch_persistent(("sh_mlp_bwd", fpad, degree, w, nh, dim_out, dev.index),
                                           call, n, dev, "sh_mlp_backward", SUPPORTED)
    sh_mlp_backward.launches += 1
    return out[:rows * w].view(rows, w), out[rows * w:].view(nh + 1, w), dfeat
