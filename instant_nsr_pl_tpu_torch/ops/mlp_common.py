"""Packed-MLP layout shared by the fused kernels (host side), and the plain
version of the backward chain.

Port of ``instant_nsr_pl_tpu/ops/mlp_pallas_common.py:24-141``. The fused
density kernels (``csrc/cp_mlp_{fwd,bwd}.cu``) and the fused radiance kernels
(``csrc/sh_mlp_{fwd,bwd}.cu``) all run the same bf16 ReLU MLP chain, on the
tensor cores (``csrc/mma_common.cuh``). Layer weights are packed into one
(sum d_in, Wmax) bf16 matrix whose columns beyond each layer's true d_out are zero, and the
biases into one (L, Wmax) f32 matrix, so the device code reads static row
ranges and the padded columns stay exact zeros. Gradients come back in the
same packed layout and are sliced apart by :func:`unpack_mlp_grads`.
"""

from __future__ import annotations

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops.mlp import bf16_round


_PACKED: dict = {}


def packed_once(name, tensors, key, build):
    """``build()``, the kernels' packed operands of these parameter tensors,
    built once per version of them: while every tensor is the same object at
    the same ``Tensor._version`` (which every in-place update bumps, an
    optimizer step included), the chunks of a rendered view or of an export's
    vertex colours reuse one pack. One entry per ``name``; it keeps the
    tensors alive, so no new tensor can take their storage and version."""
    tensors = tuple(tensors)
    versions = tuple(t._version for t in tensors)
    hit = _PACKED.get(name)
    if (hit is not None and hit[2] == key and hit[1] == versions and len(hit[0]) == len(tensors)
            and all(a is b for a, b in zip(hit[0], tensors))):
        return hit[3]
    out = build()
    _PACKED[name] = (tensors, versions, key, out)
    return out


def mlp_wmax(mlp_spec) -> int:
    return max(mlp_spec.n_neurons, mlp_spec.dim_out)


def pack_mlp(mlp_params, wmax, reorder_first_rows=None):
    """Pack layer weights into (sum d_in, Wmax) bf16 and biases into
    (L, Wmax) f32.

    ``reorder_first_rows``: optional index sequence permuting the FIRST
    layer's input rows, for kernels that assemble the MLP input in another
    order than the composed path."""
    ws, bs = [], []
    for li, layer in enumerate(mlp_params):
        w, b = layer["w"].float(), layer["b"].float()
        if li == 0 and reorder_first_rows is not None:
            w = w[torch.as_tensor(reorder_first_rows, device=w.device).long()]
        d_out = w.shape[1]
        ws.append(torch.nn.functional.pad(w, (0, wmax - d_out)))
        bs.append(torch.nn.functional.pad(b, (0, wmax - d_out))[None, :])
    return (
        torch.cat(ws, dim=0).to(torch.bfloat16).contiguous(),
        torch.cat(bs, dim=0).contiguous(),
    )



def unpack_mlp_grads(dws, dbs, layer_shapes, reorder_first_rows=None):
    """Slice packed gradients (sum d_in, Wmax) and (L, Wmax) back into the
    layer list ``[{"w": (d_in, d_out), "b": (d_out,)}, ...]`` of
    ``layer_shapes`` ((d_in, d_out) per layer), undoing a first-layer row
    reorder applied at pack time (row k of the packed block is row
    ``reorder_first_rows[k]`` of the layer)."""
    out = []
    row = 0
    for li, (d_in, d_out) in enumerate(layer_shapes):
        dw = dws[row:row + d_in, :d_out]
        if li == 0 and reorder_first_rows is not None:
            inv = np.argsort(np.asarray(reorder_first_rows))
            dw = dw[torch.as_tensor(inv, device=dw.device)]
        out.append({"w": dw, "b": dbs[li, :d_out]})
        row += d_in
    return out


def mlp_backward_plain(ws, acts, dout):
    """Plain PyTorch version of the backward chain (``kernel_mlp_bwd``) at
    its rounding points, in the (N, features) layout.

    Args:
      ws: the packed (sum d_in, Wmax) bf16 weights.
      acts: per layer its (N, d_in) f32 input: the first layer's (unrounded)
        and each hidden activation (bf16 values, post-ReLU).
      dout: (N, D) f32 output cotangent, D <= Wmax.
    Returns ``(d_x0, dws, dbs)``: the first-layer input cotangent (N, d_in0)
    f32, and the packed (sum d_in, Wmax) and (L, Wmax) f32 gradients:
    dW = bf16(a)^T bf16(g), db = sum g, g_in = bf16(g) W^T masked by a > 0.
    """
    wmax = ws.shape[1]
    n = dout.shape[0]
    g = torch.zeros((n, wmax), dtype=torch.float32, device=dout.device)
    g[:, :dout.shape[1]] = dout
    rows = [a.shape[1] for a in acts]
    row_of = np.concatenate([[0], np.cumsum(rows)]).tolist()
    dws = torch.zeros((row_of[-1], wmax), dtype=torch.float32, device=dout.device)
    dbs = torch.zeros((len(acts), wmax), dtype=torch.float32, device=dout.device)
    wf = ws.float()
    for li in range(len(acts) - 1, -1, -1):
        a = acts[li]
        gr = bf16_round(g)
        dws[row_of[li]:row_of[li + 1]] = bf16_round(a).T @ gr
        dbs[li] = g.sum(dim=0)
        g_in = gr @ wf[row_of[li]:row_of[li + 1]].T
        if li == 0:
            return g_in, dws, dbs
        g = g_in * (a > 0)
