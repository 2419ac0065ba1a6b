"""Packed-MLP layout shared by the fused kernels (host side).

Port of ``instant_nsr_pl_tpu/ops/mlp_pallas_common.py:24-45``. The fused
density kernel (``csrc/cp_mlp_fwd.cu``) and the fused radiance kernel
(``csrc/sh_mlp_fwd.cu``) both end in the same bf16 ReLU MLP chain, run by
``csrc/mlp_common.cuh``. Layer weights are packed into one (sum d_in, Wmax)
bf16 matrix whose columns beyond each layer's true d_out are zero, and the
biases into one (L, Wmax) f32 matrix, so the device code reads static row
ranges and the padded columns stay exact zeros.
"""

from __future__ import annotations

import torch


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

