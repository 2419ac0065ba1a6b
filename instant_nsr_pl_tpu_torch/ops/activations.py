"""Activation DSL and numerics helpers.

Port of ``instant_nsr_pl_tpu/ops/activations.py`` (reference:
models/utils.py:53-119). The string DSL mirrors ``get_activation``
(none/scaleN/clampN/mulN/lin2srgb/trunc_exp/+-float/sigmoid/tanh/softplus/
relu/exp). ``trunc_exp`` keeps the reference's clamped backward.
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def trunc_exp(x):
    """exp(x) whose gradient is g * exp(min(x, 15)), so it never explodes
    (reference models/utils.py:53-68; JAX twin ops/activations.py:16-32)."""
    return _TruncExp.apply(x)


def clip(x, lo, hi):
    """jnp.clip as min(max(x, lo), hi): at a tie the gradient splits in half,
    as in JAX, where torch.clamp passes it whole."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def scale_anything(x, inp_scale, tgt_scale):
    """Affine remap of x from inp_scale=(lo,hi) to tgt_scale=(lo,hi)
    (reference: models/utils.py:100-105, explicit-range form)."""
    lo, hi = inp_scale
    tlo, thi = tgt_scale
    x = (x - lo) / (hi - lo)
    return x * (thi - tlo) + tlo


def lin2srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(
        x > 0.0031308,
        torch.pow(torch.clamp(x, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * x,
    )


def get_activation(name):
    """String -> elementwise activation fn (reference: models/utils.py:71-97)."""
    if name is None:
        return lambda x: x
    name_lower = str(name).lower()
    if name_lower == "none":
        return lambda x: x
    if name_lower.startswith("scale"):
        scale = float(name_lower[5:])
        return lambda x: x / scale
    if name_lower.startswith("clamp"):
        clamp_max = float(name_lower[5:])
        return lambda x: torch.clamp(x, 0.0, clamp_max)
    if name_lower.startswith("mul"):
        mul = float(name_lower[3:])
        return lambda x: x * mul
    if name_lower == "lin2srgb":
        return lin2srgb
    if name_lower == "trunc_exp":
        return trunc_exp
    if name_lower.startswith("+") or name_lower.startswith("-"):
        delta = float(name_lower)
        return lambda x: x + delta
    if name_lower in ("sigmoid", "sigmoid_mul"):
        return torch.sigmoid
    if name_lower == "tanh":
        return torch.tanh
    if name_lower == "softplus":
        return torch.nn.functional.softplus
    if name_lower == "relu":
        return torch.relu
    if name_lower == "exp":
        return torch.exp
    raise ValueError(f"Unknown activation '{name}'")


def elementwise_jvp(fn, x, tangents):
    """(fn(x), the directional derivatives of the elementwise ``fn`` at x
    along each of ``tangents`` (K, *x.shape)), by forward-mode autograd; the
    derivatives stay differentiable by reverse mode."""
    import torch.autograd.forward_ad as fwad

    outs = []
    for t in tangents:
        with fwad.dual_level():
            y = fn(fwad.make_dual(x, t))
            primal, tangent = fwad.unpack_dual(y)
        outs.append(tangent if tangent is not None else torch.zeros_like(primal))
    return primal, torch.stack(outs)
