"""Losses and image metrics: weighted MSE, L1 and smooth-L1 losses, PSNR,
SSIM and the clamped binary cross-entropy.

Port of ``instant_nsr_pl_tpu/systems/criterions.py`` (reference
systems/criterions.py:7-159).
"""

from __future__ import annotations

import torch

from instant_nsr_pl_tpu_torch.ops.activations import clip


def weighted_loss(per_elem, weight=None, reduction="mean"):
    """Apply an optional elementwise weight, then reduce ('mean', 'sum' or
    'none'; reference WeightedLoss, systems/criterions.py:7-31)."""
    if weight is not None:
        per_elem = per_elem * weight
    if reduction == "mean":
        return per_elem.mean()
    if reduction == "sum":
        return per_elem.sum()
    return per_elem


def mse_loss(pred, target, weight=None, reduction="mean"):
    return weighted_loss((pred - target) ** 2, weight, reduction)


def l1_loss(pred, target, weight=None, reduction="mean"):
    return weighted_loss((pred - target).abs(), weight, reduction)


def binary_cross_entropy(pred, target, eps=1e-6):
    """BCE on probabilities clipped to [eps, 1 - eps] (reference
    systems/criterions.py:155-159)."""
    pred = clip(pred, eps, 1.0 - eps)
    return -(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred)).mean()


def smooth_l1_loss(pred, target, beta=1.0, weight=None, reduction="mean"):
    """Huber / smooth-L1 with torch's F.smooth_l1_loss semantics, the NeRF
    rgb loss (reference systems/nerf.py:97)."""
    d = (pred - target).abs()
    per = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return weighted_loss(per, weight, reduction)


def psnr(pred, target, valid_mask=None, reduction="mean"):
    """-10 log10(mse) (reference systems/criterions.py:40-52)."""
    se = (pred - target) ** 2
    if valid_mask is not None:
        se = torch.where(valid_mask, se, torch.full_like(se, float("nan")))
        mse = se.nanmean() if reduction == "mean" else se.nansum()
    else:
        mse = se.mean() if reduction == "mean" else se.sum()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int, sigma: float, dtype, device):
    x = torch.arange(size, dtype=dtype, device=device) - size // 2
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5, data_range=1.0):
    """Mean SSIM over an (H, W, C) or (H, W) image pair in [0, data_range]:
    an 11x11 gaussian window with reflect padding, as the torch
    implementation the reference vendors.

    Computed in float64: the blur(x^2) - mu^2 variance is a cancellation,
    and a float32 convolution on the card may run in TF32 (about three
    decimal digits), which can push SSIM above 1."""
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    x1 = img1.double() / data_range
    x2 = img2.double() / data_range
    ch = x1.shape[-1]
    g = _gaussian_window(window_size, sigma, torch.float64, x1.device)
    kernel = torch.outer(g, g).expand(ch, 1, window_size, window_size)
    pad = window_size // 2

    def blur(x):  # (H, W, C) -> (H, W, C), depthwise
        t = x.permute(2, 0, 1)[None]
        t = torch.nn.functional.pad(t, (pad, pad, pad, pad), mode="reflect")
        return torch.nn.functional.conv2d(t, kernel, groups=ch)[0].permute(1, 2, 0)

    mu1, mu2 = blur(x1), blur(x2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(x1 * x1) - mu1_sq
    s2 = blur(x2 * x2) - mu2_sq
    s12 = blur(x1 * x2) - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    )
    return ssim_map.mean().float()
