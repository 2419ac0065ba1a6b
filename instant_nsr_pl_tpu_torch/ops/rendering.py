"""Volume-rendering compositing on packed, ray-sorted sample buffers.

Port of ``instant_nsr_pl_tpu/ops/rendering.py:142-308``: nerfacc's
``render_weight_from_density``, ``render_weight_from_alpha`` and
``accumulate_along_rays`` (reference use: models/nerf.py:105-108,
models/neus.py:237), and the MipNeRF-360 ``distortion_loss``. Samples live in the fixed-capacity packed buffer of
``ops/marching.py``: ``ray_indices`` ascending, padding slots ``valid=False``.

Segmented sums are plain PyTorch: one float64 prefix sum, read back at the
segment starts, replaces the JAX package's segmented associative scan (whose
shape was chosen for the TPU). In float64 no sum loses precision across the
segments it crosses, and the result is rounded to float32 once.

Gradients are autograd's through these ops (nothing here works in place),
but for the two segmented sums: :class:`SegmentSumSorted` carries the JAX
custom VJP (JAX twin ``ops/rendering.py:44-81``), which hands each packed
row its ray's cotangent in one gather, and :class:`SegmentedInclusiveCumsum`
(the transmittance and the distortion loss) differentiates by the same
prefix difference read from the right; autograd would difference the float64
prefix sums' scattered cotangents in both.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from instant_nsr_pl_tpu_torch.ops.activations import clip


def segmented_inclusive_prefix(flags, x):
    """Inclusive cumsum of ``x`` (N,) restarting wherever ``flags`` is True
    (entries before the first flag form one segment from the start): one
    float64 prefix sum, less its value before each segment's start, rounded
    to float32 once. Returns it with the segment starts and each entry's
    segment number. The forward of :class:`SegmentedInclusiveCumsum`;
    called directly, autograd differentiates it (the reference its backward
    is held to)."""
    c = torch.cumsum(x.double(), dim=0)
    starts = torch.nonzero(flags).reshape(-1)
    base = torch.cat([c.new_zeros(1), (c - x.double())[starts]])
    seg = torch.cumsum(flags.long(), dim=0)
    return (c - base[seg]).float(), starts, seg


class SegmentedInclusiveCumsum(torch.autograd.Function):
    """:func:`segmented_inclusive_prefix` with the backward of a segmented
    inclusive sum: the segmented inclusive sum of the cotangent read from
    the right, ``dx_i = sum_{j >= i in i's segment} g_j``, by the same
    float64 prefix difference, ``C[end(i)] - C[i]`` over the cotangent's
    prefix ``C`` with a leading zero: two gathers. Autograd's backward of
    the forward's gathers ``(c - x)[starts]`` and ``base[seg]`` is a float64
    scatter (PyTorch's sorting ``indexing_backward_kernel`` on the card)."""

    @staticmethod
    def forward(ctx, flags, x):
        out, starts, seg = segmented_inclusive_prefix(flags, x)
        ctx.save_for_backward(starts, seg)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        starts, seg = ctx.saved_tensors
        c = torch.cumsum(g.double(), dim=0)
        c = torch.cat([c.new_zeros(1), c])
        # segment s ends (exclusive) where segment s + 1 starts, the last at N
        ends = torch.cat([starts, starts.new_full((1,), g.shape[0])])
        return None, (c[ends[seg]] - c[:-1]).float()


_segmented_inclusive_cumsum = SegmentedInclusiveCumsum.apply  # (flags (N,), x (N,)) -> (N,)


def _segment_starts(ray_indices, valid):
    """Flags marking the first valid sample of each ray segment."""
    prev = torch.cat([ray_indices.new_full((1,), -1), ray_indices[:-1]])
    return (ray_indices != prev) & valid


def segmented_cumsum(x, ray_indices, valid, exclusive=False, group=1):
    """Per-ray cumulative sum over a packed, ray-sorted buffer; invalid
    entries contribute zero.

    ``group=k > 1`` relies on every ALIGNED block of k entries belonging to
    one ray (the group-compacted march layout): a within-block cumsum plus a
    segmented cumsum over block totals."""
    x = torch.where(valid, x, torch.zeros_like(x))
    if group > 1:
        cap = x.shape[0]
        if cap % group:
            raise ValueError(f"capacity {cap} is not a multiple of group {group}")
        g = cap // group
        incl_in = torch.cumsum(x.reshape(g, group), dim=1)
        totals = incl_in[:, -1]
        gray = ray_indices.reshape(g, group)[:, 0]
        prev = torch.cat([gray.new_full((1,), -1), gray[:-1]])
        incl_tot = _segmented_inclusive_cumsum(gray != prev, totals)
        out = (incl_in + (incl_tot - totals)[:, None]).reshape(-1)
    else:
        out = _segmented_inclusive_cumsum(_segment_starts(ray_indices, valid), x)
    return out - x if exclusive else out


def exclusive_cumprod_segments(alpha, ray_indices, valid, eps=1e-10, group=1):
    """Per-ray exclusive cumulative product of (1 - alpha): the transmittance
    T_i = prod_{j<i in the same ray} (1 - alpha_j), through log(clip(1 -
    alpha, eps, 1))."""
    # a tie is common here: alpha = 0 gives 1 - alpha = 1 exactly
    log1m = torch.log(clip(1.0 - alpha, eps, 1.0))
    excl = segmented_cumsum(log1m, ray_indices, valid, exclusive=True, group=group)
    return torch.exp(excl)


def render_weight_from_density(t_starts, t_ends, sigma, ray_indices, valid, group=1):
    """Weights w_i = alpha_i * T_i with alpha = 1 - exp(-sigma * dt) and the
    per-ray transmittance T_i = prod_{j<i} (1 - alpha_j) (eps 1e-10)."""
    dt = t_ends - t_starts
    alpha = 1.0 - torch.exp(-sigma * dt)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    return alpha * exclusive_cumprod_segments(alpha, ray_indices, valid, group=group)


def render_weight_from_alpha(alpha, ray_indices, valid, group=1):
    """Weights from per-sample alphas (the NeuS path; reference
    models/neus.py:237)."""
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    return alpha * exclusive_cumprod_segments(alpha, ray_indices, valid, group=group)


def segment_sum_prefix(src, ends):
    """Per-ray sums of ray-sorted rows: ``src`` (G, D), ``ends`` (n_rays,)
    the exclusive row offset where each ray's run ends (ray r owns rows
    ``[ends[r - 1], ends[r])``) -> (n_rays, D): one float64 prefix sum along
    the rows, differenced at each ray's ends and rounded to float32 once;
    rays without rows get zero. The forward of :class:`SegmentSumSorted`;
    called directly, autograd differentiates it (the backward it had before
    the custom VJP, the reference the VJP is held to)."""
    # (D, G) layout: the prefix sum runs along the innermost dimension.
    # Along the outer one PyTorch's CUDA scan took 84.9 ms per 256x256 view
    # on an H100, against 0.8 ms here (scripts/profile_torch_render.py)
    c = torch.cumsum(src.T.contiguous().double(), dim=1)
    c = torch.cat([c.new_zeros((c.shape[0], 1)), c], dim=1)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    out = (c[:, ends] - c[:, starts]).T.float()
    return torch.where((ends > starts)[:, None], out, torch.zeros_like(out))


class SegmentSumSorted(torch.autograd.Function):
    """:func:`segment_sum_prefix` with the JAX package's VJP
    (``segment_sum_sorted``, ``_sss_bwd``): each row gets its ray's
    cotangent, ``ct[row_rays]``, one gather with no host synchronisation
    (the ray of row i is the count of ``ends`` <= i). Rows past
    ``ends[-1]`` (padding) get the last ray's cotangent, as JAX's padding
    rows (ray id n_rays - 1) do; callers zero them through their ``valid``
    mask."""

    @staticmethod
    def forward(ctx, src, ends):
        ctx.save_for_backward(ends)
        ctx.rows = src.shape[0]
        return segment_sum_prefix(src, ends)

    @staticmethod
    def backward(ctx, ct):
        (ends,) = ctx.saved_tensors
        rows = torch.arange(ctx.rows, device=ends.device, dtype=ends.dtype)
        ray = torch.searchsorted(ends, rows, right=True).clamp_(max=ends.shape[0] - 1)
        return ct[ray], None


segment_sum_sorted = SegmentSumSorted.apply  # (src (G, D), ends (n_rays,)) -> (n_rays, D)


def accumulate_along_rays(weights, values, ends, valid=None, group=1):
    """Per-ray sum of ``weights * values`` (CAP, D) -> (n_rays, D).

    ``ends``: ``PackedSamples.ray_ends``, the exclusive slot offset where
    each ray's run of packed slots ends (:func:`segment_sum_sorted`).
    ``group``: block size k of the single-ray-per-aligned-block layout;
    blocks are summed first. The mask and the block sum stay in autograd."""
    if valid is not None:
        weights = torch.where(valid, weights, torch.zeros_like(weights))
    src = weights[:, None] * values
    if group > 1:
        cap, d = src.shape
        if cap % group:
            raise ValueError(f"capacity {cap} is not a multiple of group {group}")
        g = cap // group
        src = src.reshape(g, group, d).sum(dim=1)
        ends = ends // group
    return segment_sum_sorted(src, ends)


def distortion_loss(weights, midpoints, intervals, ray_indices, valid, n_rays, group=1):
    """MipNeRF-360 distortion loss on packed samples in O(N) with segmented
    prefix sums (the role of ``torch_efficient_distloss.flatten_eff_distloss``;
    reference systems/nerf.py:104, systems/neus.py:132,137):

        loss = mean_rays[ sum_ij w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 d_i ]

    whose pairwise term, for samples sorted by t, is ``2 * sum_i w_i (m_i *
    W_{<i} - (wm)_{<i})``."""
    w = torch.where(valid, weights, torch.zeros_like(weights))
    wm = w * midpoints
    w_prefix = segmented_cumsum(w, ray_indices, valid, exclusive=True, group=group)
    wm_prefix = segmented_cumsum(wm, ray_indices, valid, exclusive=True, group=group)
    loss_bi = 2.0 * (w * (midpoints * w_prefix - wm_prefix))
    loss_uni = (1.0 / 3.0) * (w * w * intervals)
    total = torch.where(valid, loss_bi + loss_uni, torch.zeros_like(loss_bi)).sum()
    return total / n_rays
