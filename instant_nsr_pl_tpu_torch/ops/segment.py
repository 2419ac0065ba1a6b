"""Dense per-row sums of sparse updates.

Port of ``instant_nsr_pl_tpu/ops/segment.py`` ``segment_sum_dense_sorted``
(:28). The JAX package computes ``grad[r] = sum_{m: rows[m] = r} values[m]``
with two sorts, because XLA lowers a scatter-add to a serial loop on the TPU.
On the card and the CPU one ``index_add_`` is the same function, so the port
keeps the name and the signature and sums with it. The VM encoding's plain
backward (``ops/vm.py`` ``vm_backward_plain``) uses it; its kernel VM2 adds
with float atomics instead.
"""

from __future__ import annotations

import torch


def segment_sum_dense_sorted(rows, values, num_rows, feature_major=False):
    """Dense ``grad[r] = sum_{m: rows[m] = r} values[m]``.

    Args:
      rows: (M,) integer rows in [0, num_rows).
      values: (M, C) floats.
      num_rows: output row count.
      feature_major: return (C, num_rows) instead of (num_rows, C).
    Returns:
      (num_rows, C) in ``values``' dtype, or its transpose when
      ``feature_major``.
    """
    out = torch.zeros((int(num_rows), values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, rows.reshape(-1).long(), values)
    return out.T if feature_major else out
