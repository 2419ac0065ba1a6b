"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA on a machine without it raises instead of
    carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "instant_nsr_pl_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return dev
