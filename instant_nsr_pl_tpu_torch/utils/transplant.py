"""Carry parameters and occupancy grids from the JAX package to the port.

The port keeps the JAX pytree's keys and layouts (``line_{s}_{ax}`` (R, C),
``basis_{s}`` (C, F), ``layers[i].w`` (d_in, d_out) and ``.b``), so a carry
is a copy: nothing is transposed or renamed. Inputs are plain numpy
(nested dicts and lists of arrays), so this module needs no JAX.

A state dict is the flat form of a parameter tree: dotted keys, list
positions as numbers (``geometry.network.layers.0.w``).
"""

from __future__ import annotations

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState


def state_dict(params, prefix="") -> dict[str, torch.Tensor]:
    """Flatten a nested dict / list parameter tree into dotted keys."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: params}
    out = {}
    for k, v in items:
        out.update(state_dict(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_state_dict(sd, device=None):
    """Nest a state dict back into the parameter tree the models take,
    with every tensor as float32 on ``device``."""
    root: dict = {}
    for key, value in sd.items():
        cur = root
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = torch.as_tensor(value).float().to(device)
    return _listify(root)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (nested dicts and lists of numpy
    arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) -> the
    port's state dict of float32 CPU tensors."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in state_dict(tree).items()
    }


def occupancy_from_jax(grid, device=None) -> OccupancyGridState:
    """A JAX ``OccupancyGridState`` (or a dict with its leaves as numpy:
    ``occs``, ``binary``, ``binary_dilated``) -> the port's grid. The TPU
    probe's ``bricks`` leaf is dropped: the port probes ``binary_dilated``."""
    get = grid.get if isinstance(grid, dict) else lambda k: getattr(grid, k)
    return OccupancyGridState(
        occs=torch.as_tensor(np.array(get("occs"), dtype=np.float32), device=device),
        binary=torch.as_tensor(np.array(get("binary"), dtype=bool), device=device),
        binary_dilated=torch.as_tensor(
            np.array(get("binary_dilated"), dtype=bool), device=device
        ),
    )
