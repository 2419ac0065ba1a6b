"""Carry parameters, occupancy grids and whole train states from the JAX
package to the port.

The port keeps the JAX pytree's keys and layouts (``line_{s}_{ax}`` (R, C),
``basis_{s}`` (C, F), ``layers[i].w`` (d_in, d_out) and ``.b``), so a carry
is a copy: nothing is transposed or renamed. Inputs are plain numpy
(nested dicts and lists of arrays, or the JAX package's ``.npz``
checkpoint), so this module needs no JAX.

A state dict is the flat form of a parameter tree: dotted keys, list
positions as numbers (``geometry.network.layers.0.w``).
"""

from __future__ import annotations

import numpy as np
import torch

from instant_nsr_pl_tpu_torch.models.network_utils import named_leaves
from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState


def state_dict(params, prefix="") -> dict[str, torch.Tensor]:
    """Flatten a nested dict / list parameter tree into dotted keys (in the
    JAX package's leaf order)."""
    return dict(named_leaves(params, prefix))


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


def load_jax_checkpoint(path, state, weights_only=False):
    """Load a JAX package checkpoint (``utils/checkpoint.py``: one ``.npz``
    of the train state's flattened leaves, ``leaf_0`` ...) into the port's
    train ``state`` (from ``system.init_state``), in place.

    The leaf order is the JAX flatten order of ``{params, opt_state, occ,
    extra, step, rng}``, rebuilt here from the port's own parameter tree:
    dict keys sorted, lists in order, NamedTuple fields in declaration
    order. So the leaves are
      0. ``extra``, in sorted key order (NeuS with variance modulation:
         ``prev_inv_s``; none otherwise);
      1. ``occ.grid``: occs, binary, binary_dilated and, when the grid
         carries it, the TPU probe's ``bricks`` (dropped here);
      2. ``opt_state``: per top-level parameter key, sorted, the optax
         multi-transform's Adam(W) state: count, the ``mu`` leaves, the
         ``nu`` leaves (each in the parameters' leaf order), then the
         schedule's count;
      3. ``params``, in leaf order;
      4. ``rng`` (a uint32 PRNG key) and ``step``.
    Parameters (NeuS: the ``variance.variance`` scalar, weight-normed layers'
    ``b``, ``g``, ``v``) and the grid are copied; unless ``weights_only``,
    ``extra``, ``step`` and the Adam moments and counts go into the state and
    the torch optimizer's state (``exp_avg``, ``exp_avg_sq``, ``step``).
    The JAX PRNG key has no torch counterpart: the state's generator keeps
    its own seed."""
    data = np.load(path, allow_pickle=False)
    leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    params = state["params"]
    groups = [(k, named_leaves(params[k])) for k in sorted(params)]
    groups = [(k, g) for k, g in groups if g]
    n_params = sum(len(g) for _, g in groups)
    n_opt = sum(2 + 2 * len(g) for _, g in groups)
    extra_keys = sorted(state.get("extra", {}))
    n_extra = len(extra_keys)
    n_occ = len(leaves) - n_extra - n_opt - n_params - 2
    if n_occ not in (3, 4):
        raise ValueError(f"{path}: {len(leaves)} leaves do not match a JAX train state "
                         f"with {n_params} parameter leaves, {n_extra} extra leaves and "
                         "Adam(W): config mismatch?")
    extra_leaves = leaves[:n_extra]
    leaves = leaves[n_extra:]
    pos = n_occ
    opt_leaves = []
    for _, g in groups:
        k = len(g)
        opt_leaves.append((leaves[pos], leaves[pos + 1:pos + 1 + k],
                           leaves[pos + 1 + k:pos + 1 + 2 * k]))
        pos += 2 + 2 * k
    param_leaves = leaves[pos:pos + n_params]
    step = int(leaves[pos + n_params + 1])

    live = named_leaves(params)
    with torch.no_grad():
        for (key, t), v in zip(live, param_leaves):
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {v.shape} != model {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.asarray(v, np.float32)))
    grid = state["occ"]["grid"]
    device = grid.occs.device
    out = dict(state)
    out["occ"] = {"grid": occupancy_from_jax(
        {"occs": leaves[0], "binary": leaves[1], "binary_dilated": leaves[2]}, device)}
    if weights_only:
        return out
    out["extra"] = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                    for k, v in zip(extra_keys, extra_leaves)}
    opt = state["optimizer"].optimizer
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        raise ValueError("a JAX checkpoint's optimizer state loads into Adam or AdamW only")
    for group, (count, mu, nu) in zip(opt.param_groups, opt_leaves):
        for p, m, v in zip(group["params"], mu, nu):
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": torch.as_tensor(np.asarray(m, np.float32), device=p.device),
                "exp_avg_sq": torch.as_tensor(np.asarray(v, np.float32), device=p.device),
            }
    out["step"] = step
    return out
