"""Checkpoint save / resume of the port's train state.

Port of ``instant_nsr_pl_tpu/utils/checkpoint.py`` (reference launch.py:
13-18,72-75,110-114: ``--resume`` and ``--resume_weights_only``). A
checkpoint carries the full train state, so a resumed run continues
exactly: parameters, the optimizer state, the occupancy grid, the model's
non-gradient ``extra`` state (NeuS's inv_s snapshot), the step and the
generator's state. The port's format is one ``torch.save`` file of
tensors and plain values (read back with ``weights_only=True``); a JAX
package checkpoint (``.npz``, flattened leaves) loads too, through
``utils/transplant.py``.
"""

from __future__ import annotations

import os

import torch

from instant_nsr_pl_tpu_torch.ops.marching import OccupancyGridState
from instant_nsr_pl_tpu_torch.utils.transplant import load_jax_checkpoint, state_dict

# 2: "occ" holds every grid by name ("grid", NeuS's background "grid_bg")
FORMAT = "instant_nsr_pl_tpu_torch.train_state/2"


def save_checkpoint(path, state):
    """Write ``state`` to ``path`` (through a temporary file, replaced at
    the end, so a killed save leaves the previous checkpoint intact)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "format": FORMAT,
        "params": {k: v.detach().cpu() for k, v in state_dict(state["params"]).items()},
        "optimizer": state["optimizer"].state_dict(),
        # every grid of the model: "grid", and NeuS's background "grid_bg"
        "occ": {name: {"occs": g.occs.cpu(), "binary": g.binary.cpu(),
                       "binary_dilated": g.binary_dilated.cpu()}
                for name, g in state["occ"].items()},
        "extra": {k: v.detach().cpu() for k, v in state.get("extra", {}).items()},
        "step": int(state["step"]),
        "generator": state["generator"].get_state(),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _copy_params(params, saved):
    """Copy saved tensors into the live parameter leaves (in place, so the
    optimizer keeps its references); keys and shapes must match."""
    live = state_dict(params)
    if set(live) != set(saved):
        raise ValueError(f"checkpoint parameters {sorted(set(saved) ^ set(live))} do not "
                         "match the model's: config/model mismatch?")
    with torch.no_grad():
        for k, t in live.items():
            v = torch.as_tensor(saved[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != model "
                                 f"{tuple(t.shape)}")
            t.copy_(v)


def _grid(occ, template, device):
    """The saved grids as the template state's ``occ`` dict (its names must
    match)."""
    if set(occ) != set(template):
        raise ValueError(f"checkpoint grids {sorted(occ)} do not match the model's "
                         f"{sorted(template)}: config/model mismatch?")
    return {name: OccupancyGridState(
        occs=g["occs"].to(device).float(), binary=g["binary"].to(device).bool(),
        binary_dilated=g["binary_dilated"].to(device).bool()) for name, g in occ.items()}


def _read(path):
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this port ({payload.get('format')})")
    return payload


def load_checkpoint(path, template_state):
    """Restore the full train state from ``path`` into ``template_state``
    (a fresh ``system.init_state``, whose tensors and optimizer take the
    saved values). A ``.npz`` path is read as a JAX package checkpoint."""
    if str(path).endswith(".npz"):
        return load_jax_checkpoint(path, template_state)
    payload = _read(path)
    state = dict(template_state)
    _copy_params(state["params"], payload["params"])
    state["optimizer"].load_state_dict(payload["optimizer"])
    device = state["occ"]["grid"].occs.device
    state["occ"] = _grid(payload["occ"], state["occ"], device)
    state["extra"] = {k: v.to(device) for k, v in payload.get("extra", {}).items()}
    state["step"] = int(payload["step"])
    state["generator"].set_state(payload["generator"])
    return state


def load_weights_only(path, template_state):
    """Restore only the parameters and the occupancy grid (the
    ``--resume_weights_only`` path): optimizer, step and generator stay
    fresh."""
    if str(path).endswith(".npz"):
        return load_jax_checkpoint(path, template_state, weights_only=True)
    payload = _read(path)
    state = dict(template_state)
    _copy_params(state["params"], payload["params"])
    state["occ"] = _grid(payload["occ"], state["occ"], state["occ"]["grid"].occs.device)
    return state
