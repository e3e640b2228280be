"""Train-state checkpoints and the inference export.

``save_train_state`` / ``restore_train_state`` keep the model (parameters
and BN statistics), the optimizer (momentum buffers) and the step in one
``torch.save`` file, written atomically. ``export_inference_variables``
writes the weights as the JAX trainer's msgpack export, so a file written
by either trainer loads in either package's ``Retinaface``.

A file never depends on the layout it was written from: on a mesh with a
``model`` axis the split kernels and their momentum buffers are gathered
whole first (every rank takes part; rank 0 writes), and a restore cuts
them to the state's own layout, so a file loads into any layout.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.distributed as dist

from video_desensitization_torch.models.convert import save_variables, to_jax_variables
from video_desensitization_torch.parallel.tensor import (
    full_state_dict,
    local_state_dict,
    split_param_owner,
)
from video_desensitization_torch.train.step import TrainState


def _writes() -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _optimizer_params(state: TrainState):
    return [p for group in state.optimizer.param_groups for p in group["params"]]


def _map_momentum(state: TrainState, saved: Dict, fn) -> Dict:
    """An optimizer state dict with ``fn(owner, buffer)`` in place of each
    split kernel's momentum buffer (the others as they are)."""
    owners = split_param_owner(state.model)
    params = _optimizer_params(state)
    out = dict(saved)
    out["state"] = {
        i: {k: fn(owners[id(params[i])], v) if k == "momentum_buffer" and id(params[i]) in owners
            else v for k, v in s.items()}
        for i, s in saved["state"].items()
    }
    return out


def export_inference_variables(path: str, state: TrainState) -> str:
    """Write the trained weights as a msgpack ``{"params", "batch_stats"}``
    file (``models/convert.py::save_variables``); returns its path."""
    variables = to_jax_variables(full_state_dict(state.model))
    if _writes():
        save_variables(variables, path)
    return os.path.abspath(path)


def save_train_state(path: str, state: TrainState) -> str:
    """Save the model, the optimizer and the step (atomically) at ``path``."""
    path = os.path.abspath(path)
    model = full_state_dict(state.model)
    optimizer = _map_momentum(state, state.optimizer.state_dict(),
                              lambda owner, buf: owner.gather(buf))
    if _writes():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"model": model, "optimizer": optimizer, "step": state.step}, tmp)
        os.replace(tmp, path)
    return path


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a ``save_train_state`` file into ``state`` (its model, its
    optimizer and its step), on the state's device and in its layout,
    whatever layout wrote the file."""
    saved = torch.load(path, map_location=state.device, weights_only=True)
    state.model.load_state_dict(local_state_dict(state.model, saved["model"]))
    state.optimizer.load_state_dict(_map_momentum(
        state, saved["optimizer"], lambda owner, buf: owner.local_rows(buf).clone()))
    state.step = int(saved["step"])
    return state
