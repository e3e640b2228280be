"""Train-state checkpoints and the inference export.

``save_train_state`` / ``restore_train_state`` keep the model (parameters
and BN statistics), the optimizer (momentum buffers) and the step in one
``torch.save`` file, written atomically. ``export_inference_variables``
writes the weights as the JAX trainer's msgpack export, so a file written
by either trainer loads in either package's ``Retinaface``.
"""

from __future__ import annotations

import os

import torch

from video_desensitization_torch.models.convert import save_variables, to_jax_variables
from video_desensitization_torch.train.step import TrainState


def export_inference_variables(path: str, state: TrainState) -> str:
    """Write the trained weights as a msgpack ``{"params", "batch_stats"}``
    file (``models/convert.py::save_variables``); returns its path."""
    save_variables(to_jax_variables(state.model.state_dict()), path)
    return os.path.abspath(path)


def save_train_state(path: str, state: TrainState) -> str:
    """Save the model, the optimizer and the step (atomically) at ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a ``save_train_state`` file into ``state`` (its model, its
    optimizer and its step), on the state's device."""
    saved = torch.load(path, map_location=state.device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state
