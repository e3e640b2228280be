"""The train and eval steps of RetinaFace on one device.

The state is the model (its parameters and its BN running statistics), an
SGD optimizer (its momentum buffers), the learning-rate schedule and the
step count. SGD with ``momentum``, ``weight_decay``, no dampening and no
Nesterov is optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))``;
the learning rate of each step is ``schedule(step)``, set before the update.

Mixed precision as in the JAX trainer: parameters and optimizer state stay
float32, the forward and backward run under ``torch.autocast`` in the
compute dtype, BN statistics are float32 (``models/common.py``), and the
loss is taken on float32 casts of the heads.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from video_desensitization_torch import resolve_device
from video_desensitization_torch.train.losses import multibox_loss

Batch = Dict[str, np.ndarray]


@dataclass
class TrainState:
    model: nn.Module  # RetinaFace(mode="train") on its device
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Callable[[int], float],
    device=None,
) -> TrainState:
    """``model`` in train mode on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``), with ``optimizer`` over its parameters and the
    step -> lr ``schedule`` (``cli/train.py::build_optimizer`` makes both)."""
    device = resolve_device(device)
    model.to(device).train()
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
    if device.type == "cuda":
        out["images"] = out["images"].contiguous(memory_format=torch.channels_last)
    return out


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _loss(heads, batch):
    loc, cls, landm = (h.to(torch.float32) for h in heads)
    return multibox_loss(loc, cls, landm, batch["loc_t"], batch["landm_t"], batch["labels"])


def make_eval_step(
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """eval_step(state, batch) -> metrics: BN in inference mode, no
    gradient, the same multibox objective as training."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        device = state.device
        b = _to_device(batch, device)
        state.model.eval()
        try:
            with torch.no_grad(), _autocast(device, compute_dtype):
                heads = state.model(b["images"])
            with torch.no_grad():
                return _loss(heads, b)[1]
        finally:
            state.model.train()

    return eval_step


def make_train_step(
    compute_dtype: torch.dtype = torch.float32,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """train_step(state, batch) -> (state, metrics): one SGD update of
    ``state`` in place at ``schedule(state.step)``, then ``step + 1``.

    batch = {"images": (B, 3, H, W) float32, "loc_t": (B, A, 4),
             "landm_t": (B, A, 10), "labels": (B, A) int32}."""

    def train_step(state: TrainState, batch: Batch):
        device = state.device
        b = _to_device(batch, device)
        with _autocast(device, compute_dtype):
            heads = state.model(b["images"])
        total, metrics = _loss(heads, b)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
