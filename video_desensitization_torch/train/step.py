"""The train and eval steps of RetinaFace, on one device or on a mesh.

The state is the model (its parameters and its BN running statistics), an
SGD optimizer (its momentum buffers), the learning-rate schedule and the
step count. SGD with ``momentum``, ``weight_decay``, no dampening and no
Nesterov is optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))``;
the learning rate of each step is ``schedule(step)``, set before the update.

Mixed precision as in the JAX trainer: parameters and optimizer state stay
float32, the forward and backward run under ``torch.autocast`` in the
compute dtype, BN statistics are float32 (``models/common.py``), and the
loss is taken on float32 casts of the heads.

On a mesh (``parallel/mesh.py``) each process runs one device of the
(data, model) grid. The step takes the global batch and computes on its
data row's contiguous shard; batch norm takes its statistics over the
data group (``models/common.py::set_data_group``); the gradients are
averaged over ``data``, which makes them the global batch's, since the
loss is a mean of per-image terms and the shards are equal; the metrics
are averaged the same way. With ``model`` > 1 the large conv kernels are
split over the model group (``parallel/tensor.py::shard_model``, the
layout of ``param_partition_spec`` and ``make_sharding_rules``), and
every other parameter's gradient is averaged over the whole mesh: its
model ranks compute it alike but not always bit for bit (cuDNN's weight
gradients), and one all-reduce leaves every rank the same bits, so the
replicated parameters stay identical, as JAX keeps them by construction.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from video_desensitization_torch import resolve_device
from video_desensitization_torch.models.common import set_data_group
from video_desensitization_torch.parallel.mesh import Mesh
from video_desensitization_torch.parallel.tensor import (  # noqa: F401 (the JAX module's names)
    ColumnParallelConv2d,
    make_sharding_rules,
    param_partition_spec,
    split_param_owner,
)
from video_desensitization_torch.train.losses import multibox_loss

Batch = Dict[str, np.ndarray]


@dataclass
class TrainState:
    model: nn.Module  # RetinaFace(mode="train") on its device
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    mesh: Optional[Mesh] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    schedule: Callable[[int], float],
    device=None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """``model`` in train mode on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``), with ``optimizer`` over its parameters and the
    step -> lr ``schedule`` (``cli/train.py::build_optimizer`` makes both).

    On a ``mesh``, ``device`` is this rank's, ``model`` must already be
    laid out by ``shard_model`` (before the optimizer was built over its
    parameters), and its batch norm takes the data group's statistics."""
    device = resolve_device(device)
    if mesh is not None and mesh.shape["model"] > 1 and not any(
        isinstance(m, ColumnParallelConv2d) for m in model.modules()
    ):
        raise ValueError("a mesh with a model axis needs the model laid out by shard_model")
    model.to(device).train()
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    if mesh is not None:
        set_data_group(model, mesh.group("data"))
    return TrainState(model=model, optimizer=optimizer, schedule=schedule, mesh=mesh)


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}
    if device.type == "cuda":
        out["images"] = out["images"].contiguous(memory_format=torch.channels_last)
    return out


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _data_shard(batch: Batch, mesh: Optional[Mesh]) -> Batch:
    """This rank's contiguous shard of the global batch (all of it with no
    mesh)."""
    if mesh is None:
        return batch
    rows = mesh.shape["data"]
    b = len(batch["images"])
    if b % rows:
        raise ValueError(f"batch {b} not divisible by data axis {rows}")
    d, _ = mesh.coords()
    per = b // rows
    return {k: v[d * per:(d + 1) * per] for k, v in batch.items()}


def _mean_over(values, group, size: int) -> None:
    """Each tensor of ``values`` averaged over ``group`` (``size`` ranks;
    None: the default group), in place (one all-reduce of them all,
    flattened)."""
    if not values:
        return
    flat = torch.cat([v.reshape(-1) for v in values])
    dist.all_reduce(flat, group=group)
    flat /= size
    offset = 0
    for v in values:
        v.copy_(flat[offset:offset + v.numel()].view(v.shape))
        offset += v.numel()


def _mean_over_data(values, mesh: Optional[Mesh]) -> None:
    """Each tensor of ``values`` averaged over the data group, in place of
    its shard's value."""
    group = None if mesh is None else mesh.group("data")
    if group is not None:
        _mean_over(values, group, mesh.shape["data"])


def _mean_gradients(model: nn.Module, mesh: Optional[Mesh]) -> None:
    """The global batch's gradients from each rank's: a split kernel's
    averaged over ``data`` (its model ranks hold other slices), every other
    parameter's over the whole mesh (its model ranks computed the same
    value, so that is still the data mean, now bitwise equal on every
    rank)."""
    grads = [p for p in model.parameters() if p.grad is not None]
    if mesh is None or mesh.shape["model"] == 1:
        _mean_over_data([p.grad for p in grads], mesh)
        return
    split = split_param_owner(model)
    _mean_over_data([p.grad for p in grads if id(p) in split], mesh)
    _mean_over([p.grad for p in grads if id(p) not in split], None, mesh.size)


def _loss(heads, batch):
    loc, cls, landm = (h.to(torch.float32) for h in heads)
    return multibox_loss(loc, cls, landm, batch["loc_t"], batch["landm_t"], batch["labels"])


def make_eval_step(
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """eval_step(state, batch) -> metrics: BN in inference mode, no
    gradient, the same multibox objective as training; on a ``mesh``, the
    global batch's metrics from this rank's shard."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        device = state.device
        b = _to_device(_data_shard(batch, mesh), device)
        state.model.eval()
        try:
            with torch.no_grad(), _autocast(device, compute_dtype):
                heads = state.model(b["images"])
            with torch.no_grad():
                metrics = _loss(heads, b)[1]
                _mean_over_data(list(metrics.values()), mesh)
                return metrics
        finally:
            state.model.train()

    return eval_step


def make_train_step(
    compute_dtype: torch.dtype = torch.float32,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """train_step(state, batch) -> (state, metrics): one SGD update of
    ``state`` in place at ``schedule(state.step)``, then ``step + 1``.

    batch = {"images": (B, 3, H, W) float32, "loc_t": (B, A, 4),
             "landm_t": (B, A, 10), "labels": (B, A) int32}: on a ``mesh``
    the global batch (B divisible by the data axis), of which this rank
    computes its shard; the update and the metrics are the global batch's."""

    def train_step(state: TrainState, batch: Batch):
        device = state.device
        b = _to_device(_data_shard(batch, mesh), device)
        with _autocast(device, compute_dtype):
            heads = state.model(b["images"])
        total, metrics = _loss(heads, b)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        _mean_gradients(state.model, mesh)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        _mean_over_data(list(metrics.values()), mesh)
        return state, metrics

    return train_step
