"""Shared conv building blocks, batch norm that trains as Flax's does, and
explicit-generator weight init.

``ConvBN`` is a ``Sequential`` so its parameters sit under the indices the
reference checkpoints use (``0`` conv, ``1`` BN, ``2`` activation).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from video_desensitization_torch.parallel.tensor import all_reduce_sum

BN_MOMENTUM = 0.9  # Flax's: running = 0.9 * running + 0.1 * batch


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update is Flax ``BatchNorm``'s.

    Eval mode is ``nn.BatchNorm2d``'s own. In train mode one
    ``F.batch_norm`` normalizes by the batch statistics (computed in float32
    whatever the input's dtype) and updates the running statistics with
    momentum 0.9; it takes the unbiased variance ``n/(n-1) * var`` into
    ``running_var``, and the update is then rescaled to Flax's biased
    ``var`` (``n`` = elements per channel).

    With a ``data_group`` (``set_data_group``: the ranks that hold the
    other shards of the batch) the statistics are the global batch's, as
    the JAX step takes them on a sharded batch: each channel's count, sum
    and sum of squares (in float32 at least) are summed over the group by a
    differentiable all-reduce, so the backward is synchronised too, and
    the variance is Flax's ``E[x^2] - E[x]^2``."""

    data_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.data_group is not None:
            return self._forward_global(x)
        n = x.numel() // x.shape[1]
        # a copy: autograd keeps the one it was given, which must not change
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, 1.0 - BN_MOMENTUM, self.eps)
        with torch.no_grad():
            # var - 0.9 * running_var is 0.1 * the unbiased variance
            self.running_var.copy_(var - (var - BN_MOMENTUM * self.running_var) / n)
        return out

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
        sums = all_reduce_sum(
            torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]),
            self.data_group)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return out.to(x.dtype)


def set_data_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm2d`` of ``model`` takes its train-mode statistics
    over ``group`` (None: over its own input)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.data_group = group


class ConvBN(nn.Sequential):
    """Conv2d (no bias) + BatchNorm(eps=1e-5) [+ LeakyReLU].

    ``leaky`` < 0 disables the activation (conv_bn_no_relu); 0 is ReLU.
    """

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, pad=1, groups=1, leaky=0.0):
        layers = [
            nn.Conv2d(in_ch, out_ch, kernel, stride, pad, groups=groups, bias=False),
            BatchNorm2d(out_ch, eps=1e-5),
        ]
        if leaky >= 0.0:
            layers.append(nn.LeakyReLU(leaky) if leaky > 0.0 else nn.ReLU())
        super().__init__(*layers)


def conv_bn(in_ch, out_ch, stride=1, leaky=0.0):
    """3x3 conv + BN + LeakyReLU."""
    return ConvBN(in_ch, out_ch, 3, stride, 1, leaky=leaky)


def conv_bn1x1(in_ch, out_ch, stride=1, leaky=0.0):
    """1x1 conv + BN + LeakyReLU."""
    return ConvBN(in_ch, out_ch, 1, stride, 0, leaky=leaky)


def conv_bn_no_relu(in_ch, out_ch, stride=1):
    """3x3 conv + BN, no activation."""
    return ConvBN(in_ch, out_ch, 3, stride, 1, leaky=-1.0)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: trainable conv kernels and linear
    weights (an attention's packed ``in_proj_weight`` too) normal with
    variance 1/fan_in (LeCun), their biases zero, BN and LayerNorm at
    identity. Fixed weights (YOLOv8's DFL projection) stay as built."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.weight.requires_grad:
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(getattr(m, "in_proj_weight", None), nn.Parameter):
            m.in_proj_weight.normal_(0.0, 1.0 / math.sqrt(m.in_proj_weight.shape[1]),
                                     generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module


def load_weights(net: nn.Module, state_dict, model_path, seed: int) -> None:
    """A given state_dict, else the checkpoint at ``model_path`` (a reference
    ``.pth``/``.pt`` state_dict, any other path the JAX package's msgpack
    variables, as its detectors read them), else random weights from
    ``torch.Generator().manual_seed(seed)``.

    A state_dict is taken under the JAX converters' key rules
    (``convert.reference_state_dict``: ``body.fc.*`` and
    ``num_batches_tracked`` skipped, a key outside the network's layout
    refused with their ``ValueError``); a key of ``net`` that it lacks
    raises ``ValueError("Missing checkpoint keys: [...]")``."""
    # Imported here: the package's __init__ imports this module, and
    # ``python -m ...models.convert`` must find the converter not yet imported.
    from video_desensitization_torch.models.convert import (
        from_jax_variables,
        load_torch_checkpoint,
        load_variables,
        reference_state_dict,
        unmapped_keys_error,
    )

    if state_dict is None and model_path is not None:
        if str(model_path).endswith((".pth", ".pt")):
            state_dict = load_torch_checkpoint(model_path)
        else:
            state_dict = from_jax_variables(load_variables(model_path))
    if state_dict is None:
        init_weights(net, torch.Generator().manual_seed(seed))
        return
    yolo = any(k.startswith("model.") for k in net.state_dict())
    result = net.load_state_dict(reference_state_dict(state_dict, yolo), strict=False)
    if result.unexpected_keys:
        raise unmapped_keys_error(result.unexpected_keys, yolo)
    missing = [k for k in result.missing_keys if not k.endswith(".num_batches_tracked")]
    if missing:
        raise ValueError(f"Missing checkpoint keys: {missing[:10]}")
