"""The ``model`` axis of the trainer: conv kernels split on their output
channels, and the collectives around them as autograd functions.

The JAX trainer lays the large conv kernels out over ``model``
(``param_partition_spec``: every 4-D kernel with at least 256 output
channels, where that count divides by the axis) and leaves the
collectives to XLA. Here ``shard_model`` swaps each such ``nn.Conv2d``
for a ``ColumnParallelConv2d`` holding its rank's slice of the output
channels: its input is replicated over ``model`` (identity forward, the
input gradient summed over ``model`` backward, since each rank's covers
its own channels only), and its output is gathered on the channel dim
(every rank then runs the same replicated layers downstream, so the
gather's backward keeps the rank's own slice). Everything else is
replicated.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from video_desensitization_torch.parallel.mesh import Mesh, NamedSharding, replicated

MIN_SHARD_CHANNELS = 256


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward; the gradient summed over the group
    backward: each rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward on a replicated input; its gradient summed over the
    group backward (each rank's covers only what its slice reads)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """Each rank's slice of dim 1 gathered in rank order forward; the
    rank's own slice of the gradient backward (downstream is replicated,
    so every rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, y, group, rank, size):
        ctx.rank, ctx.width = rank, y.shape[1]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[:, lo:lo + ctx.width], None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, differentiable."""
    return _SumOverGroup.apply(x, group)


def gather_rows(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The whole tensor of which each rank of ``group`` holds a slice of
    dim 0, in rank order (no gradient)."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


class ColumnParallelConv2d(nn.Module):
    """``conv`` with only rank ``rank`` of ``size``'s slice of its output
    channels (``weight``; a bias stays whole and replicated), its output
    gathered over ``group``. A grouped conv is split along whole groups, so
    each rank reads only its slice of the input channels. The parameters
    keep ``nn.Conv2d``'s names."""

    def __init__(self, conv: nn.Conv2d, group, rank: int, size: int):
        super().__init__()
        out_ch, in_ch, groups = conv.out_channels, conv.in_channels, conv.groups
        if out_ch % size or (groups > 1 and groups % size):
            raise ValueError(f"conv {in_ch}->{out_ch} (groups {groups}) does not split {size} ways")
        self.group, self.rank, self.size = group, rank, size
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.local_groups = groups // size if groups > 1 else 1
        width = in_ch // size
        self.in_slice = slice(rank * width, (rank + 1) * width) if groups > 1 else None
        self.weight = nn.Parameter(self.local_rows(conv.weight.detach()).clone(),
                                   requires_grad=conv.weight.requires_grad)
        self.bias = None if conv.bias is None else nn.Parameter(conv.bias.detach().clone())

    def local_rows(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of dim 0 of a whole kernel (or its optimizer
        state)."""
        width = full.shape[0] // self.size
        return full[self.rank * width:(self.rank + 1) * width]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole kernel (or its optimizer state) from every rank's slice."""
        return gather_rows(local, self.group, self.size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToGroup.apply(x, self.group)
        if self.in_slice is not None:
            x = x[:, self.in_slice]
        y = F.conv2d(x, self.weight, None, self.stride, self.padding, self.dilation,
                     self.local_groups)
        y = _GatherChannels.apply(y, self.group, self.rank, self.size)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[None, :, None, None]
        return y


def param_partition_spec(name: str, param: torch.Tensor,
                         min_shard_channels: int = MIN_SHARD_CHANNELS) -> Tuple:
    """Large conv kernels go over ``model`` on the output-channel axis
    (dim 0 of torch's (O, I, kh, kw)); everything else is replicated."""
    if param.ndim == 4 and param.shape[0] >= min_shard_channels:
        return ("model", None, None, None)
    return ()


def make_sharding_rules(mesh: Mesh, model: nn.Module) -> Dict[str, NamedSharding]:
    """The layout of each parameter of ``model`` on ``mesh``: split where
    ``param_partition_spec`` says and the output channels divide by the
    ``model`` axis, replicated otherwise."""
    size = mesh.shape["model"]
    rules = {}
    for name, p in model.named_parameters():
        spec = param_partition_spec(name, p)
        split = size > 1 and spec and p.shape[0] % size == 0
        rules[name] = NamedSharding(mesh, spec) if split else replicated(mesh)
    return rules


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap each conv whose kernel ``make_sharding_rules`` splits for a
    ``ColumnParallelConv2d`` holding this rank's slice, in place (before an
    optimizer is built over the parameters). A no-op at ``model`` = 1."""
    size = mesh.shape["model"]
    if size == 1:
        return model
    rules = make_sharding_rules(mesh, model)
    group, (_, rank) = mesh.group("model"), mesh.coords()
    split = [(name, m) for name, m in model.named_modules()
             if isinstance(m, nn.Conv2d) and rules[f"{name}.weight"].spec]
    for name, conv in split:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, attr, ColumnParallelConv2d(conv, group, rank, size))
    return model


def split_modules(model: nn.Module) -> Dict[str, ColumnParallelConv2d]:
    """The model's split convs by module name."""
    return {name: m for name, m in model.named_modules() if isinstance(m, ColumnParallelConv2d)}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split kernel gathered whole, so
    that it does not depend on the layout (collective over ``model``)."""
    sd = model.state_dict()
    for name, m in split_modules(model).items():
        sd[f"{name}.weight"] = m.gather(sd[f"{name}.weight"])
    return sd


def local_state_dict(model: nn.Module, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A layout-free state dict cut to ``model``'s layout."""
    out = dict(full)
    for name, m in split_modules(model).items():
        out[f"{name}.weight"] = m.local_rows(full[f"{name}.weight"])
    return out


def split_param_owner(model: nn.Module) -> Dict[int, ColumnParallelConv2d]:
    """id(parameter) -> its split conv, for each split kernel."""
    return {id(m.weight): m for m in split_modules(model).values()}
