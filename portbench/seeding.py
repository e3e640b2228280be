"""Seeded weights and their calibration for networks with linear layers
and layer norms (RT-DETR), beside ``weights.py``, whose networks have only
convolutions and batch norms.

The values follow the port's random initialisation
(``models/common.py::init_weights``): convolution kernels and linear
weights, the attention's packed ``in_proj_weight`` too, normal with
variance 1/fan_in, from one normal draw of a generator on the device in
module order; their biases zero; batch norm and layer norm at identity.
``calibrate_`` then rescales each convolution's and each linear layer's
weight and bias so that its output has unit standard deviation on a
calibration batch, layer after layer in the order the forward pass runs
them, as ``weights.calibrate_`` does for convolutions alone (a caller
may ask some layers for another standard deviation). The packed
attention projection is no module of its own and keeps its draw.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` (any device, ``meta`` too) filled from
    ``seed``, in ``dtype`` (batch norm's running statistics stay float32)."""
    device = torch.device(device)
    random, fixed = [], {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            random.append((prefix + "weight", tuple(m.weight.shape)))
            if m.bias is not None:
                fixed[prefix + "bias"] = torch.zeros(m.bias.shape)
        elif isinstance(getattr(m, "in_proj_weight", None), nn.Parameter):
            random.append((prefix + "in_proj_weight", tuple(m.in_proj_weight.shape)))
            fixed[prefix + "in_proj_bias"] = torch.zeros(m.in_proj_bias.shape)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            c = m.weight.shape[0]
            fixed[prefix + "weight"] = torch.ones(c)
            fixed[prefix + "bias"] = torch.zeros(c)
            if isinstance(m, nn.BatchNorm2d):
                fixed[prefix + "running_mean"] = torch.zeros(c)
                fixed[prefix + "running_var"] = torch.ones(c)
                fixed[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s in random), generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for key, shape in random:
        n = math.prod(shape)
        out[key] = (flat[offset:offset + n].view(shape) / math.sqrt(n // shape[0])).to(dtype)
        offset += n
    for key, t in fixed.items():
        keep = key.endswith(("running_mean", "running_var", "num_batches_tracked"))
        out[key] = t.to(device=device, dtype=t.dtype if keep else dtype)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no seeded value for {sorted(missing)[:5]}")
    return out


@torch.no_grad()
def calibrate_(model: nn.Module, state: Dict[str, torch.Tensor], x: torch.Tensor,
               target: Optional[Dict[str, float]] = None) -> None:
    """Rescale ``state``'s convolution and linear weights (and biases) in
    place so that each such layer ``model`` runs on ``x`` puts out unit
    standard deviation (``target``: another one, by module name), given
    that every one before it does. ``model`` and ``x`` float32 on one
    device; ``state`` float32."""
    target = target or {}
    model.load_state_dict(state)
    model.eval()
    scales: Dict[str, float] = {}
    names = {m: n for n, m in model.named_modules()}

    def hook(m, inp, out):
        s = float(out.float().std())
        if not math.isfinite(s) or s <= 0:
            raise ValueError(f"calibration: {names[m]} puts out std {s}")
        s /= target.get(names[m], 1.0)
        m.weight.div_(s)
        if m.bias is not None:
            m.bias.div_(s)
        scales[names[m]] = s
        return out / s

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    for name, s in scales.items():
        state[f"{name}.weight"].div_(s)
        if f"{name}.bias" in state:
            state[f"{name}.bias"].div_(s)
