"""Seeded weights, made on the device in one call a network.

The values follow the port's own random initialisation
(``models/common.py::init_weights``): each trainable convolution's kernel
normal with variance 1/fan_in, convolution biases zero, batch norm at its
identity (scale 1, shift 0, mean 0, variance 1), YOLOv8's DFL projection
0..15. They are keyed by the published state_dict layout, which the port's
networks and the reference's share, so the same tensors load into both.

``calibrate_`` then rescales each kernel so that its convolution's output
has unit standard deviation on a calibration batch, layer after layer in
the order the forward pass runs them (layer-sequential unit variance,
Mishkin and Matas 2016). An inference network's batch norm is the
identity at initialisation, so without it activations grow or vanish
with depth (YOLOv8n's class logits read 6e-5 at the port's scale and 59
at 1.6 times it) and the detectors' scores saturate or tie: the kept boxes
would be decided by rounding, not by the network.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
from torch import nn


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` (any device, ``meta`` too) filled from
    ``seed``: every random kernel from one normal draw of a generator on
    ``device``, in ``dtype`` (batch norm's running statistics stay float32)."""
    device = torch.device(device)
    random, fixed = [], {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d):
            if m.weight.requires_grad:
                random.append((prefix + "weight", tuple(m.weight.shape)))
            else:  # DFL: the bin indices
                fixed[prefix + "weight"] = torch.arange(
                    m.weight.shape[1], dtype=torch.float32).view(m.weight.shape)
            if m.bias is not None:
                fixed[prefix + "bias"] = torch.zeros(m.bias.shape)
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            fixed[prefix + "weight"] = torch.ones(c)
            fixed[prefix + "bias"] = torch.zeros(c)
            fixed[prefix + "running_mean"] = torch.zeros(c)
            fixed[prefix + "running_var"] = torch.ones(c)
            fixed[prefix + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s in random)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for key, shape in random:
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[key] = (flat[offset:offset + n].view(shape) / math.sqrt(fan_in)).to(dtype)
        offset += n
    for key, t in fixed.items():
        keep = key.endswith(("running_mean", "running_var", "num_batches_tracked"))
        out[key] = t.to(device=device, dtype=t.dtype if keep else dtype)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no seeded value for {sorted(missing)[:5]}")
    return out


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions in float32, not TF32, inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def calibrate_(model: nn.Module, state: Dict[str, torch.Tensor], x: torch.Tensor) -> None:
    """Rescale ``state``'s random kernels in place so that each convolution
    ``model`` runs on ``x`` puts out unit standard deviation, given that
    every one before it does. ``model`` and ``x`` float32 on one device;
    ``state`` float32."""
    model.load_state_dict(state)
    model.eval()
    scales: Dict[str, float] = {}
    names = {m: n for n, m in model.named_modules()}

    def hook(m, inp, out):
        s = float(out.float().std())
        if not math.isfinite(s) or s <= 0:
            raise ValueError(f"calibration: {names[m]} puts out std {s}")
        m.weight.div_(s)
        if m.bias is not None:
            m.bias.div_(s)
        scales[names[m]] = s
        return out / s

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.Conv2d) and m.weight.requires_grad]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    for name, s in scales.items():
        state[f"{name}.weight"].div_(s)
        if f"{name}.bias" in state:
            state[f"{name}.bias"].div_(s)
