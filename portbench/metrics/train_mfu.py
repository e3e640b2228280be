"""The training step's model FLOPs (forward and backward of the reference
network's convolutions, ``arith/flops.py``) at the traced window's steps/s,
as a share of the card's bf16 dense peak (``arith/peaks.py``), in %."""

from portbench.arith.peaks import BF16_FLOPS


def read(obs):
    if not obs.get("flops_per_step") or obs.get("trace") is None or not obs["trace"].ops:
        return None
    return obs["flops_per_step"] * obs["steps"] / obs["window_s"] / BF16_FLOPS * 100.0
