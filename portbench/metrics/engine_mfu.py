"""The fused engine's model FLOPs (the reference networks' convolutions a
frame, ``arith/flops.py``) at the traced window's frames/s, as a share of
the card's bf16 dense peak (``arith/peaks.py``), in %."""

from portbench.arith.peaks import BF16_FLOPS


def read(obs):
    if not obs.get("flops_per_frame") or obs.get("trace") is None or not obs["trace"].ops:
        return None
    return obs["flops_per_frame"] * obs["frames_window"] / obs["window_s"] / BF16_FLOPS * 100.0
