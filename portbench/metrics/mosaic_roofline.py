"""The mosaic kernel's share of its roofline: the least bytes the batches'
boxes need moved (``arith/mosaic_bytes.py``) over the HBM rate, against
the device time of the mosaic's kernels (``csrc/mosaic.cu``:
``prepare_kernel``, ``apply_kernel``) in the profiler trace, in %."""

from portbench.arith import mosaic_bytes


def read(obs):
    trace = obs.get("trace")
    if trace is None or "mosaic_bytes" not in obs or not obs["mosaic_bytes"]:
        return None
    device_s = trace.device_seconds(lambda n: bool(mosaic_bytes.KERNELS.search(n)))
    if device_s <= 0:
        return None
    return mosaic_bytes.bound_seconds(obs["mosaic_bytes"]) / device_s * 100.0
