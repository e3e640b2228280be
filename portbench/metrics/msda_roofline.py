"""The deformable attention kernel's share of its roofline: the least bytes
of the traced batches' calls (``arith/msda_bytes.py``, on the reference's
sampling locations) over the HBM rate, against the device time of the
kernel (``csrc/msda.cu``: ``msda_kernel``) in the profiler trace, in %."""

from portbench.arith import msda_bytes


def read(obs):
    trace = obs.get("trace")
    if trace is None or not obs.get("msda_bytes"):
        return None
    device_s = trace.device_seconds(lambda n: bool(msda_bytes.KERNELS.search(n)))
    if device_s <= 0:
        return None
    return msda_bytes.bound_seconds(obs["msda_bytes"]) / device_s * 100.0
