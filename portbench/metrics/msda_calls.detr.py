"""Executions of the deformable attention kernel (``csrc/msda.cu``:
``msda_kernel``) a batch in the profiler trace of the window: one a
decoder layer, replayed from the plate program's CUDA graph. None where
the trace holds no such kernel."""

from portbench.arith.msda_bytes import KERNELS


def read(obs):
    trace = obs.get("trace")
    if trace is None or not trace.ops or not obs.get("batches"):
        return None
    n = sum(1 for name, cat, _, _ in trace.ops if cat == "kernel" and KERNELS.search(name))
    return n / obs["batches"] if n else None
