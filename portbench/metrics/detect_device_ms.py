"""Device ms a batch of every kernel but the mosaic's, from the profiler
trace of the window: the letterbox, both networks, decode, NMS and the
inverse letterbox."""

from portbench.arith.mosaic_bytes import KERNELS


def read(obs):
    trace = obs.get("trace")
    if trace is None or not trace.ops or not obs.get("batches"):
        return None
    return trace.device_seconds(lambda n: not KERNELS.search(n)) / obs["batches"] * 1e3
