"""Host ms a batch in the fused stream stage's own ``dispatch`` span
(``pipeline/streaming.py::_run_device_stage``'s ``StageTimer``): the
letterbox, both detector programs (their NMS rounds wait on the card) and
the mosaic's launch."""


def read(obs):
    count = obs.get("timer_counts", {}).get("dispatch", 0)
    if not count:
        return None
    return obs["timer_totals"]["dispatch"] / count * 1e3
