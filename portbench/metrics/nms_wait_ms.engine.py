"""Host ms a batch spent in NMS's convergence reads (``ops/nms.py``'s
``nms.flag_read`` spans, both detectors), over the traced window; the
rules of ``portbench/spans.py``."""

from portbench.spans import FLAG_READ, per_batch


def read(obs):
    got = per_batch(obs, FLAG_READ)
    return None if got is None else got[0] * 1e3
