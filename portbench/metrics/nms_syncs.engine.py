"""NMS's convergence reads a batch (``ops/nms.py``'s ``nms.flag_read``
spans, both detectors: each is one host sync), over the traced window;
the rules of ``portbench/spans.py``."""

from portbench.spans import FLAG_READ, per_batch


def read(obs):
    got = per_batch(obs, FLAG_READ)
    return None if got is None else got[1]
