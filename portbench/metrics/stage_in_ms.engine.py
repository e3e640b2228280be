"""Host ms a batch in the engine's ``engine.stage_in`` span
(``pipeline/engine.py::dispatch_batch``: the batch made contiguous and
copied into page-locked memory), over the traced window; the rules of
``portbench/spans.py``."""

from portbench.spans import per_batch


def read(obs):
    got = per_batch(obs, "engine.stage_in")
    return None if got is None else got[0] * 1e3
