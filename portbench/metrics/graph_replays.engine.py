"""CUDA graph replays a batch: the ``face.graph`` and ``plate.graph`` spans
(``video_desensitization_torch/utils/graphs.py``, one a replay of a
detector's graph) over the traced window; the rules of
``portbench/spans.py``."""

from portbench.spans import per_batch

GRAPH_SPANS = ("face.graph", "plate.graph")


def read(obs):
    got = [per_batch(obs, name) for name in GRAPH_SPANS]
    return None if None in got else sum(spans for _, spans in got)
