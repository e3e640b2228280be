"""CUDA graphs over the detectors' fixed-shape segments, and the device
constants that make such a segment capturable.

A detector's stretch from its input to NMS's first convergence read issues
a few hundred kernels of fixed shapes (``detect/face.py``,
``detect/plate.py``). ``SegmentGraphs`` runs such a segment through one
CUDA graph per input key, the shapes, dtypes and device of its tensor
inputs (and the detector's thresholds):

* the first sight of a key runs eagerly: that run is the warm-up, so
  cuDNN's choices and lazy initialisation happen outside any capture, and
  a one-off call never captures anything;
* the second sight captures a graph on a side stream and replays it;
* later sights copy the inputs into the graph's static input buffers and
  replay it on the current stream, inside one span
  (``utils/timers.py::span``) named for the detector.

On the CPU, inside a capture already running, and once ``MAX_KEYS``
graphs are kept (the first ones captured), the segment runs eagerly. Only
captured graphs count against the cap: a key seen once since the last
capture (a one-off call, a stream's tail) is forgotten at the next one.

A replay's outputs are the graph's own buffers, overwritten by the next
replay. Callers read them on the stream of the replay before they call
the segment again: the detectors' NMS rounds and epilogues are enqueued
there and write fresh tensors. A replay on another stream than the last
one first waits for what the last stream has enqueued. So the calls of one
detector come from one thread at a time, as every pipeline of the package
makes them.

Parameters are captured by address: ``load_state_dict`` copies in place,
so replays see the new weights; replacing a parameter tensor does not.
So are the device constants a segment reads (``device_constant``,
``ops/image.py::_axis_tables``): a graph keeps none of them alive, so
their caches never evict.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence, Tuple

import torch

from video_desensitization_torch.utils.timers import span

# Graphs each ``SegmentGraphs`` keeps: a stream's batch and its tail batch,
# with room for a second frame size.
MAX_KEYS = 4
# Keys seen once that a ``SegmentGraphs`` remembers between two captures.
MAX_SEEN = 64


@functools.cache
def device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared by every caller, who only reads it:
    a host tensor copied to the card on each call is a host sync, and a
    capture cannot hold it. Never evicted, nor freed: a captured graph
    reads it by address. Made outside inference mode, so autograd may
    read it too."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


class CudaGraph:
    """One segment captured on its inputs' device: the graph, its static
    inputs and outputs, and the stream of its last replay."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        device = inputs[0].device
        self.static = [torch.empty_like(t, memory_format=torch.contiguous_format)
                       for t in inputs]
        self.stream = torch.cuda.current_stream(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(device),
                capture_error_mode="thread_local"):
            self.outputs = fn(*self.static)

    def replay(self, inputs: Sequence[torch.Tensor]):
        # The caller enqueues every read of the last replay's outputs (its
        # NMS rounds and epilogue, which write fresh tensors) on its stream
        # before it calls again, so in stream order this replay overwrites
        # nothing a batch still in flight needs. On another stream, it first
        # waits for what the last one has enqueued.
        stream = torch.cuda.current_stream(self.static[0].device)
        if stream != self.stream:
            stream.wait_stream(self.stream)
            self.stream = stream
        for static, t in zip(self.static, inputs):
            static.copy_(t)
        self.graph.replay()
        return self.outputs


class CudaGraphs:
    """What ``SegmentGraphs`` needs of CUDA: whether a call on ``device``
    may use a graph, and the capture of one. Tests pass a fake."""

    @staticmethod
    def usable(device: torch.device) -> bool:
        return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    capture = CudaGraph


class SegmentGraphs:
    """The capture policy of the module docstring for the segments of one
    detector. ``span_name`` names each replay's span."""

    def __init__(self, span_name: str, backend=CudaGraphs):
        self.span_name = span_name
        self.backend = backend
        self._seen: set = set()
        self._graphs: Dict[Tuple, object] = {}

    def __call__(self, fn: Callable, *inputs: torch.Tensor, settings: Tuple = ()):
        """``fn(*inputs)``, eagerly, through a new graph or a replay.
        ``settings``: what else ``fn`` reads that a caller may change (the
        detector's thresholds): another value is another key."""
        if not self.backend.usable(inputs[0].device):
            return fn(*inputs)
        key = (fn.__name__, settings) + tuple(
            (tuple(t.shape), t.dtype, t.device) for t in inputs)
        graph = self._graphs.get(key)
        if graph is None:
            if len(self._graphs) >= MAX_KEYS:
                return fn(*inputs)
            if key not in self._seen:
                if len(self._seen) >= MAX_SEEN:
                    self._seen.clear()
                self._seen.add(key)
                return fn(*inputs)
            self._seen.clear()
            graph = self._graphs[key] = self.backend.capture(fn, inputs)
        with span(self.span_name):
            return graph.replay(inputs)
