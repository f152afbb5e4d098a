"""Launch counters that count kernels that ran, through CUDA graphs too.

Each kernel wrapper calls :func:`count` where it launches its kernel, naming
the function that carries the counters (``qmm.launches``,
``fused_mel.launches``, ...). Eagerly the counters go up at once. While a
:class:`Graph` captures, a launch only records into the graph: nothing runs,
so nothing is counted then, and each :meth:`Graph.replay` adds what its
capture recorded. A launch captured any other way raises, since its
counters would count the capture and miss the replays. A capture records the
launches of its own thread only: the batching server captures and replays
from its batch thread while other threads may launch eagerly.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

import torch

_capturing = threading.local()  # .recording: the Counter of the capture running in this thread


def count(fn, *names: str) -> None:
    """One launch of ``fn``'s kernel, added to each counter ``fn.<name>``."""
    recording = getattr(_capturing, "recording", None)
    if recording is not None:
        for name in names:
            recording[fn, name] += 1
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{fn.__name__}: a kernel captured outside ops.launches.Graph would not be counted "
                           "when it runs")
    for name in names:
        setattr(fn, name, getattr(fn, name) + 1)


class Graph:
    """A ``torch.cuda.CUDAGraph`` whose replays count the kernel launches its
    capture recorded (``launches``: (function, counter) -> launches a replay)."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: collections.Counter = collections.Counter()

    def capture(self, fn: Callable[[], None], pool=None, stream: Optional[torch.cuda.Stream] = None) -> None:
        """Capture ``fn()`` (``torch.cuda.graph``; ``pool`` shares memory with
        other graphs, which must then never run concurrently)."""
        if getattr(_capturing, "recording", None) is not None:
            raise RuntimeError("Graph.capture: another capture is recording")
        _capturing.recording = self.launches
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                fn()
        finally:
            _capturing.recording = None

    def replay(self) -> None:
        self.graph.replay()
        for (fn, name), n in self.launches.items():
            setattr(fn, name, getattr(fn, name) + n)
