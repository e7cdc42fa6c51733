"""CUDA graphs of fixed-shape chains of small launches, replayed.

A chain of many small kernels whose launches take the host longer than
the card takes to run them leaves the card idle and its rate set by the
host's speed.  :func:`replayed` runs such a chain from a CUDA graph: the
host issues one replay.  Its callers are the GMM-HMM's batch paths:
``models/gmm_hmm.py:recognize_batch``, whose front end at 8 kHz
(``pipeline.extract_features``: endpoint detector, MFCC, deltas) is ~180
small launches a batch, and ``recognize_level_batch``, whose
whole-recording front end, level DP (~11 launches a frame and level:
~59,000 at 598 frames and 9 levels) and backtrace replay graphs.

A chain is captured at its second call with the same key, input shapes
and dtypes on one device (a one-off call runs it op by op, as a capture
costs two runs), and kept for later calls, :data:`GRAPHS_KEPT` at most,
the least recently used dropped first.  The graph reads its own copies
of the inputs and its outputs are cloned out, so it holds no caller's
tensor, and the same kernels run on the same values: the result is the
bits the chain gives op by op.  Nothing waits on the card: the capture
follows one run of the chain on a side stream (what it builds lazily,
outside the capture), and a call makes its stream wait for the graph's
last use by any stream before it copies in.  The chain must not copy
from the host, read back or synchronize.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from dsp_tpu_torch.utils import profiling

GRAPHS_KEPT = 8          # captured chains kept
SEEN_KEPT = 64           # keys seen once, remembered

_graphs: collections.OrderedDict = collections.OrderedDict()
_seen: collections.OrderedDict = collections.OrderedDict()
_lock = threading.RLock()      # a chain may call replayed() in its first run


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "done", "keep")

    def __init__(self, graph, inputs, outputs, done, keep):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.done, self.keep = done, keep


def replayed(key, fn, *args: torch.Tensor, keep=(), span: str | None = None):
    """``fn(*args)`` (tensors in; a tensor or a tuple of tensors out) from
    the CUDA graph of ``key`` at these shapes, or op by op at the first
    call, off the card and inside another capture.  ``keep``: what the
    chain reads besides ``args`` (cached constants), held alive while the
    graph is kept.  ``span``: the ``profiling.stage`` of a replay (a run
    op by op opens ``fn``'s own)."""
    if not args[0].is_cuda or torch.cuda.is_current_stream_capturing():
        return fn(*args)
    dev = args[0].device
    full = (key, dev, *((tuple(a.shape), a.dtype) for a in args))
    stream = torch.cuda.current_stream(dev)
    with _lock:
        got = _graphs.pop(full, None)
        if got is None and full in _seen:
            del _seen[full]
            got = _capture(fn, args, stream, keep)
        elif got is None:
            _seen[full] = True
            if len(_seen) > SEEN_KEPT:
                _seen.popitem(last=False)
        if got is not None:
            _graphs[full] = got
            if len(_graphs) > GRAPHS_KEPT:
                _graphs.popitem(last=False)[1].done.synchronize()   # its pool is freed next
            with profiling.stage(span) if span else contextlib.nullcontext():
                stream.wait_event(got.done)
                for mine, a in zip(got.inputs, args):
                    mine.copy_(a)
                got.graph.replay()
                out = _cloned(got.outputs)
                got.done.record(stream)
            return out
    return fn(*args)


def _cloned(outputs):
    if isinstance(outputs, torch.Tensor):
        return outputs.clone()
    clones = [o.clone() for o in outputs]
    return type(outputs)(*clones) if hasattr(outputs, "_fields") else tuple(clones)


def _capture(fn, args, stream, keep) -> _Graph:
    """``fn`` on copies of ``args``, captured on a side stream that
    follows ``stream``."""
    inputs = tuple(a.clone() for a in args)
    side = torch.cuda.Stream(stream.device)
    side.wait_stream(stream)
    with torch.cuda.device(stream.device), torch.cuda.stream(side):
        fn(*inputs)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            outputs = fn(*inputs)
        finally:
            graph.capture_end()
    stream.wait_stream(side)
    done = torch.cuda.Event()
    done.record(stream)
    return _Graph(graph, inputs, outputs, done, keep)
