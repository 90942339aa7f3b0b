"""Spans inside the port, on the profiler's clock.

The port's layer boundaries open a :func:`span` each: ``plan`` (the
whole symbolic phase), inside it ``plan.sort`` (Parts 1-2, the sort
backend) and ``plan.parts34`` (Parts 3-4), and ``fill`` (the numeric
phase of ``SparsePattern.scatter``).  A span is recorded only while a
``torch.profiler`` session runs or inside :func:`recording`; otherwise
:func:`span` costs one flag check and returns a shared null object.

A recorded span (:class:`Span`) holds its name, its start and end on
``time.time_ns()`` (the clock of the profiler's events, so spans and a
trace share one timeline), its own id, its parent's id (a stack per
thread), the id of its root span (``request``: every span under one
root shares it), its attributes, and, where it was opened
with a CUDA ``device``, a pair of CUDA events around it on the current
stream (:meth:`Span.device_ms`).  No event is recorded while that
stream captures a CUDA graph, while ``torch.compile`` traces, or for a
CPU or meta device.

    with repro_torch.obs.recording():
        csc = fsparse_coo(coo)
    for s in repro_torch.obs.records():
        print(s.name, s.end_ns - s.start_ns, s.attrs, s.device_ms())

The store keeps the newest :data:`CAPACITY` finished spans and counts
the ones it dropped (:func:`dropped`); it is shared by every thread.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "Span", "clear", "dropped", "records", "recording",
           "span"]

#: the most finished spans the store keeps; older ones are dropped first
CAPACITY = 1 << 20

_lock = threading.Lock()
_store: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_recorders = 0  # open recording() blocks, every thread's
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _timing_stream(device):
    """The stream a span's CUDA events go on, or ``None`` where none
    may be recorded."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda" or torch.compiler.is_compiling():
        return None
    with torch.cuda.device(device):
        if torch.cuda.is_current_stream_capturing():
            return None
        return torch.cuda.current_stream()


class Span:
    """One span, open until its ``with`` block ends, then kept in the
    store.  True in a condition, unlike the null span."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "attrs", "events", "_stream")

    def __init__(self, name: str, device, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.start_ns = self.end_ns = 0
        self.parent = self.request = self.events = None
        self._stream = _timing_stream(device)

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def device_ms(self) -> float | None:
        """The span's time on the device's clock (waits for its end
        event), or ``None`` where it recorded no events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.request = self.id
        stack.append(self)
        if self._stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self._stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _dropped
        self.end_ns = time.time_ns()
        if self._stream is not None:
            self.events[1].record(self._stream)
            self._stream = None
        _stack().pop()
        with _lock:
            if len(_store) == _store.maxlen:
                _dropped += 1
            _store.append(self)


class _NullSpan:
    """What :func:`span` returns while nothing records: no state, no
    allocation, false in a condition."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, *, device=None, **attrs):
    """A context manager around one stretch of the port's work.

    ``device``: the CUDA device whose current stream gets a pair of
    timing events around the span; ``attrs``: what the span should say
    of its call.  Records nothing unless a profiler session runs or a
    :func:`recording` block is open.
    """
    if not (_recorders or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, device, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without a profiler."""
    global _recorders
    with _lock:
        _recorders += 1
    try:
        yield
    finally:
        with _lock:
            _recorders -= 1


def records() -> list[Span]:
    """The finished spans the store holds, oldest first."""
    with _lock:
        return list(_store)


def dropped() -> int:
    """Spans dropped from the store since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Empty the store and its count of dropped spans."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
