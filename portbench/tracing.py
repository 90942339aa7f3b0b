"""The traced run: spans of the benchmark's own and the reduction of the
profiler's trace to what the per-layer metrics read.

The profiler records CUDA activity only (:func:`profiler`): the
device's operations and the CUDA runtime calls that launched them, and
no host operator, whose recording would slow the host-paced calls it
measures.  A span (:class:`Spans`) is a stretch of the host's clock
around a call into one layer of the port, on the profiler's own clock
(``time.time_ns``, Unix nanoseconds), with a pair of CUDA events that
time it on the device's clock; the harness's span around a whole call
(:meth:`Spans.host`) has no events and ends once the answer is ready.  After the window, :func:`from_profiler`
turns the profiler's raw events into a :class:`Trace`: the device's
operations (kernels, copies, sets), each with the span that was open on
the host when the runtime call that launched it began, and the runtime
calls, which name what the host was doing while the device sat idle.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

from . import peaks


def profiler(device: torch.device):
    """The traced window's profiler: CUDA activity on the card (the CPU
    on a CPU rehearsal, where there is no device to trace)."""
    act = torch.profiler.ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    return torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])


class Spans:
    """Spans around layer calls, and the window around them all; keeps
    each span's host stretch, and its CUDA-event pair until :meth:`ms`
    reads them, after the window."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: dict[str, list] = {}
        self.marks: list[tuple[int, int, str]] = []
        self.win = (0, 0)

    def clear(self) -> None:
        self.events.clear()
        self.marks.clear()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        if not self.cuda:
            yield
            self.marks.append((t0, time.time_ns(), name))
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.marks.append((t0, time.time_ns(), name))
        self.events.setdefault(name, []).append((a, b))

    @contextlib.contextmanager
    def host(self, name: str):
        """A span on the host's clock alone, with no CUDA event (each
        event recorded under the profiler costs the host time)."""
        t0 = time.time_ns()
        yield
        self.marks.append((t0, time.time_ns(), name))

    @contextlib.contextmanager
    def window(self):
        t0 = time.time_ns()
        yield
        self.win = (t0, time.time_ns())

    def ms(self) -> dict[str, list[float]]:
        if self.cuda:
            torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.events.items()}


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]               # ns, the profiler's clock
    device: list[tuple[str, int, int, str | None]]  # name, start, end, span
    host: list[tuple[str, int, int]]      # runtime call, start, end
    spans: list[tuple[int, int, str]]     # start, end, name (nested order)
    span_ms: dict[str, list[float]]       # CUDA-event ms a call, by span
    span_bytes: dict[str, float]          # bytes the calls needed, by span
    calls: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _nested(intervals) -> list[tuple[int, int, str]]:
    """``(start, end, name)`` sorted so that an interval comes after
    every interval that holds it."""
    return sorted(intervals, key=lambda r: (r[0], -r[1]))


def _innermost(intervals: list[tuple[int, int, str]], starts: list[int],
               t: int, reach: int = 256) -> str | None:
    """The innermost interval that holds ``t``: the last one that does in
    :func:`_nested` order, looking back ``reach`` items."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        s, e, name = intervals[j]
        if s <= t < e:
            return name
    return None


def from_profiler(prof, spans: Spans, span_bytes: dict,
                  calls: int) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`.

    Reads the profiler's raw events, not ``key_averages()``.  A device
    operation is any CUDA event that is not a user annotation; it is
    matched to the host call that launched it by its correlation id.
    """
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host, launch_at, dev = [], {}, []
    for e in events:
        s = e.start_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((e.name(), s, s + e.duration_ns(),
                            e.correlation_id()))
            continue
        host.append((e.name(), s, s + e.duration_ns()))
        if e.correlation_id():
            launch_at[e.correlation_id()] = s
    marks = _nested(spans.marks)
    starts = [s for s, _, _ in marks]
    device = []
    for name, s, e, corr in dev:
        at = launch_at.get(corr)
        span = None if at is None else _innermost(marks, starts, at)
        device.append((name, s, e, span))
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return Trace(window=spans.win, device=device, host=host, spans=marks,
                 span_ms=spans.ms(), span_bytes=span_bytes, calls=calls)


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``(start, end)`` intervals inside
    ``[lo, hi)``."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The idle stretches of ``[lo, hi)`` that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def busy_s(t: Trace) -> float:
    return union_ns([(s, e) for _, s, e, _ in t.device], *t.window) / 1e9


# -- what the per-layer metrics read ----------------------------------------
def launches_per_call(t: Trace) -> float | None:
    """Device operations (kernels, copies, sets) a call launches: those
    launched inside a span of the window's calls."""
    if not t.device or not t.calls:
        return None
    n = sum(1 for _, s, _, sp in t.device
            if sp is not None and t.window[0] <= s < t.window[1])
    return n / t.calls


def span_mean_ms(t: Trace, span: str) -> float | None:
    ms = t.span_ms.get(span)
    return sum(ms) / len(ms) if ms else None


def span_roofline_pct(t: Trace, span: str) -> float | None:
    """The span's needed bytes at the HBM peak over the device's busy
    time in the span (operations launched while it was open)."""
    busy = union_ns([(s, e) for _, s, e, sp in t.device if sp == span],
                    *t.window) / 1e9
    nbytes = t.span_bytes.get(span)
    if not busy or not nbytes:
        return None
    return 100.0 * peaks.bound_s(nbytes) / busy


def call_roofline_pct(t: Trace) -> float | None:
    """The whole operation's needed bytes at the HBM peak over the
    calls' wall time: the host's ``call`` spans, each of which ends once
    its answer is ready on the device."""
    wall = sum(e - s for s, e, n in t.spans if n == "call") / 1e9
    nbytes = t.span_bytes.get("call")
    if not wall or not nbytes or not t.device:
        return None
    return 100.0 * peaks.bound_s(nbytes) / wall


def idle_pct(t: Trace) -> float | None:
    if not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(t) / t.window_s)


def breakdown(t: Trace, k: int = 10) -> dict:
    """The ``k`` device operations with the most time, and the idle
    time by what the host was doing in the middle of each gap: the
    benchmark's span (``between calls`` outside them) and the CUDA
    runtime call in progress (``python`` where none was: the host was
    in Python or the port's host code), in seconds."""
    lo, hi = t.window
    ops: dict[str, float] = {}
    for name, s, e, _ in t.device:
        if lo <= s < hi:
            ops[name[:96]] = ops.get(name[:96], 0.0) + (e - s) / 1e9
    host = _nested((s, e, n) for n, s, e in t.host)
    starts = [s for s, _, _ in host]
    span_starts = [s for s, _, _ in t.spans]
    idle: dict[str, float] = {}
    for g0, g1 in gaps_ns([(s, e) for _, s, e, _ in t.device], lo, hi):
        mid = (g0 + g1) // 2
        op = _innermost(host, starts, mid) or "python"
        span = _innermost(t.spans, span_starts, mid) or "between calls"
        label = f"{span}/{op}"[:96]
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9

    def top(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda r: -r[1])[:k]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}
