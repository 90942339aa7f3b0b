"""The port's own spans (``repro_torch.obs``) in the traced window, and
what the per-layer metrics read from them beside the profiler's trace.

The port records its spans while the profiler runs, so the traced
window's spans are in the port's store when the readers run.  A port
that records none (one older than ``repro_torch.obs``) gives no spans,
and every reader here then reads ``None``, as it does where the trace
holds no device operation (a CPU rehearsal).
"""
from __future__ import annotations

import bisect
import dataclasses

from . import tracing

#: CUDA runtime calls that hold the host until the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


@dataclasses.dataclass(frozen=True)
class PortSpan:
    name: str
    start: int              # ns, the profiler's clock
    end: int
    ms: float | None        # CUDA-event time, where the span has events


def port_spans(t: tracing.Trace) -> list[PortSpan]:
    """The port's finished spans that lie inside the traced window."""
    try:
        from repro_torch import obs
    except ImportError:
        return []
    lo, hi = t.window
    return [PortSpan(s.name, s.start_ns, s.end_ns, s.device_ms())
            for s in obs.records() if lo <= s.start_ns and s.end_ns <= hi]


def _spans(t: tracing.Trace | None, spans) -> list | None:
    """``spans`` (the port's, by default) where the trace can be read
    against them, else ``None``."""
    if t is None or not t.device or t.calls <= 0:
        return None
    spans = port_spans(t) if spans is None else spans
    return spans or None


def mean_ms(t: tracing.Trace | None, name: str,
            spans=None) -> float | None:
    """Mean CUDA-event time of the window's spans called ``name``."""
    spans = _spans(t, spans)
    if spans is None:
        return None
    ms = [s.ms for s in spans if s.name == name and s.ms is not None]
    return sum(ms) / len(ms) if ms else None


def idle_by_span(t: tracing.Trace, spans) -> dict[str, int]:
    """The window's device-idle ns, by the innermost port span open at
    each instant: every gap between device operations is cut at the
    spans' starts and ends, so a gap that opens in the harness's wait
    and closes inside a port span adds only what lies inside it."""
    lo, hi = t.window
    marks = tracing._nested((s.start, s.end, s.name) for s in spans)
    starts = [s for s, _, _ in marks]
    cuts = sorted({x for s, e, _ in marks for x in (s, e)})
    out: dict[str, int] = {}
    for g0, g1 in tracing.gaps_ns([(s, e) for _, s, e, _ in t.device],
                                  lo, hi):
        inner = cuts[bisect.bisect_right(cuts, g0):
                     bisect.bisect_left(cuts, g1)]
        edges = [g0, *inner, g1]
        for a, b in zip(edges, edges[1:]):
            name = tracing._innermost(marks, starts, a)
            if name is not None:
                out[name] = out.get(name, 0) + b - a
    return out


def idle_in_port_us(t: tracing.Trace | None, spans=None) -> float | None:
    """Device-idle time inside the port's spans, in us a call."""
    spans = _spans(t, spans)
    if spans is None:
        return None
    return sum(idle_by_span(t, spans).values()) / t.calls / 1e3


def syncs_per_call(t: tracing.Trace | None, spans=None) -> float | None:
    """Runtime calls that block the host (:data:`SYNCS`) begun inside a
    port span, a call; the harness's own wait lies outside them."""
    spans = _spans(t, spans)
    if spans is None:
        return None
    marks = tracing._nested((s.start, s.end, s.name) for s in spans)
    starts = [s for s, _, _ in marks]
    lo, hi = t.window
    n = sum(1 for name, s, _ in t.host
            if name in SYNCS and lo <= s < hi
            and tracing._innermost(marks, starts, s) is not None)
    return n / t.calls
