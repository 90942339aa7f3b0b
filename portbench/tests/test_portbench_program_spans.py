"""The per-layer metrics read from the port's own spans, on a hand-made
trace and hand-made spans, and through their readers on spans the port
recorded."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, program_spans, tracing  # noqa: E402
from portbench.program_spans import PortSpan  # noqa: E402

ASSEMBLE = ("sort_ms", "parts34_ms", "idle_in_port_us.assemble",
            "syncs_per_call.assemble")
REFILL = ("idle_in_port_us.refill", "syncs_per_call.refill")


def _trace(device=True):
    # window [0, 100), two calls: a plan (three kernels) and a fill, then
    # a fill; idle [0, 10) [30, 50) [60, 80) [90, 100)
    dev = [("sort", 10, 20, "plan"), ("parts34", 20, 30, "plan"),
           ("fill", 50, 60, "fill"), ("fill", 80, 90, "fill")]
    host = [("cudaMemcpy", 9, 10),              # in plan.sort: counted
            ("cudaMemcpyAsync", 12, 13),         # no sync
            ("cudaStreamSynchronize", 46, 48),   # in fill: counted
            ("cudaDeviceSynchronize", 63, 70),   # the harness's wait
            ("cudaEventSynchronize", 150, 160)]  # after the window
    return tracing.Trace(window=(0, 100), device=dev if device else [],
                         host=host, spans=[], span_ms={}, span_bytes={},
                         calls=2)


SPANS = [PortSpan("plan", 5, 35, None), PortSpan("plan.sort", 8, 20, 1.5),
         PortSpan("plan.parts34", 20, 34, 2.5),
         PortSpan("fill", 45, 62, None), PortSpan("fill", 75, 85, None)]


def test_idle_by_innermost_span_cuts_each_gap_at_the_spans():
    t = _trace()
    # [0, 10): [5, 8) plan, [8, 10) plan.sort; [30, 50): [30, 34)
    # plan.parts34, [34, 35) plan, [45, 50) fill; [60, 80): [60, 62) and
    # [75, 80) fill; [90, 100) in no span
    assert program_spans.idle_by_span(t, SPANS) == {
        "plan": 4, "plan.sort": 2, "plan.parts34": 4, "fill": 12}
    assert program_spans.idle_in_port_us(t, SPANS) == 22 / 2 / 1e3


def test_a_gap_from_the_harness_into_fill_adds_only_its_overlap():
    t = _trace()
    fill = [PortSpan("fill", 45, 62, None)]
    # [30, 50) opens in the harness's wait: only [45, 50) is the port's;
    # [60, 80) closes outside: only [60, 62)
    assert program_spans.idle_by_span(t, fill) == {"fill": 7}


def test_syncs_count_only_inside_port_spans():
    t = _trace()
    assert program_spans.syncs_per_call(t, SPANS) == 1.0
    # the same syncs with the harness's wait alone outside every span
    assert program_spans.syncs_per_call(t, SPANS[3:]) == 0.5


def test_mean_ms_of_the_named_spans():
    t = _trace()
    more = SPANS + [PortSpan("plan.sort", 36, 40, 3.5)]
    assert program_spans.mean_ms(t, "plan.sort", more) == 2.5
    assert program_spans.mean_ms(t, "plan.parts34", SPANS) == 2.5
    assert program_spans.mean_ms(t, "fill", SPANS) is None


@pytest.mark.parametrize("read", [
    lambda t, s: program_spans.mean_ms(t, "plan.sort", s),
    program_spans.idle_in_port_us, program_spans.syncs_per_call])
def test_nothing_to_read_reads_none(read):
    assert read(_trace(device=False), SPANS) is None  # no device operation
    assert read(None, SPANS) is None                  # an untraced run
    assert read(_trace(), []) is None                 # a port with no spans


def _recorded_run():
    """A plan and a fill that the port recorded on the CPU, in a window
    around them, with one device operation between the two."""
    from repro_torch import obs
    from repro_torch.sparse.pattern import plan

    rows = torch.randint(0, 9, (400,))
    cols = torch.randint(0, 7, (400,))
    with obs.recording():
        pat = plan(rows, cols, (8, 7))
        pat.assemble(torch.ones(400))
    spans = {s.name: s for s in obs.records()[-4:]}
    t0, t1 = spans["plan"].start_ns - 1_000, spans["fill"].end_ns + 1_000
    mid = spans["plan"].end_ns
    t = tracing.Trace(window=(t0, t1), device=[("k", mid, mid + 1, None)],
                      host=[("cudaDeviceSynchronize", t0, t0 + 10)],
                      spans=[], span_ms={}, span_bytes={}, calls=1)
    return t, spans


@pytest.mark.parametrize("metric", ASSEMBLE + REFILL)
def test_readers_of_spans_the_port_recorded(metric):
    t, spans = _recorded_run()
    got = harness.reader(metric).read(harness.Run(window=None, trace=t))
    busy = t.device[0][1:3]
    port = sum(max(0, min(s.end_ns, e) - max(s.start_ns, b))
               for s in (spans["plan"], spans["fill"])
               for b, e in ((t.window[0], busy[0]), (busy[1], t.window[1])))
    want = {"sort_ms": None, "parts34_ms": None,  # no CUDA events here
            "idle_in_port_us": port / 1e3, "syncs_per_call": 0.0}
    assert got == pytest.approx(want[metric.split(".")[0]])


def test_readers_of_a_port_without_spans_read_none(monkeypatch):
    import repro_torch

    t, _ = _recorded_run()
    # a port older than its spans: ``repro_torch.obs`` cannot be imported
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    run = harness.Run(window=None, trace=t)
    for metric in ASSEMBLE + REFILL:
        assert harness.reader(metric).read(run) is None
