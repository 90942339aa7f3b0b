"""The port's spans (``repro_torch.obs``): recorded only under a profiler
or inside ``recording()``, nested per thread, on the profiler's clock,
bounded, and without effect on what the plan and the fill compute.

The file imports nothing of JAX; its ``gpu`` case runs on the card:

    python -m pytest -q -m gpu tests/test_torch_obs.py
"""
import collections
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.kernels.pattern_build.ops import pattern_build
from repro_torch.sparse.pattern import plan

torch.set_num_threads(1)

FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")
SHAPE = (40, 30)


@pytest.fixture(autouse=True)
def _empty_store():
    obs.clear()
    yield
    obs.clear()


def _triplets(L=500, seed=0, device="cpu"):
    g = np.random.default_rng(seed)
    rows = torch.from_numpy(g.integers(0, SHAPE[0] + 1, L)).to(device)
    cols = torch.from_numpy(g.integers(0, SHAPE[1], L)).to(device)
    vals = torch.from_numpy(g.integers(-4, 5, L).astype(np.float32))
    return rows, cols, vals.to(device)


def _plan_and_fill(method=None, device="cpu"):
    rows, cols, vals = _triplets(device=device)
    pat = plan(rows, cols, SHAPE, method=method)
    return pat, pat.assemble(vals)


def test_nothing_is_recorded_when_off():
    assert not obs.span("plan")
    assert obs.span("plan") is obs.span("fill", device="cpu", a=1)
    _plan_and_fill()
    assert obs.records() == [] and obs.dropped() == 0


@pytest.mark.parametrize("method,passes", [(None, None), ("radix", 2)])
def test_plan_and_fill_spans(method, passes):
    with obs.recording():
        pat, _ = _plan_and_fill(method)
    by = {s.name: s for s in obs.records()}
    assert [s.name for s in obs.records()] == [
        "plan.sort", "plan.parts34", "plan", "fill"]
    p, fill = by["plan"], by["fill"]
    assert p.parent is None and p.request == p.id
    for child in ("plan.sort", "plan.parts34"):
        assert by[child].parent == p.id and by[child].request == p.id
        assert p.start_ns <= by[child].start_ns <= by[child].end_ns \
            <= p.end_ns
    assert by["plan.sort"].end_ns <= by["plan.parts34"].start_ns
    assert fill.parent is None and fill.request == fill.id != p.request
    assert p.attrs == {"method": method or "fused", "L": 500,
                       "M": SHAPE[0], "N": SHAPE[1], "nzmax": pat.nzmax}
    assert by["plan.sort"].attrs == ({} if passes is None
                                     else {"passes": passes})
    # the CPU runs Parts 3-4's plain version: the kernel's count stays
    assert by["plan.parts34"].attrs == {"path": "plain", "launches": 0}
    assert fill.attrs == {"accum": "sum", "dtype": torch.float32}
    # a CPU device takes no CUDA events
    assert all(s.events is None and s.device_ms() is None
               for s in obs.records())


@pytest.mark.parametrize("method", ["jnp", "fused", "pallas", "radix"])
def test_cpu_plan_takes_the_plain_parts34(method):
    before = pattern_build.launches
    with obs.recording():
        _plan_and_fill(method)
    (p34,) = [s for s in obs.records() if s.name == "plan.parts34"]
    assert p34.attrs == {"path": "plain", "launches": 0}
    assert pattern_build.launches == before


def test_spans_share_the_profilers_clock():
    act = torch.profiler.ProfilerActivity
    rows, cols, _ = _triplets(L=20_000)
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        plan(rows, cols, SHAPE, method="fused")
    sort = [s for s in obs.records() if s.name == "plan.sort"]
    assert len(sort) == 1
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::sort"]
    assert events
    for e in events:
        assert sort[0].start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= sort[0].end_ns
    # the window's spans stop with the profiler
    plan(rows, cols, SHAPE, method="fused")
    assert len(obs.records()) == 3


def test_store_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(obs, "_store", collections.deque(maxlen=3))
    with obs.recording():
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
    assert [s.name for s in obs.records()] == ["s2", "s3", "s4"]
    assert obs.dropped() == 2
    obs.clear()
    assert obs.records() == [] and obs.dropped() == 0


def test_recording_blocks_nest():
    with obs.recording():
        with obs.recording():
            pass
        assert obs.span("x")
    assert not obs.span("x")


def test_threads_keep_their_own_parent_stacks():
    both = threading.Barrier(2, timeout=30)

    def work(tag):
        with obs.span(f"outer{tag}"):
            both.wait()
            with obs.span(f"inner{tag}"):
                both.wait()
            both.wait()

    with obs.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in obs.records()}
    assert len(by) == 4
    for tag in "ab":
        outer, inner = by[f"outer{tag}"], by[f"inner{tag}"]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.request == outer.request == outer.id


def test_many_threads_lose_no_span_or_drop_count(monkeypatch):
    # more threads than cores, switching often: the store's length, the
    # count of dropped spans and the recording count are read-modify-
    # write state that a lost update would leave short
    n_threads, n_spans, kept = 32, 200, 1000
    monkeypatch.setattr(obs, "_store", collections.deque(maxlen=kept))
    go = threading.Barrier(n_threads, timeout=30)

    def work():
        go.wait()
        with obs.recording():
            for _ in range(n_spans):
                with obs.span("outer"):
                    with obs.span("inner"):
                        pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = 2 * n_threads * n_spans
    assert len(obs.records()) == kept
    assert obs.dropped() == total - kept
    assert not obs.span("after")  # every recording() block was counted out
    for s in obs.records():
        assert (s.parent is None) == (s.name == "outer")


def test_a_span_closed_by_an_exception_is_kept_and_unwound():
    with obs.recording():
        with pytest.raises(ValueError):
            with obs.span("outer"):
                with obs.span("inner"):
                    raise ValueError
        with obs.span("next"):
            pass
    by = {s.name: s for s in obs.records()}
    assert by["inner"].parent == by["outer"].id
    assert by["next"].parent is None


@pytest.mark.parametrize("method", ["jnp", "fused", "pallas", "radix"])
@pytest.mark.parametrize("accum", ["sum", "max"])
def test_results_are_bit_identical_with_recording_on(method, accum):
    rows, cols, vals = _triplets(seed=3)
    off = plan(rows, cols, SHAPE, method=method, accum=accum)
    data_off = off.assemble(vals)
    with obs.recording():
        on = plan(rows, cols, SHAPE, method=method, accum=accum)
        data_on = on.assemble(vals)
    assert len(obs.records()) == 4
    for f in FIELDS:
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert on.accum == off.accum == accum
    assert torch.equal(data_on.data, data_off.data)
    assert torch.equal(data_on.indices, data_off.indices)


def test_no_events_for_cpu_or_meta_devices():
    with obs.recording():
        for dev in ("cpu", torch.device("meta"), None):
            with obs.span("s", device=dev):
                pass
    assert [s.events for s in obs.records()] == [None] * 3


@pytest.mark.gpu
def test_card_spans_time_the_device_and_skip_captures():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' events are CUDA "
                    "events")
    dev = torch.device("cuda")
    act = torch.profiler.ProfilerActivity
    # the benchmark's traced window: a CUDA-only profiler session
    with torch.profiler.profile(activities=[act.CUDA]):
        pat, out = _plan_and_fill("radix", device=dev)
    by = {s.name: s for s in obs.records()}
    assert set(by) == {"plan", "plan.sort", "plan.parts34", "fill"}
    for name in ("plan.sort", "plan.parts34"):
        assert by[name].device_ms() > 0
    assert by["plan"].events is None and by["fill"].events is None
    assert by["plan"].attrs["method"] == "radix"
    assert by["plan.sort"].attrs["passes"] >= 1
    # Parts 3-4 ran the hand-written pass, counted on its wrapper
    assert by["plan.parts34"].attrs["path"] == "kernel"
    assert by["plan.parts34"].attrs["launches"] == 1
    # recording changes nothing on the card either
    obs.clear()
    off, data = _plan_and_fill("radix", device=dev)
    for f in FIELDS:
        assert torch.equal(getattr(pat, f), getattr(off, f)), f
    assert torch.equal(out.data, data.data)
    # no event on a stream that captures a graph
    x = torch.zeros(8, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with obs.recording():
        with torch.cuda.graph(g):
            with obs.span("captured", device=dev):
                x.add_(1)
    g.replay()
    torch.cuda.synchronize()
    assert [s.events for s in obs.records()] == [None]
    assert x.tolist() == [2.0] * 8
