"""The plain reference and the comparison on hand-made cases, the
byte counts, and the reduction of a trace to the per-layer metrics."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import peaks, tracing  # noqa: E402
from portbench.reference import check, csc  # noqa: E402


def dense(rows, cols, vals, shape):
    A = np.zeros(shape)
    keep = np.asarray(rows) < shape[0]
    np.add.at(A, (np.asarray(rows)[keep], np.asarray(cols)[keep]),
              np.asarray(vals, np.float64)[keep])
    return A


def from_csc(st, data, shape):
    A = np.zeros(shape)
    for j in range(shape[1]):
        for s in range(st.indptr[j], st.indptr[j + 1]):
            A[st.indices[s], j] += data[s]
    return A


CASES = {
    "duplicates": ([0, 0, 0, 1, 1], [0, 0, 0, 1, 1], [1, 2, 3, 4, 5], (2, 2)),
    "empty_columns": ([1, 0, 2], [0, 3, 3], [1, 2, 3], (3, 5)),
    "last_row_and_column": ([3, 3, 0, 3], [4, 4, 4, 0], [1, -1, 2, 5],
                            (4, 5)),
    "padding_rows": ([0, 2, 1, 2], [1, 0, 1, 1], [1, 9, 2, 9], (2, 2)),
    "cancelling_terms": ([1, 1, 0], [0, 0, 0], [2.5, -2.5, 1.0], (2, 1)),
    "unsorted_input": ([2, 0, 1, 0, 2], [1, 1, 0, 1, 0], [1, 2, 3, 4, 5],
                       (3, 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_against_dense(case):
    rows, cols, vals, shape = CASES[case]
    st = csc.structure(np.array(rows), np.array(cols), shape)
    data, absum = csc.sums(np.array(vals, np.float32), st)
    np.testing.assert_array_equal(from_csc(st, data, shape),
                                  dense(rows, cols, vals, shape))
    # rows ascend within each column, every structural pair kept once
    for j in range(shape[1]):
        col = st.indices[st.indptr[j]:st.indptr[j + 1]]
        assert (np.diff(col) > 0).all()
    pairs = {(r, c) for r, c in zip(rows, cols) if r < shape[0]}
    assert st.nnz == len(pairs) == st.indptr[-1]
    assert (absum >= np.abs(data)).all()


def test_cancelling_terms_stay_structural():
    rows, cols, vals, shape = CASES["cancelling_terms"]
    st = csc.structure(np.array(rows), np.array(cols), shape)
    data, absum = csc.sums(np.array(vals, np.float32), st)
    assert st.nnz == 2 and data.tolist() == [1.0, 0.0]
    assert absum.tolist() == [1.0, 5.0]


def test_to_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1 + 2**-8, 1 + 3 * 2**-8, 1 + 2**-9, -3.0e-3],
                 np.float32)
    got = csc.to_bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0  # tie to even
    assert got[2] == np.float32(1 + 2**-6)  # tie to even, upwards
    assert got[3] == 1.0
    assert abs(got[4] - x[4]) <= abs(x[4]) * 2**-8
    assert (got.view(np.uint32) & 0xFFFF == 0).all()


def _answer(st, data, nzmax, M):
    d = np.zeros(nzmax, np.float32)
    d[:st.nnz] = data
    ind = np.full(nzmax, M, np.int32)
    ind[:st.nnz] = st.indices
    return {"data": d, "indices": ind,
            "indptr": st.indptr.astype(np.int32), "nnz": st.nnz}


def test_check_reads_zero_for_the_reference_and_counts_faults():
    rng = np.random.default_rng(3)
    M = N = 50
    rows = rng.integers(0, M, 600)
    cols = rng.integers(0, N, 600)
    vals = rng.uniform(0.5, 2, 600).astype(np.float32)
    st = csc.structure(rows, cols, (M, N))
    data, _ = csc.sums(vals, st)
    ans = _answer(st, data, 600, M)
    r = check.readings(ans, st, vals)
    assert r["structure_mismatch"] == 0
    assert r["data_rel_err"] < 1e-7
    assert check.verdict(r)[0]
    bad = dict(ans, indices=ans["indices"].copy())
    bad["indices"][5] = (bad["indices"][5] + 1) % M
    assert check.readings(bad, st, vals)["structure_mismatch"] == 1
    bad = dict(ans, nnz=st.nnz - 1)
    assert check.readings(bad, st, vals)["structure_mismatch"] >= 1
    bad = dict(ans, data=ans["data"] * np.float32(1 + 1e-3))
    assert check.readings(bad, st, vals)["data_rel_err"] > 5e-4
    bad = dict(ans, data=ans["data"].copy())
    bad["data"][0] = np.nan
    assert check.readings(bad, st, vals)["data_rel_err"] == float("inf")
    assert not check.verdict(check.readings(bad, st, vals))[0]


def test_nonzero_where_every_term_is_zero_must_read_zero():
    st = csc.structure(np.array([0, 1]), np.array([0, 0]), (2, 1))
    vals = np.array([0.0, 1.0], np.float32)
    ans = _answer(st, np.array([0.0, 1.0]), 2, 2)
    assert check.readings(ans, st, vals)["data_rel_err"] == 0.0
    ans["data"][0] = 1e-30
    assert check.readings(ans, st, vals)["data_rel_err"] == float("inf")


def test_worst_and_verdict():
    w = check.worst([{"structure_mismatch": 0, "data_rel_err": 1e-7},
                     {"structure_mismatch": 2, "data_rel_err": 3e-8}])
    assert w == {"structure_mismatch": 2, "data_rel_err": 1e-7}
    ok, out = check.verdict(w)
    assert not ok and list(out) == list(check.LIMITS)
    assert check.worst([])["data_rel_err"] == float("inf")


def test_byte_counts():
    L, N, nnz = 10, 4, 6
    assert peaks.plan_bytes(L, N, nnz) == 12 * L + 4 * nnz + 4 * (N + 1)
    assert peaks.fill_bytes(L, N, nnz) == 8 * L + 4 * nnz
    assert peaks.assembly_bytes(L, N, nnz) == 12 * L + 8 * nnz + 4 * (N + 1)
    # the FEM cell: 71,928,018 triplets into 4e6 columns
    L, N, nnz = 71_928_018, 4_000_000, 27_984_002
    assert peaks.assembly_bytes(L, N, nnz) == 1_103_008_236
    assert peaks.bound_s(3.35e12) == 1.0


def _trace():
    # window [0, 100); two calls of (plan: two kernels, fill: one), and
    # one operation launched outside every span (the next call's inputs)
    dev = [("k1", 0, 10, "plan"), ("k2", 12, 20, "plan"),
           ("fill", 20, 30, "fill"), ("prep", 40, 45, None),
           ("k1", 50, 60, "plan"), ("k2", 55, 70, "plan"),
           ("fill", 75, 80, "fill")]
    host = [("cudaLaunchKernel", 10, 12), ("cudaEventSynchronize", 30, 40),
            ("cudaLaunchKernel", 39, 40)]
    spans = [(0, 45, "call"), (0, 19, "plan"), (20, 30, "fill"),
             (46, 90, "call"), (46, 70, "plan"), (70, 80, "fill")]
    return tracing.Trace(window=(0, 100), device=dev, host=host,
                         spans=tracing._nested(spans),
                         span_ms={"plan": [2e-5, 2e-5], "call": [4e-5] * 2,
                                  "fill": [1e-5, 1e-5]},
                         span_bytes={"plan": 3.35e12 * 1e-8,
                                     "fill": 3.35e12 * 1e-8,
                                     "call": 3.35e12 * 2e-8},
                         calls=2)


def test_union_and_gaps():
    ivs = [(0, 10), (5, 20), (30, 40), (35, 36)]
    assert tracing.union_ns(ivs, 0, 100) == 30
    assert tracing.union_ns(ivs, 8, 32) == 14
    assert tracing.gaps_ns(ivs, 0, 50) == [(20, 30), (40, 50)]
    assert tracing.gaps_ns([], 0, 5) == [(0, 5)]


def test_trace_readers():
    t = _trace()
    # the operation launched outside the calls' spans is not a call's
    assert tracing.launches_per_call(t) == 3.0
    assert tracing.span_mean_ms(t, "plan") == 2e-5
    # plan busy: [0,10) [12,20) [50,70) = 38 ns; needs 10 ns at the peak
    assert tracing.span_roofline_pct(t, "plan") == pytest.approx(
        100 * 10 / 38)
    assert tracing.span_roofline_pct(t, "fill") == pytest.approx(
        100 * 10 / 15)
    # two calls of 45 and 44 ns on the host's clock need 20 ns
    assert tracing.call_roofline_pct(t) == pytest.approx(100 * 20 / 89)
    # busy 0-10, 12-30, 40-45, 50-70, 75-80: 58 of 100
    assert tracing.idle_pct(t) == pytest.approx(42.0)
    assert tracing.busy_s(t) == pytest.approx(58e-9)
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["k2", pytest.approx(23e-9)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    # gaps, by what the host did at their middles: [10,12) a launch in
    # the plan, [30,40) the call's wait, [45,50) the second call's
    # plan, [70,75) its fill, [80,100) after the last call
    assert gaps["plan/cudaLaunchKernel"] == pytest.approx(2e-9)
    assert gaps["call/cudaEventSynchronize"] == pytest.approx(10e-9)
    assert gaps["plan/python"] == pytest.approx(5e-9)
    assert gaps["fill/python"] == pytest.approx(5e-9)
    assert gaps["between calls/python"] == pytest.approx(20e-9)
    assert sum(gaps.values()) == pytest.approx(42e-9)


class _Event:
    """What :func:`tracing.from_profiler` reads of a profiler event."""

    def __init__(self, name, start, dur, cuda, corr):
        self._v = (name, start, dur, cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        import torch

        t = torch.autograd.DeviceType
        return t.CUDA if self._v[3] else t.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._v[4]


def test_device_operations_take_the_span_of_their_launch():
    from types import SimpleNamespace

    import torch

    events = [_Event("cudaLaunchKernel", 5, 1, False, 7),
              _Event("k1", 6, 4, True, 7),
              _Event("cudaLaunchKernel", 25, 1, False, 8),
              _Event("fill", 30, 5, True, 8),
              _Event("cudaMemsetAsync", 41, 1, False, 9),
              _Event("prep", 42, 2, True, 9)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = tracing.Spans(torch.device("cpu"))
    spans.marks = [(0, 40, "call"), (20, 35, "fill"), (1, 19, "plan")]
    spans.win = (0, 50)
    t = tracing.from_profiler(prof, spans, {}, 1)
    assert [(n, sp) for n, _, _, sp in t.device] == [
        ("k1", "plan"), ("fill", "fill"), ("prep", None)]
    assert t.window_s == 50e-9 and tracing.launches_per_call(t) == 2.0


def test_empty_trace_reads_nothing():
    t = tracing.Trace(window=(0, 10), device=[], host=[], spans=[],
                      span_ms={}, span_bytes={}, calls=3)
    for fn in (tracing.launches_per_call, tracing.idle_pct,
               tracing.call_roofline_pct):
        assert fn(t) is None
    assert tracing.span_roofline_pct(t, "plan") is None
    assert tracing.span_mean_ms(t, "plan") is None
