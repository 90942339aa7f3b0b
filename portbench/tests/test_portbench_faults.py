"""The comparison fails what it must.

The control (the reference computed in bfloat16, the precision below
the configurations' float32) reads above the limit of ``data_rel_err``
and the program's own answers below it; and a run whose timed path is
broken underneath comes out not correct, for each fault a one-card
cell can have: an answer altered where it is produced (a value, an
index), half of the triplets left out with the rest doubled, a call
that returns its first answer again (state unchanged), a call that
raises.  Sizes a test run holds; the readings at the cells' own sizes
on the card are in ``PERF.md``.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import calibrate, harness  # noqa: E402
from portbench.reference import check  # noqa: E402
from repro_torch.sparse import matlab, pattern  # noqa: E402

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SMALL = {"fem_p1": {"n": 12}, "ransparse": {"siz": 1000}}


def small(workload: str) -> harness.Cell:
    c = harness.cell(MAN, workload)
    return dataclasses.replace(
        c, config={**c.config, **SMALL[c.config["generator"]]})


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 987654321])
def test_control_fails_and_program_passes(workload, seed):
    r = calibrate.readings(small(workload), seed, "cpu")
    limit = check.LIMITS["data_rel_err"]
    assert r["control"]["data_rel_err"] > 3 * limit
    assert r["program"]["data_rel_err"] < limit / 30
    assert r["program"]["structure_mismatch"] == 0
    assert check.verdict(r["program"])[0]
    assert not check.verdict(r["control"])[0]


def _altered_value(real):
    def fill(self, vals, **kw):
        out = real(self, vals, **kw)
        data = out.data.clone()
        data[int(out.nnz) // 2] += 0.5
        return dataclasses.replace(out, data=data)
    return "assemble", fill


def _half_left_out(real):
    def fill(self, vals, **kw):
        v = vals.clone()
        v[::2] = 0
        return real(self, 2 * v, **kw)
    return "assemble", fill


def _first_answer_again(real):
    memo = []

    def fill(self, vals, **kw):
        if not memo:
            memo.append(real(self, vals, **kw))
        return memo[0]
    return "assemble", fill


def _raises(real):
    n = [0]

    def fill(self, vals, **kw):
        n[0] += 1
        if n[0] == 9:  # the window's first call, after 8 of warm-up
            raise RuntimeError("planted fault")
        return real(self, vals, **kw)
    return "assemble", fill


FILL_FAULTS = {"altered_value": _altered_value,
               "half_left_out": _half_left_out,
               "first_answer_again": _first_answer_again,
               "raises": _raises}


def _run(workload, seed=3):
    # a seed whose checked call is not the first pool item, so that a
    # repeated first answer is checked against other inputs
    assert harness.sampled_call(seed, 8) != 0
    return harness.run_cell(small(workload), seed, 0.3, 0, device="cpu")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(FILL_FAULTS))
def test_broken_fill_is_not_correct(workload, fault, monkeypatch):
    name, fn = FILL_FAULTS[fault](pattern.SparsePattern.assemble)
    monkeypatch.setattr(pattern.SparsePattern, name, fn)
    r = _run(workload)
    assert r["correct"] is False
    assert r["failed"] == (1 if fault == "raises" else 0)
    if fault != "raises":
        assert r["checks"]["data_rel_err"]["value"] > \
            r["checks"]["data_rel_err"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_altered_index_is_not_correct(workload, monkeypatch):
    real = pattern.plan_coo

    def plan(*a, **k):
        pat = real(*a, **k)
        indices = pat.indices.clone()
        indices[1] = (indices[1] + 1) % pat.M
        return dataclasses.replace(pat, indices=indices)

    monkeypatch.setattr(pattern, "plan_coo", plan)
    monkeypatch.setattr(matlab, "plan_coo", plan)
    r = _run(workload)
    assert r["correct"] is False
    assert r["checks"]["structure_mismatch"]["value"] >= 1


def test_a_sound_run_is_correct():
    r = _run("ransparse_set2_1e6.assemble")
    assert r["correct"] is True and r["attempted"] > 1
    assert torch.get_default_dtype() == torch.float32


def test_a_reused_plan_is_not_correct(monkeypatch):
    """A plan handed back from an earlier call, as a cache keyed on the
    wrong thing would, fails the cell whose every call has a new
    pattern."""
    real = pattern.plan_coo
    memo = []

    def plan(*a, **k):
        if not memo:
            memo.append(real(*a, **k))
        return memo[0]

    monkeypatch.setattr(pattern, "plan_coo", plan)
    monkeypatch.setattr(matlab, "plan_coo", plan)
    r = _run("ransparse_set2_1e6.assemble")
    assert r["correct"] is False
    assert r["checks"]["structure_mismatch"]["value"] >= 1
