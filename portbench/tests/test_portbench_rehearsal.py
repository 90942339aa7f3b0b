"""Every cell's run, end to end, at a tiny size on the CPU (the port's
plain versions of its kernels), untraced and traced; and the run on the
card, which skips here."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
#: sizes a test run holds, by generator
TINY = {"fem_p1": {"n": 5}, "ransparse": {"siz": 200}}


def tiny(workload: str) -> harness.Cell:
    c = harness.cell(MAN, workload)
    return dataclasses.replace(
        c, config={**c.config, **TINY[c.config["generator"]]})


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_rehearsal(workload, trace):
    c = tiny(workload)
    r = harness.run_cell(c, 2**31 + 99, 0.05, trace, device="cpu")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       *(["breakdown"] if trace else []), "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert r["checks"]["structure_mismatch"]["value"] == 0
    json.dumps(r)
    if trace:
        # no device operations on the CPU: the device readers read nothing
        assert r["metrics"] == {}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the host-clock metrics; the allocator's needs the card
        want = {m["name"] for m in c.end_to_end} - {"workspace_MB"}
        assert set(r["metrics"]) == want
        for m in c.end_to_end:
            if m["name"] in r["metrics"]:
                assert r["metrics"][m["name"]]["unit"] == m["unit"]
                assert r["metrics"][m["name"]]["value"] > 0


def test_refill_plans_once_and_refills_the_held_plan(monkeypatch):
    from repro_torch.sparse import pattern

    calls = []
    real = pattern.plan_coo
    monkeypatch.setattr(pattern, "plan_coo",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    r = harness.run_cell(tiny("fem_p1_1999.refill"), 4, 0.05, 0,
                         device="cpu")
    assert r["correct"] and r["attempted"] > 1 and calls == [1]


def _state(workload, seed=1):
    c = tiny(workload)
    gen = harness.generator(c.config["generator"])
    return harness.operation(c.traffic["op"]).setup(
        gen, c.config, c.traffic, seed, torch.device("cpu"))


def test_every_call_of_a_random_pattern_is_new():
    """Each call of the set 2 cell hands the port a pattern no earlier
    call of the run had, and the reference gets the same triplets."""
    state = _state("ransparse_set2_1e6.assemble", seed=2**31 + 7)
    N = state.shape[1]
    seen = set()
    for k in range(40):
        state.prepare(k)
        coo = state.coo(k)
        key = (state.base(k), state.offset(k))
        assert key not in seen
        seen.add(key)
        inp = state.host_inputs(k)
        assert (inp["rows"] == coo.rows.numpy()).all()
        assert (inp["cols"] == coo.cols.numpy()).all()
        assert inp["pattern"] == key
        rows, cols = state.patterns[state.base(k)]
        assert torch.equal(coo.rows, rows)
        assert torch.equal(coo.cols.long(),
                           (cols.long() + state.offset(k)) % N)
    # the shift keeps the base pattern's nonzeros
    for k in (8, 9):
        nnz = {(int(r), int(c)) for r, c in zip(*state.indices(k))}
        assert len(nnz) == harness.operation("assemble").pattern_nnz(
            *state.patterns[state.base(k)], state.shape)


def test_a_mesh_keeps_its_pattern_every_call():
    state = _state("fem_p1_1999.assemble")
    rows, cols = state.patterns[0]
    for k in (0, 9, 17):
        state.prepare(k)
        coo = state.coo(k)
        assert coo.rows is rows and coo.cols is cols
        assert state.host_inputs(k)["pattern"] == (0, 0)


@pytest.mark.parametrize("key,value", [("loop", "open"), ("callers", 4)])
def test_traffic_the_harness_does_not_drive_is_refused(key, value,
                                                       monkeypatch):
    real = harness.load_json

    def load(path):
        t = real(path)
        return {**t, key: value} if "traffic" in str(path) else t

    monkeypatch.setattr(harness, "load_json", load)
    with pytest.raises(ValueError, match="not driven by this harness"):
        harness.cell(MAN, "fem_p1_1999.refill")


def test_assemble_cell_draws_a_pattern_an_item():
    c = tiny("ransparse_set2_1e6.assemble")
    gen = harness.generator(c.config["generator"])
    state = harness.operation("assemble").setup(gen, c.config, c.traffic,
                                                1, torch.device("cpu"))
    assert len(state.patterns) == state.pool == 8
    c = tiny("fem_p1_1999.assemble")
    gen = harness.generator(c.config["generator"])
    state = harness.operation("assemble").setup(gen, c.config, c.traffic,
                                                1, torch.device("cpu"))
    assert len(state.patterns) == 1 and len(state.vals) == 8


@pytest.mark.gpu
def test_card_run_at_a_small_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for workload in CELLS:
        r = harness.run_cell(tiny(workload), 12, 0.2, 1, device="cuda")
        assert r["correct"] and r["device"]["busy_s"] > 0
