"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name
it gives is found: each cell's configuration, generator, traffic and
operation, and each metric's reader."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys_and_names(section):
    entries = MAN[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and \
                    section != "per_layer":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_metrics():
    sources = {"device_trace", "program_span", "program_counter",
               "host_clock"}
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in sources
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert m["bound"] == 0.25
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct")


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_reports_what_it_must(workload):
    c = harness.cell(MAN, workload)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (workload, m["name"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    w = harness.by_name(MAN["workloads"], workload, "workload")
    assert w["chips"] == 1
    assert workload == f"{w['config']}.{w['traffic']}"
    c = harness.cell(MAN, workload)
    gen = harness.generator(c.config["generator"])
    op = harness.operation(c.traffic["op"])
    for fn in ("shape", "length", "pattern", "values"):
        assert callable(getattr(gen, fn))
    assert callable(op.setup) and set(op.BYTES) >= {"call"}
    for fn in ("to_host", "compare", "control"):
        assert callable(getattr(op, fn))
    assert set(op.LIMITS) and c.traffic["loop"] == "closed"
    assert c.traffic["callers"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_configs():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert c["source"] in conf["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))


def test_paths_hold_only_names_the_contract_allows():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
