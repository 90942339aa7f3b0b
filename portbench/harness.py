"""One run of one cell: set-up, the measured window, the check, the
result line.

The harness is driven by ``BENCHMARK.json``: a cell names its
configuration (``configs/<config>.json``, whose ``generator`` names
``generators/<generator>.py``) and its traffic (``traffic/<traffic>.json``,
whose ``op`` names ``ops/<op>.py``); each metric the cell reports is
read by ``metrics/<metric>.py`` from the window's record (end-to-end
metrics) or from the traced run (per-layer metrics).  Adding a cell,
a configuration, a mix or a metric adds files and entries and edits
none.

An operation (``ops/<op>.py``) owns what is particular to it:
``setup`` builds its state from the seed, whose ``prepare``, ``call``
and ``traced`` make call ``k``, ``work`` counts what call ``k`` did
(the rates' numerator), ``span_bytes`` the bytes its spans needed and
``host_inputs`` what the reference needs to check call ``k``; the
module's ``to_host``, ``compare`` and ``LIMITS`` bring an answer to the
host and judge it.

The harness drives one closed-loop caller: a traffic file that asks for
another ``loop`` or more ``callers`` is refused (:data:`DRIVES`).  A
run: the operation's set-up makes the pool of inputs on the device from
the seed, every pool item is called once (the warm-up), then calls are
made one after another, each waited for, until ``seconds`` have passed
(and every pool item has been called once more).  One call drawn from
the seed and the last call are kept and, once the window has closed and
the program's state is freed, compared with the plain reference
(:mod:`portbench.reference`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from . import seeding, tracing
from .reference import check

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the longest a traced window runs: reading the profiler's events of a
#: longer one would not fit a run's time limit (tens of thousands of
#: refills)
TRACE_SECONDS = 10.0
#: what the harness drives, by traffic key: the first value is the default
DRIVES = {"loop": ("closed",), "callers": (1,)}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Window:
    """What the untraced window measured, for the end-to-end readers."""

    setup_s: float
    seconds: float            # host clock, first call to last answer
    work: int                 # the work of every call in the window
    call_ms: list             # each call, entry to answer ready
    workspace_bytes: int | None


@dataclasses.dataclass
class Run:
    window: Window
    trace: tracing.Trace | None


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    """``traffic/<name>.json``, refused where it asks for a way of
    driving calls that the harness does not implement."""
    t = load_json(PKG / "traffic" / f"{name}.json")
    for key, drives in DRIVES.items():
        if t.get(key, drives[0]) not in drives:
            raise ValueError(
                f"traffic {name!r}: {key} = {t[key]!r} is not driven by "
                f"this harness (it drives {key} in {list(drives)})")
    return t


def cell(man: dict, workload: str) -> Cell:
    w = by_name(man["workloads"], workload, "workload")
    conf = by_name(man["configs"], w["config"], "config")
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or w["name"] in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (w["name"] in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name=w["name"], chips=int(w["chips"]),
                config=load_json(ROOT / conf["file"]),
                traffic=traffic(w["traffic"]),
                end_to_end=e2e, per_layer=layer)


def generator(name: str):
    return importlib.import_module(f"portbench.generators.{name}")


def operation(name: str):
    return importlib.import_module(f"portbench.ops.{name}")


def reader(name: str):
    """``metrics/<name>.py``: a metric's name may hold dots."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Clock:
    """Time of one call, entry to answer ready: CUDA events on the card
    (the device's clock, with the host's dispatch gaps), the host's
    clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            return a
        return time.perf_counter()

    def stop(self, a) -> float:
        if self.cuda:
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        return (time.perf_counter() - a) * 1e3


def sampled_call(seed: int, pool: int) -> int:
    """Which of the window's first ``pool`` calls has its answer checked
    beside the last one's."""
    return int(seeding.host_rng(seed, seeding.SAMPLE).integers(pool))


def run_cell(c: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None):
    """One run; returns the result line as a dict.

    Calls are numbered: ``0 .. pool - 1`` warm up, the window's start at
    ``pool``.  Before each call the operation prepares its inputs
    (``state.prepare``), inside the window but outside the call's time.
    """
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    op = operation(c.traffic["op"])
    state = op.setup(generator(c.config["generator"]), c.config, c.traffic,
                     seed, dev)
    pool = state.pool
    spans = tracing.Spans(dev)
    call = (lambda k: state.traced(k, spans)) if trace else state.call
    out = None
    for k in range(pool):
        state.prepare(k)
        out = call(k)
    _sync(dev)
    spans.clear()
    setup_s = time.perf_counter() - t0

    sample = pool + sampled_call(seed, pool)
    kept, call_ms, failed = {}, [], 0
    clock = _Clock(dev)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    prof = tracing.profiler(dev) if trace else contextlib.nullcontext()
    k = pool
    with prof:
        with spans.window():
            t_start = time.perf_counter()
            deadline = t_start + (min(seconds, TRACE_SECONDS) if trace
                                  else seconds)
            # the whole pool once at least, the checked call among them
            while k < 2 * pool or time.perf_counter() < deadline:
                try:
                    state.prepare(k)
                    if trace:
                        # the call's wall time on the host's clock, the
                        # answer waited for: no CUDA event of its own
                        with spans.host("call"):
                            out = call(k)
                            _sync(dev)
                    else:
                        a = clock.start()
                        out = call(k)
                        call_ms.append(clock.stop(a))
                except Exception:  # noqa: BLE001 - counted, run goes on
                    traceback.print_exc(file=sys.stderr)
                    failed += 1
                    out = None
                if k == sample and out is not None:
                    kept[k] = out
                k += 1
            t_end = time.perf_counter()
    calls = range(pool, k)
    if out is not None:
        kept[k - 1] = out

    workspace = memory_peak = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        memory_peak = max(setup_peak, peak)
    answers = {i: op.to_host(v) for i, v in kept.items()}
    if cuda:
        held = torch.cuda.memory_allocated(dev)
        kept.clear()
        held -= torch.cuda.memory_allocated(dev)  # the answers' own bytes
        workspace = peak - base - held
    inputs = {i: state.host_inputs(i) for i in answers}

    tr = None
    if trace:
        tr = tracing.from_profiler(prof, spans, state.span_bytes(calls),
                                   len(calls))
    window = Window(setup_s=setup_s, seconds=t_end - t_start,
                    work=sum(state.work(i) for i in calls),
                    call_ms=call_ms, workspace_bytes=workspace)
    del state, out, kept, call, prof
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    correct, checks = check.verdict(op.compare(inputs, answers), op.LIMITS)
    correct = correct and failed == 0
    print(f"portbench: {c.name} seed {seed}: set-up {setup_s:.3f} s, "
          f"{len(calls)} calls in {t_end - t_start:.3f} s, {len(answers)} "
          f"answers checked in {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)

    run = Run(window=window, trace=tr)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": c.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tracing.busy_s(tr)
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tracing.breakdown(tr)
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(args, t0: float) -> int:
    man = manifest()
    c = cell(man, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"portbench: {c.name} needs {c.chips} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 2
    result = run_cell(c, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t0=t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, chk in result["checks"].items():
        print(f"check {name} = {chk['value']!r} (limit {chk['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
