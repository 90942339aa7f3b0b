"""The autotuner CLI: ``python -m repro_torch.sparse.tuning``.

Counterpart of ``python -m repro.sparse.tuning``.  Two modes:

* ``--prior-only`` (no measurement): resolve every registered family's
  policy from the priors, consume a resource report (``--vmem-report``,
  :func:`repro_torch.sparse.analysis.vmem.dump_json`) row by row (each
  row's build-time knobs must be what the registry resolves for its
  family: the report and the dispatch layer share one source of truth)
  and write the resolved table (``--json``).  Exits non-zero on any
  unconsumed or mismatched row.
* ``--measure``: run and time every candidate policy per family on
  ``--device`` (default ``cuda``; ``cpu`` for the tests) on Table 4.1
  set 1 at ``--scale`` (full scale: L = 2.5e6; device time on the card,
  the median of interleaved rounds, :mod:`.measure`), hold each
  candidate's output against the prior's (:func:`.measure.same_result`),
  and record
  every winner that beats its prior by more than ``--min-gain`` into the
  tuning table, persisted to ``--cache-dir`` (default:
  ``$REPRO_TUNING_CACHE_DIR``), keyed at the sizes its call site
  resolves at.  Candidates that lead their call site to the same
  decision are timed once.  A candidate that fails to build, launch or
  agree ends the run with an error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from . import (TABLE_FILENAME, backend_of, default_cache_path, get_table,
               kernel_spec, prior_policy, registered_families,
               resolve_policy)


def consume_vmem_report(path, backend=None) -> tuple[int, list[str]]:
    """Check every report row against the resolved policies.

    Returns ``(consumed_rows, failures)``; a row fails when its family is
    not registered or one of its knobs diverges from the policy the
    registry resolves for that family on ``backend``.
    """
    with open(path) as fh:
        rows = json.load(fh)["vmem_report"]
    failures: list[str] = []
    consumed = 0
    for row in rows:
        fam = row.get("family")
        try:
            kernel_spec(fam)
        except KeyError:
            failures.append(f"unconsumed resource row {row.get('name')!r}: "
                            f"unregistered family {fam!r}")
            continue
        pol = resolve_policy(fam, backend=backend, measured=False)
        bad = {k: v for k, v in row.get("knobs", {}).items()
               if pol.get(k) != v}
        if bad:
            failures.append(
                f"resource row {row.get('name')}: knobs {bad} differ from "
                f"the resolved {fam!r} policy "
                f"{ {k: pol.get(k) for k in bad} }")
            continue
        consumed += 1
    return consumed, failures


def _artifact(backend: str, consumed_rows: int | None = None) -> dict:
    table = get_table()
    return {
        "schema": 1,
        "backend": backend,
        "fingerprint": table.fingerprint(),
        "priors": {fam: prior_policy(fam, backend)
                   for fam in registered_families()},
        "resolved": {fam: resolve_policy(fam, backend=backend)
                     for fam in registered_families()},
        "entries": table.entries(),
        "consumed_vmem_rows": consumed_rows,
    }


def sweep(family: str, data: dict, *, min_gain: float = 0.02,
          warmup: int = 2, iters: int = 10, rounds: int = 3,
          log=print) -> dict:
    """Hold every candidate's output of ``family`` on ``data`` against
    the prior's, time one candidate per distinct call-site decision (the
    median of ``rounds`` rounds over the candidates in turn, ``iters``
    calls each), and record the winner into the global table, at the
    sizes its call site resolves at, if it beats the prior by more than
    ``min_gain``.  A recorded entry that its call site does not then
    resolve to raises."""
    import torch

    from .measure import (candidate_policies, decision, policy_key,
                          run_policy, same_result, time_policy)

    dev = data["device"]
    backend = backend_of(dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    dims = data["dims"]
    runtime = [k.name for k in kernel_spec(family).knobs if not k.build]

    def shown(pol):  # the swept knobs (build-time ones never change)
        return {k: pol[k] for k in runtime}

    cands, seen = [], []
    for pol in candidate_policies(family, backend):
        how = decision(family, dims, pol, backend)
        if how not in seen:
            seen.append(how)
            cands.append(pol)
    prior = cands[0]
    want = run_policy(family, prior, data)
    hows = [same_result(family, run_policy(family, pol, data), want, data)
            for pol in cands]
    times = [[time_policy(family, pol, data, warmup=warmup, iters=iters)
              for pol in cands] for _ in range(rounds)]
    timed = []
    for i, (pol, how) in enumerate(zip(cands, hows)):
        ms = float(np.median([t[i] for t in times]))
        timed.append((ms, pol))
        what = str(seen[i])
        what = what if len(what) <= 60 else what[:57] + "..."
        log(f"{family} L={data['L']}: {shown(pol)} -> {ms:.4f} ms on {card} "
            f"({what}; output {how} to the prior's)")
    prior_ms = timed[0][0]
    best_ms, best = min(timed, key=lambda t: t[0])
    gain = prior_ms / best_ms - 1.0 if best_ms > 0 else 0.0
    recorded = best != prior and gain > min_gain
    key = policy_key(family, dims)
    if recorded:
        get_table().record(family, {k: v for k, v in best.items()
                                    if v != prior[k]},
                           backend=backend, **key)
        if decision(family, dims, None, backend) != seen[cands.index(best)]:
            raise RuntimeError(
                f"{family}: the entry recorded at {key} does not reach its "
                "call site")
    log(f"{family} L={data['L']}: {len(cands)} distinct of "
        f"{len(candidate_policies(family, backend))} candidates; best "
        f"{shown(best)} ({best_ms:.4f} ms against the prior's "
        f"{prior_ms:.4f} ms, gain {gain * 100:.1f}%) -> "
        f"{'recorded at ' + str(key) if recorded else 'prior kept'}")
    return {"family": family, "L": data["L"], "card": card, "prior": prior,
            "prior_ms": prior_ms, "best": best, "best_ms": best_ms,
            "gain": gain, "recorded": recorded, "key": key, "dims": dims,
            "decision": decision(family, dims, None, backend),
            "candidates": [{"policy": p, "ms": t, "decision": d}
                           for (t, p), d in zip(timed, seen)]}


def run_measure(families=None, *, datasets=None, scale: float = 1.0,
                min_gain: float = 0.02, device=None, log=print) -> list:
    """Sweep ``families`` (default: every measurable one) on set 1 at
    ``scale``, or on ``datasets``: ``(data, families)`` pairs of
    :func:`.measure.make_dataset` results, each swept for its families."""
    from .measure import MEASURABLE_FAMILIES, make_dataset

    families = tuple(families or MEASURABLE_FAMILIES)
    for fam in families:
        if fam not in MEASURABLE_FAMILIES:
            raise ValueError(f"no measurer for family {fam!r}; measurable: "
                             f"{MEASURABLE_FAMILIES}")
    if datasets is None:
        datasets = [(make_dataset(scale=scale, device=device), families)]
    return [sweep(fam, data, min_gain=min_gain, log=log)
            for data, fams in datasets for fam in fams]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.sparse.tuning",
        description="measured autotuner for the port's kernel policies")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--prior-only", action="store_true",
                      help="resolve priors without measuring")
    mode.add_argument("--measure", action="store_true",
                      help="time candidates and record measured winners")
    parser.add_argument("--families", nargs="*", default=None,
                        help="restrict measurement to these families")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--min-gain", type=float, default=0.02,
                        help="fractional speedup a candidate must beat "
                             "the prior by")
    parser.add_argument("--device", default=None,
                        help="where to measure (default cuda)")
    parser.add_argument("--vmem-report", metavar="PATH",
                        help="resource report JSON to consume")
    parser.add_argument("--json", metavar="PATH",
                        help="write the resolved-table artifact here")
    parser.add_argument("--cache-dir", metavar="DIR",
                        help="persist the table to DIR/" + TABLE_FILENAME)
    args = parser.parse_args(argv)
    from ...kernels.common import resolve_device

    backend = backend_of(resolve_device(args.device))

    failures: list[str] = []
    consumed = None
    if args.measure:
        run_measure(args.families, scale=args.scale,
                    min_gain=args.min_gain, device=args.device)
    if args.vmem_report:
        consumed, bad = consume_vmem_report(args.vmem_report, backend)
        failures += bad
        print(f"resource report: {consumed} rows consumed against the "
              "resolved policies")

    table = get_table()
    path = Path(args.cache_dir) / TABLE_FILENAME if args.cache_dir else (
        default_cache_path() if args.measure and len(table) else None)
    if path is not None:
        table.save(path)
        print(f"tuning table ({len(table)} measured entries) -> {path}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(_artifact(backend, consumed), fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
        print(f"resolved-table artifact -> {args.json}")

    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
