"""CLI driver: ``python -m repro_torch.sparse.analysis [--all] [...]``.

Counterpart of ``python -m repro.sparse.analysis``: runs the analysis
layers and exits non-zero on the first broken contract.

* ``--invariants``   validator self-check: a battery of valid structures
  must validate clean, and seeded corruptions must each be rejected
  with the right invariant name.
* ``--contracts``    record + audit every fill/refill/multiply/SpMV path
  (dtype contract, no host synchronisation); ``--jaxpr`` is the
  reference's name for it.
* ``--vmem``         print the per-kernel resource report, measured on
  the card (``--json PATH`` also writes it as the autotuner artifact);
  on the card, its measured columns are checked against the declared.
* ``--concurrency``  AST lint of shared-cache mutations.
* ``--tuning``       tuning-table validation + lint against policy
  constants outside the tuning registry.
* ``--all``          everything above (the default with no flags).

The structures live on ``--device`` (default ``cuda``; with no card it
raises: pass ``--device cpu`` for the plain versions).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..errors import InvariantViolation


def _check_invariants(device) -> list[str]:
    """Valid structures validate clean; seeded corruptions are named."""
    from ..formats import convert
    from ..pattern import plan, plan_symmetric, trivial_pattern
    from ..spgemm import product_plan
    from .invariants import validate_matrix, validate_pattern

    failures: list[str] = []
    rows = torch.tensor([0, 1, 0, 2, 2, 2, 3], device=device)
    cols = torch.tensor([0, 0, 1, 2, 2, 3, 2], device=device)
    pat = plan(rows, cols, (4, 4))
    A = pat.assemble(torch.ones(rows.shape[0], device=device))
    valid = [
        ("SparsePattern", validate_pattern, pat),
        ("trivial_pattern", validate_pattern,
         trivial_pattern(0, (3, 3), device=device)),
        ("SymPattern", validate_pattern,
         plan_symmetric(rows, cols, (4, 4))),
        ("ProductPattern", validate_pattern, product_plan(A, A)),
        ("CSC", validate_matrix, A),
        ("CSR", validate_matrix, convert(A, "csr")),
        ("COO", validate_matrix, convert(A, "coo")),
        ("SymCSC", validate_matrix, convert(A, "symcsc")),
        ("BSR", validate_matrix, convert(A, "bsr", block=2)),
    ]
    for label, check, obj in valid:
        try:
            check(obj, subject=label)
        except InvariantViolation as e:
            failures.append(f"valid {label} rejected: {e}")

    def _corrupt(field, value):
        return dataclasses.replace(pat, **{field: value})

    indptr = pat.indptr.clone()
    indptr[[1, 2]] = indptr[[2, 1]]
    perm = pat.perm.clone()
    perm[0] = perm[1]
    slot = pat.slot.clone()
    slot[0] = pat.nzmax + 3
    seeded = [
        ("indptr-monotone", _corrupt("indptr", indptr)),
        ("perm-permutation", _corrupt("perm", perm)),
        ("epoch-valid", dataclasses.replace(pat, epoch=-1)),
        ("slot-bounds", _corrupt("slot", slot)),
    ]
    for invariant, bad in seeded:
        try:
            validate_pattern(bad, subject=f"seeded:{invariant}")
        except InvariantViolation as e:
            if e.invariant != invariant:
                failures.append(
                    f"seeded {invariant} caught as {e.invariant!r}")
        else:
            failures.append(f"seeded {invariant} NOT caught")
    return failures


def _check_tuning() -> list[str]:
    """Table entries match the registry; no re-scattered constants."""
    from .tuning_check import (format_tuning_findings, lint_tuning_constants,
                               validate_tuning_table)

    failures: list[str] = []
    try:
        checked = validate_tuning_table()
    except InvariantViolation as e:
        failures.append(str(e))
    else:
        print(f"tuning table: {checked} measured entries valid")
    findings = lint_tuning_constants()
    print(format_tuning_findings(findings))
    failures += [f["reason"] for f in findings]
    return failures


def _check_contracts(device) -> list[str]:
    from .contracts import audit_default_paths

    try:
        reports = audit_default_paths(device=device)
    except InvariantViolation as e:
        return [str(e)]
    print(f"contract audit: {len(reports)} hot paths clean on "
          f"{device.type}")
    return []


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.sparse.analysis",
        description="static analysis & sanitizers for repro_torch.sparse")
    parser.add_argument("--all", action="store_true",
                        help="run every layer (default with no flags)")
    parser.add_argument("--invariants", action="store_true")
    parser.add_argument("--contracts", "--jaxpr", action="store_true")
    parser.add_argument("--vmem", action="store_true")
    parser.add_argument("--concurrency", action="store_true")
    parser.add_argument("--tuning", action="store_true")
    parser.add_argument("--json", metavar="PATH",
                        help="also write the resource report as JSON")
    parser.add_argument("--device", default=None,
                        help="where the structures live (default cuda)")
    args = parser.parse_args(argv)
    from ...kernels.common import resolve_device

    device = resolve_device(args.device)
    none_picked = not (args.invariants or args.contracts or args.vmem
                       or args.concurrency or args.tuning)
    run_all = args.all or none_picked

    failures: list[str] = []
    if run_all or args.invariants:
        bad = _check_invariants(device)
        failures += bad
        if not bad:
            print("invariant validators: valid structures clean, "
                  "seeded corruptions rejected by name")
    if run_all or args.contracts:
        failures += _check_contracts(device)
    if run_all or args.vmem:
        from .vmem import check_report, dump_json, format_table, vmem_report

        rows = vmem_report(device=device)
        print(format_table(rows))
        failures += check_report(rows)
        if args.json:
            dump_json(rows, args.json)
            print(f"resource report written to {args.json}")
    if run_all or args.concurrency:
        from .concurrency import format_findings, lint_shared_state

        findings = lint_shared_state()
        print(format_findings(findings))
        failures += [f["reason"] for f in findings]
    if run_all or args.tuning:
        failures += _check_tuning()

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
