"""The comparison that decides ``correct``.

Two numbers, each with its limit:

* ``structure_mismatch``: how many entries of the CSC's structure
  differ from the reference's: the gap between the two ``nnz``, the
  column pointers that differ and the row indices of the first
  ``nnz`` slots that differ.  Exact: the limit is 0.
* ``data_rel_err``: the widest gap between a nonzero's value and the
  reference's float64 sum, over the sum of its terms' magnitudes (0
  where both are 0).  The readings the limit was set from are in
  ``PERF.md``: float32 sums of a few terms read about 1e-7, the
  bfloat16 control about 2e-3.

Answers are numpy arrays: ``data``, ``indices`` (length ``nzmax``),
``indptr`` (``N + 1``) and ``nnz`` (:func:`csc_to_host`).  The inputs
of a checked call are the triplets the benchmark handed to the port,
on the host: ``rows``, ``cols``, ``vals``, ``shape`` and ``pattern``, a
key that two calls share only where their triplets' indices are the
same (:func:`compare_csc`).
"""
from __future__ import annotations

import numpy as np

from . import csc

LIMITS = {"structure_mismatch": 0, "data_rel_err": 1e-4}


def structure_mismatch(ans: dict, st: csc.Structure) -> int:
    nnz = int(ans["nnz"])
    n = min(nnz, st.nnz)
    bad = abs(nnz - st.nnz)
    indptr = np.asarray(ans["indptr"], dtype=np.int64)
    if indptr.shape != st.indptr.shape:
        return bad + max(indptr.size, st.indptr.size)
    bad += int(np.count_nonzero(indptr != st.indptr))
    indices = np.asarray(ans["indices"][:n], dtype=np.int64)
    bad += int(np.count_nonzero(indices != st.indices[:n]))
    return bad


def data_rel_err(data: np.ndarray, ref: np.ndarray,
                 absum: np.ndarray) -> float:
    n = min(data.size, ref.size)
    if data.size < ref.size:
        return float("inf")
    gap = np.abs(np.asarray(data[:n], dtype=np.float64) - ref[:n])
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(gap == 0, 0.0, gap / absum[:n])
    if rel.size == 0:
        return 0.0
    worst = float(np.max(rel))
    return worst if np.isfinite(worst) else float("inf")


def readings(ans: dict, st: csc.Structure, vals: np.ndarray) -> dict:
    """The two numbers for one answer to the triplets whose structure is
    ``st`` and whose values are ``vals``."""
    data, absum = csc.sums(vals, st)
    return {"structure_mismatch": structure_mismatch(ans, st),
            "data_rel_err": data_rel_err(np.asarray(ans["data"]), data,
                                         absum)}


def control_readings(st: csc.Structure, vals: np.ndarray) -> dict:
    """The same numbers for the control: the reference's own structure
    with its sums in bfloat16."""
    data, absum = csc.sums(vals, st)
    return {"structure_mismatch": 0,
            "data_rel_err": data_rel_err(csc.sums_bf16(vals, st), data,
                                         absum)}


def csc_to_host(out) -> dict:
    """A CSC answer of the port, on the host."""
    return {"data": out.data.detach().cpu().numpy(),
            "indices": out.indices.cpu().numpy(),
            "indptr": out.indptr.cpu().numpy(),
            "nnz": int(out.nnz)}


def _structures(inputs: dict) -> dict:
    """One reference structure a distinct pattern among the calls."""
    out = {}
    for inp in inputs.values():
        if inp["pattern"] not in out:
            out[inp["pattern"]] = csc.structure(inp["rows"], inp["cols"],
                                                inp["shape"])
    return out


def compare_csc(inputs: dict, answers: dict) -> dict:
    """Each number's worst reading over the calls ``answers`` keeps (call
    index to :func:`csc_to_host`), against the reference worked out
    from ``inputs`` (call index to the call's triplets)."""
    st = _structures(inputs)
    return worst([readings(answers[k], st[inp["pattern"]], inp["vals"])
                  for k, inp in inputs.items() if k in answers])


def control_csc(inputs: dict) -> dict:
    """The control's worst readings over the same calls."""
    st = _structures(inputs)
    return worst([control_readings(st[inp["pattern"]], inp["vals"])
                  for inp in inputs.values()])


def worst(per_answer: list[dict]) -> dict:
    """Each number's worst reading over the answers checked."""
    if not per_answer:
        return {k: float("inf") for k in LIMITS}
    return {k: max(r[k] for r in per_answer) for k in LIMITS}


def verdict(numbers: dict, limits: dict = LIMITS) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), out
