"""Measurement backend of the autotuner: run and time one policy candidate.

Counterpart of ``repro/sparse/tuning/measure.py``.  Every family's
measurer runs the *public* entry point the policy steers (the dispatch
layer or the kernel family's ``ops``), with the knobs passed
explicitly, so a candidate's time includes everything the knob changes
(sort backend, digit plan, block size, kernel shape).

:func:`decision` is what a family's call site does with a policy on a
dataset's sizes (the sort backend, the digit plan, B12's block, B7's
method and shape, B9's shape); with no policy the call site resolves
its own, through the table, at the sizes its ``policy_key`` names.  The
sweep times one candidate per distinct decision (the others would time
the same launches) and checks that a recorded entry reaches its call
site.  Families with no runtime knob (``segment_sum``, ``spmv``) are not
measured.

On the card a candidate's time is its device time in milliseconds:
CUDA events around ``iters`` calls queued back to back behind a device
sleep that hides the host's dispatch, so the time is what the knobs
change (kernel shapes, passes, launches) and repeats within about 1%;
the sweep takes the median over rounds that interleave the candidates.
One call at a time, the host's dispatch jitter (30-45% between runs
at 2.5e6) would drown a 2% gain.  On the CPU (the tests) it is the
median wall clock of single calls.  :func:`run_policy` returns
a candidate's output and :func:`same_result` holds it against the
prior's: bit for bit for permutations, counts and offsets, B9's SpMV
within ``16 eps`` of each row's sum of ``|terms|``.  A candidate that
fails to build, to launch or to agree raises: nothing is skipped and
nothing falls back to the CPU.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import backend_of, kernel_spec, prior_policy

__all__ = [
    "MEASURABLE_FAMILIES",
    "candidate_policies",
    "decision",
    "make_dataset",
    "policy_key",
    "run_policy",
    "same_result",
    "time_policy",
]

#: families the measurement harness covers: those with a runtime knob
#: (``plan`` steers dispatch; ``counting_sort`` and ``spmv_sym`` have
#: knobs only in the port)
MEASURABLE_FAMILIES = (
    "plan",
    "radix_sort",
    "counting_sort",
    "merge",
    "spmv_sym",
)

#: B9's bar: each row within C_SYM * eps of its sum of |terms|
C_SYM = 16
#: the delta of the merge family's update: 1% of the stream
MERGE_FRACTION = 0.01


def make_dataset(scale: float = 1.0, seed: int = 7, *, device=None,
                 triplets=None, sym=None,
                 families=MEASURABLE_FAMILIES) -> dict:
    """One problem instance, prepared for ``families``.

    Table 4.1 set 1 at ``scale`` (full scale: L = 2.5e6), or the given
    1-based Matlab ``triplets`` ``(ii, jj, ss, siz)``.  Returns the
    triplet stream (the sorts); for ``merge`` the update's merge streams
    (the last 1% of the triplets, sorted, as queries into the sorted
    stream of the rest, B7); for ``spmv_sym`` the SymCSC ``sym`` (given,
    or the strict upper triangle and diagonal of the assembled matrix)
    and ``x`` (B9).  ``data["dims"]`` holds the sizes the call sites see
    (:func:`policy_key`, :func:`decision`).  ``device`` is ``"cuda"``
    unless the caller passes another.
    """
    from ...core.ransparse import dataset
    from ...kernels.common import resolve_device
    from ..pattern import plan

    dev = resolve_device(device)
    ii, jj, _ss, siz = triplets if triplets is not None else \
        dataset(1, seed=seed, scale=scale)
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(np.asarray(ii, np.int64) - 1).to(dev,
                                                              torch.int32)
    cols = torch.from_numpy(np.asarray(jj, np.int64) - 1).to(dev,
                                                              torch.int32)
    M = N = int(siz)
    L = int(rows.shape[0])
    dims = {"M": M, "N": N, "L": L, "nbins": M + 1}
    data = {"rows": rows, "cols": cols, "M": M, "N": N, "L": L,
            "device": dev, "dims": dims}
    if "merge" in families:
        Ld = max(1, int(L * MERGE_FRACTION))
        base = plan(rows[:L - Ld], cols[:L - Ld], (M, N), method="fused")
        q_r, q_c = rows[L - Ld:], cols[L - Ld:]
        order = torch.sort(q_c.long() * (M + 1) + q_r.long(),
                           stable=True).indices
        data.update(q_rows=q_r[order].contiguous(),
                    q_cols=q_c[order].contiguous(), t_rows=base.srows,
                    t_cols=base.scols)
        dims.update(Lq=Ld, n=int(base.srows.shape[0]))
    if "spmv_sym" in families:
        Y = _upper(rows, cols, M, N, rng, dev) if sym is None else sym
        Mx = int(Y.diag.shape[0])
        data.update(sym=Y, x=torch.from_numpy(rng.standard_normal(
            Mx).astype(np.float32)).to(dev, Y.data.dtype))
        dims.update(sym_M=Mx, nzmax=int(Y.data.shape[0]),
                    longest=None if Y.longest is None else int(Y.longest))
    return data


def _upper(rows, cols, M: int, N: int, rng, dev):
    """The strict upper triangle and the diagonal of the matrix the
    triplets assemble (random values) as a SymCSC."""
    from ..formats import SymCSC, longest_column
    from ..pattern import plan

    pat = plan(rows, cols, (M, N), method="fused")
    A = pat.assemble(torch.from_numpy(rng.standard_normal(
        rows.shape[0]).astype(np.float32)).to(dev))
    nnz = int(A.nnz)
    r = A.indices[:nnz].long()
    c = torch.searchsorted(A.indptr[1:].long(), torch.arange(nnz, device=dev),
                           right=True)
    up = r < c
    diag = torch.zeros(M, dtype=A.data.dtype, device=dev).index_add_(
        0, r[r == c], A.data[:nnz][r == c])
    uptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.bincount(c[up], minlength=N), 0)])
    uptr = uptr.to(torch.int32)
    return SymCSC(diag=diag, data=A.data[:nnz][up].contiguous(),
                  indices=A.indices[:nnz][up].contiguous(), indptr=uptr,
                  nnz=uptr[-1].clone(), shape=(M, N),
                  longest=longest_column(uptr))


def policy_key(family: str, dims: dict) -> dict:
    """The sizes ``family``'s call site resolves its policy at on a
    dataset's ``dims``: the same ``policy_key`` helper the call site
    uses, so a recorded entry is found where it is looked up."""
    if family == "plan":
        from ..dispatch import plan_key

        return plan_key(dims["M"], dims["N"], dims["L"])
    if family == "radix_sort":
        from ...kernels.radix_sort.ops import policy_key as key

        return key(dims["M"], dims["N"], dims["L"])
    if family == "counting_sort":
        from ...kernels.hist.ops import policy_key as key

        return key(dims["nbins"], dims["L"])
    if family == "merge":
        from ...kernels.merge.ref import policy_key as key

        return key(dims["n"])
    if family == "spmv_sym":
        from ...kernels.spmv_sym.ref import policy_key as key

        return key(dims["sym_M"], dims["nzmax"])
    raise ValueError(f"no measurer for family {family!r}")


def decision(family: str, dims: dict, policy: dict | None = None,
             backend="cuda"):
    """What ``family``'s call site does on ``dims`` under ``policy``
    (``None``: the policy it resolves itself through the table), as
    JSON: the sort backend, the digit plan, B12's block, B7's method and
    shape, or B9's shape."""
    pol = policy or {}
    if family == "plan":
        from ..dispatch import default_method

        out = pol.get("method") or default_method(
            backend, M=dims["M"], N=dims["N"], L=dims["L"])
    elif family == "radix_sort":
        from ...kernels.radix_sort.ops import plan_digit_passes

        out = plan_digit_passes(dims["M"], dims["N"], dims["L"],
                                max_bits=pol.get("max_bits"),
                                backend=backend)
    elif family == "counting_sort":
        from ...kernels.hist.ops import default_block_b

        out = default_block_b(dims["nbins"], L=dims["L"], backend=backend,
                              min_block_b=pol.get("min_block_b"),
                              max_block_b=pol.get("max_block_b"))
    elif family == "merge":
        from ...kernels.merge.ref import merge_shape
        from ..dispatch import default_merge_method

        method = pol.get("method") or default_merge_method(backend,
                                                           L=dims["n"])
        shape = merge_shape(dims["Lq"], dims["n"], backend=backend,
                            **{k: pol.get(k) for k in (
                                "dense_ratio", "sparse_ratio",
                                "sparse_targets")})
        out = [method, shape if method == "pallas" else None]
    elif family == "spmv_sym":
        from ...kernels.spmv_sym.ref import sym_shape

        out = sym_shape(dims["longest"], dims["sym_M"], dims["nzmax"],
                        short_column=pol.get("short_column"),
                        short_mean=pol.get("short_mean"), backend=backend)
    else:
        raise ValueError(f"no measurer for family {family!r}")
    return json.loads(json.dumps(out))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_CYCLES_PER_MS: dict = {}


def _cycles_per_ms(dev) -> float:
    """The device sleep's clock cycles a millisecond (measured once)."""
    if dev not in _CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10**8)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS[dev] = 1e8 / a.elapsed_time(b)
    return _CYCLES_PER_MS[dev]


def _time_fn(fn, dev, *, warmup: int, iters: int) -> float:
    """Time of one call of ``fn()`` in ms: on the card the device time of
    ``iters`` calls back to back behind a sleep longer than their
    dispatch (the module docstring), on the CPU the median wall clock."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * iters * host_ms * _cycles_per_ms(dev))
                          + 10**6)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _runner(family: str, policy: dict, data: dict):
    """The call of ``family``'s public entry point under ``policy``."""
    if family == "plan":
        from ..dispatch import sorted_permutation

        return lambda: (sorted_permutation(
            data["rows"], data["cols"], M=data["M"], N=data["N"],
            method=str(policy["method"])),)
    if family == "radix_sort":
        from ...kernels.radix_sort.ops import radix_sort_pair

        return lambda: (radix_sort_pair(
            data["rows"], data["cols"], M=data["M"], N=data["N"],
            max_bits=int(policy["max_bits"])),)
    if family == "counting_sort":
        from ...kernels.counting_sort.ops import counting_sort
        from ...kernels.hist.ops import default_block_b, histogram

        nbins = data["dims"]["nbins"]
        block_b = default_block_b(nbins, min_block_b=policy["min_block_b"],
                                  max_block_b=policy["max_block_b"])

        def run():
            rank, pos = counting_sort(data["rows"], nbins=nbins,
                                      block_b=block_b)
            return rank, pos, histogram(data["rows"], nbins=nbins,
                                        block_b=block_b)
        return run
    if family == "merge":
        from ..dispatch import merge_search

        kw = {}
        if str(policy["method"]) == "pallas":
            kw = {k: int(policy[k]) for k in ("dense_ratio", "sparse_ratio",
                                              "sparse_targets")}
        return lambda: (merge_search(
            data["q_rows"], data["q_cols"], data["t_rows"], data["t_cols"],
            side="left", method=str(policy["method"]), **kw),)
    if family == "spmv_sym":
        from ...kernels.spmv_sym.ops import spmv_sym

        Y = data["sym"]
        return lambda: (spmv_sym(
            Y.diag, Y.data, Y.indices, Y.indptr, data["x"],
            longest=Y.longest, short_column=int(policy["short_column"]),
            short_mean=int(policy["short_mean"])),)
    raise ValueError(f"no measurer for family {family!r}")


def run_policy(family: str, policy: dict, data: dict) -> tuple:
    """``family``'s outputs under ``policy`` (one call)."""
    return tuple(_runner(family, policy, data)())


def time_policy(family: str, policy: dict, data: dict, *, warmup: int = 2,
                iters: int = 10) -> float:
    """Time (ms; device time on the card) of one call of ``family``'s
    entry point under ``policy``."""
    return _time_fn(_runner(family, policy, data), data["device"],
                    warmup=warmup, iters=iters)


def _sym_terms(data: dict) -> torch.Tensor:
    """Each row's sum of |terms| of B9's SpMV, in float64."""
    from ...kernels.spmv_sym.ref import spmv_sym_ref

    if "sym_terms" not in data:
        Y = data["sym"]
        data["sym_terms"] = spmv_sym_ref(
            Y.diag.double().abs(), Y.data.double().abs(), Y.indices,
            Y.indptr, data["x"].double().abs())
    return data["sym_terms"]


def same_result(family: str, got: tuple, want: tuple, data: dict) -> str:
    """Raise unless a candidate's outputs ``got`` agree with the prior's
    ``want``; returns how they were compared."""
    if family == "spmv_sym":
        eps = float(torch.finfo(want[0].dtype).eps)
        err = (got[0].double() - want[0].double()).abs()
        bar = C_SYM * eps * _sym_terms(data)
        if not bool(torch.all(err <= bar)):
            raise RuntimeError(f"{family}: a candidate differs from the "
                               f"prior by more than {C_SYM} eps sum|terms|")
        return f"within {C_SYM} eps sum|terms|"
    if len(got) != len(want) or not all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want)):
        raise RuntimeError(f"{family}: a candidate's output differs from "
                           "the prior's")
    return "bit for bit"


def candidate_policies(family: str, backend=None) -> list:
    """Prior-anchored candidate grid: the prior itself, then each knob
    swept over its declared candidates allowed on ``backend``
    (``Knob.allowed``: on ``cuda`` the hand-written kernels only), the
    others held at prior."""
    spec = kernel_spec(family)
    backend = backend_of(backend)
    prior = prior_policy(family, backend)
    out = [dict(prior)]
    for knob in spec.knobs:
        for cand in knob.candidates:
            pol = dict(prior, **{knob.name: cand})
            if knob.allows(cand, backend) and pol not in out:
                out.append(pol)
    return out
