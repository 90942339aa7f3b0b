#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: the card's name and count, and its power limit from
   nvidia-smi; no CUDA device is a failure.
2. build: compiles every kernel of both paths from ``src/repro_torch/
   csrc`` (one nvcc per source, all started together) and prints each
   kernel's ``-Xptxas -v`` report.
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on the streams its path gives it at L = 2.5e6 and 5e7: B1
   digit histogram, B2 stable digit placement, B12 block histogram and
   B11 counting-sort placement bit for bit; B3' fused sum and B5 prefix
   sum bit for bit on integer-valued data and within their stated
   tolerances on random float32/float64; B4 fused min/max bit for bit,
   NaN included.
4. main path: ``repro_torch.sparse.fsparse`` (Matlab ``sparse``) on the
   paper's Table 4.1 sets 1-3 at full scale and on set 2 scaled to
   L = 5e7, each matched bit for bit against the port's numpy oracle,
   then a refill ``pattern.assemble(v)`` with random float32 values
   against the oracle in float64.  The kernels' launch counters are set
   to 0 before this phase and must rise by exactly the planned passes.
4b. second path, on the same sets and the oracles of phase 4:
   ``fsparse(..., method="pallas")`` (the paper's counting sort, B12 and
   B11) bit for bit against the oracle, its permutation against the
   radix plan's; the unfused ``fill_pallas`` (B5) against the oracle
   within B5's tolerance; ``accum="min"|"max"|"mean"|"first"|"last"``
   on sets 1 and 3 against numpy (min/max through B4, also against its
   plain version); ``sparse2`` twice, a miss and then a hit that runs no
   plan kernel and one fill.  Counters are set to 0 before this phase
   and must rise by exactly the expected launches.
5. times, with CUDA events: the device time of the plan (radix and
   counting sort), the fill (fused and unfused), each kernel, its plain
   version and a PyTorch yardstick (calls back to back behind a device
   sleep that hides the host's dispatch), and the time of one call as a
   caller pays it (device plus dispatch gaps; the ratio of the two is
   the device's idle share); host-clock medians of the whole
   ``fsparse`` call, of a ``sparse2`` miss and hit, and of building
   and hashing the ``sparse2`` key.

The last lines are the ``{"kernels": [...]}`` summary, the nvidia-smi
line and ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
#: 32-bit non-tensor-core rate, used for the ops bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Table 4.1 sets at full scale, plus set 2 scaled to L = 5e7
BIG = dict(siz=1_000_000, nnz_row=50, nrep=1)
SEED = 0
REPS = 20
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
#: B5's tolerance: each prefix within C_SCAN * eps of the running sum of
#: |x| (kernel and plain version both add in trees of depth under 64);
#: a difference of two prefixes (fill_pallas) within twice that
C_SCAN = 64
ACCUM_SETS = ("1", "3")
ACCUM_MODES = ("min", "max", "mean", "first", "last")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def call_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn()``, in ms: the device
    time plus any gap while the host dispatches (as a caller pays it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = _events()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sleep_cycles_per_ms() -> float:
    a, b = _events()
    a.record()
    torch.cuda._sleep(10**8)
    b.record()
    b.synchronize()
    return 1e8 / a.elapsed_time(b)


def device_ms(fn, cycles_per_ms: float, reps: int = REPS) -> float:
    """Mean device time of ``fn()`` in ms, ``reps`` calls back to back.

    The device first sleeps for longer than the host takes to enqueue
    all the calls, so no host dispatch gap falls between the events.
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    a, b = _events()
    torch.cuda._sleep(int(2 * reps * host * cycles_per_ms) + 10**6)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn()`` ending in a synchronize, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def slot_ids(i0: np.ndarray, j0: np.ndarray, M: int):
    """Each triplet's output slot (the oracle's order: columns, then
    rows), and the input positions of each slot's first and last
    triplet."""
    order = np.lexsort((i0, j0))
    key = j0[order].astype(np.int64) * M + i0[order]
    start = np.empty(key.shape, bool)
    start[0] = True
    start[1:] = key[1:] != key[:-1]
    end = np.empty(key.shape, bool)
    end[-1] = True
    end[:-1] = start[1:]
    slot = np.empty(key.shape, np.int64)
    slot[order] = np.cumsum(start) - 1
    return slot, order[start], order[end]


def numpy_accum(v: np.ndarray, slot, first, last, accum: str):
    """The duplicate modes in numpy over the oracle's slot ids."""
    nnz = first.shape[0]
    if accum in ("min", "max"):
        out = np.full(nnz, np.inf if accum == "min" else -np.inf, v.dtype)
        (np.minimum if accum == "min" else np.maximum).at(out, slot, v)
        return out
    if accum == "mean":
        return (np.bincount(slot, weights=v.astype(np.float64),
                            minlength=nnz)
                / np.bincount(slot, minlength=nnz))
    return v[first if accum == "first" else last]


def main() -> None:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.oracle import matlab_sparse_oracle
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels import common
    from repro_torch.kernels.assembly_ops import fill_pallas
    from repro_torch.kernels.counting_sort import counting_sort as cs_mod
    from repro_torch.kernels.counting_sort.ref import placement_ref
    from repro_torch.kernels.hist import hist as hist_mod
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.kernels.hist.ref import block_histogram_ref
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ops import (digit_bases,
                                                    plan_digit_passes,
                                                    radix_sort_pair)
    from repro_torch.kernels.radix_sort.ref import (
        digit_block_histogram_ref, digit_placement_ref, radix_sort_pair_ref)
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import (
        blocked_cumsum_ref, gather_segment_minmax_ref, gather_segment_sum_ref)
    from repro_torch.sparse.matlab import (_cache_key, expand_indices,
                                           fsparse, plan_cache_clear,
                                           plan_cache_info, sparse2)
    from repro_torch.sparse.pattern import (first_flags, pattern_from_perm,
                                            plan_coo)
    from repro_torch.core.coo import coo_from_matlab, host_triplets

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"device: {kind} (count {count}); {smi_line}", flush=True)
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = common.build(["radix_sort", "segment_sum", "hist",
                         "counting_sort"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    hist_k, place_k = rs.digit_block_histogram, rs.digit_placement
    fill_k = ss_mod.gather_segment_sum
    minmax_k, scan_k = ss_mod.gather_segment_minmax, ss_mod.blocked_cumsum
    bhist_k, cplace_k = hist_mod.block_histogram, cs_mod.placement
    TILE = rs.TILE

    # data: the paper's Table 4.1 sets at full scale + the L = 5e7 set
    sets = {}
    for k, cfg in DATA_SETS.items():
        sets[str(k)] = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                 seed=SEED)
    t0 = time.perf_counter()
    sets["2x20"] = ransparse(BIG["siz"], BIG["nnz_row"], BIG["nrep"],
                             seed=SEED)
    print(f"data: L = 5e7 set generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    refill = {k: rng.standard_normal(v[0].shape[0]).astype(np.float32)
              for k, v in sets.items()}

    # -- 3. kernel vs plain on the card -------------------------------------
    b3_err = 0.0  # B1 and B2 are integer kernels: checked bit for bit
    for name in ("2", "2x20"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        rows, cols, L = coo.rows, coo.cols, coo.L
        perm = None
        for p in plan_digit_passes(siz, siz, L):
            src = cols if p.src_col else rows
            keys = src if perm is None else src[perm]
            kw = dict(shift=p.shift, bits=p.bits, nbins=p.nbins)
            h = hist_k(keys, **kw)
            require(torch.equal(h, digit_block_histogram_ref(
                keys, tile=TILE, **kw)), f"B1 differs on set {name}, {p}")
            base = digit_bases(h)
            nxt = place_k(keys, base, perm, **kw)
            require(torch.equal(nxt, digit_placement_ref(
                keys, base, perm, tile=TILE, **kw)),
                f"B2 differs on set {name}, {p}")
            perm = nxt
        require(torch.equal(perm, radix_sort_pair_ref(rows, cols, M=siz,
                                                      N=siz)),
                f"radix permutation differs from the stable sort, set {name}")
        pat = pattern_from_perm(rows, cols, perm, M=siz, N=siz, nzmax=L)
        fill_args = (pat.perm, pat.slot)
        nz = dict(num_segments=pat.nzmax)
        vi = torch.from_numpy(
            rng.integers(-8, 9, L).astype(np.float32)).to(dev)
        require(torch.equal(fill_k(vi, *fill_args, **nz),
                            gather_segment_sum_ref(vi, *fill_args, **nz)),
                f"B3' differs on integer-valued data, set {name}")
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            vn = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
            got = fill_k(vn, *fill_args, **nz)
            want = gather_segment_sum_ref(vn, *fill_args, **nz)
            mag = gather_segment_sum_ref(vn.abs(), *fill_args, **nz).max()
            err = float((got - want).abs().max())
            atol = float(8 * eps * mag)
            require(err <= atol, f"B3' {dtype} error {err} > {atol}, "
                    f"set {name}")
            if dtype == torch.float32:
                b3_err = max(b3_err, err)
            emit({"check": "B3' vs plain", "set": name, "dtype": str(dtype),
                  "max_abs_err": err, "atol": atol})
        emit({"check": "B1, B2, B3' vs plain", "set": name, "L": L,
              "passes": len(plan_digit_passes(siz, siz, L)),
              "B1": "bit-identical", "B2": "bit-identical",
              "B3_integer": "bit-identical"})
        del coo, rows, cols, perm, pat, fill_args, keys, nxt, h, base
    torch.cuda.synchronize()

    # -- 3b. kernel vs plain: the second path's kernels ---------------------
    b5_err = 0.0  # B4, B11 and B12 are checked bit for bit
    for name in ("3", "2x20"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        L = coo.L
        arange = torch.arange(L, dtype=torch.int32, device=dev)
        # B12 and B11 on the counting sort's two passes (rows, then the
        # row-ordered cols) at the path's block size
        nbins = siz + 1
        block_b = default_block_b(nbins)
        keys = coo.rows
        for p in ("rows", "cols"):
            kw = dict(nbins=nbins, block_b=block_b)
            require(torch.equal(bhist_k(keys, **kw),
                                block_histogram_ref(keys, **kw)),
                    f"B12 differs on set {name}, {p} pass")
            offsets, _ = block_offsets(keys, **kw)
            pos = cplace_k(keys, offsets, **kw)
            require(torch.equal(pos, placement_ref(keys, offsets, **kw)),
                    f"B11 differs on set {name}, {p} pass")
            rank = torch.empty_like(pos)
            rank[pos] = arange
            keys = coo.cols[rank]
        del offsets, pos, rank, keys
        # B4 on the plan's streams, with two NaNs
        pat = plan_coo(coo)
        nz = dict(num_segments=pat.nzmax)
        for dtype in (torch.float32, torch.float64):
            v = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
            v[[3, L // 2]] = float("nan")
            for op in ("min", "max"):
                got = minmax_k(v, pat.perm, pat.slot, op=op, **nz)
                require(bool(torch.isnan(got).any()), "B4 lost the NaN")
                require(same_bits(got, gather_segment_minmax_ref(
                    v, pat.perm, pat.slot, op=op, **nz)),
                    f"B4 {op} {dtype} differs, set {name}")
        # B5 on the unfused fill's stream: the masked vals[perm]
        keep = pat.slot < pat.nzmax
        vi = torch.from_numpy(rng.integers(-8, 9, L).astype(np.float32))
        xi = torch.where(keep, vi.to(dev)[pat.perm], 0)
        require(torch.equal(scan_k(xi), blocked_cumsum_ref(xi)),
                f"B5 differs on integer-valued data, set {name}")
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            vn = torch.from_numpy(rng.standard_normal(L)).to(dev, dtype)
            x = torch.where(keep, vn[pat.perm], 0)
            err = (scan_k(x) - blocked_cumsum_ref(x)).abs().double()
            tol = C_SCAN * eps * torch.cumsum(x.abs().double(), 0)
            require(bool(torch.all(err <= tol)),
                    f"B5 {dtype} error above {C_SCAN} eps x running "
                    f"sum|x|, set {name}")
            if dtype == torch.float32:
                b5_err = max(b5_err, float(err.max()))
            emit({"check": "B5 vs plain", "set": name, "dtype": str(dtype),
                  "max_abs_err": float(err.max()),
                  "max_err_over_tol": float((err / tol.clamp(
                      min=1e-300)).max())})
        emit({"check": "B4, B5, B11, B12 vs plain", "set": name, "L": L,
              "nbins": nbins, "block_b": block_b,
              "B4": "bit-identical (NaN included)",
              "B5_integer": "bit-identical", "B11": "bit-identical",
              "B12": "bit-identical"})
        del coo, arange, pat, v, got, keep, vi, xi, vn, x, err, tol
        torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # -- 4. main path -------------------------------------------------------
    counters = (hist_k, place_k, fill_k)
    for f in counters:
        f.launches = 0
    expected = {"B1": 0, "B2": 0, "B3": 0}
    oracles = {}
    for name, (ii, jj, ss, siz) in sets.items():
        L = ii.shape[0]
        npass = len(plan_digit_passes(siz, siz, L))
        t0 = time.perf_counter()
        S = fsparse(ii, jj, ss, (siz, siz))
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        pat = plan_coo(coo)
        v = refill[name]
        R = pat.assemble(torch.from_numpy(v).to(dev))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        expected["B1"] += 2 * npass
        expected["B2"] += 2 * npass
        expected["B3"] += 2
        got = {"B1": hist_k.launches, "B2": place_k.launches,
               "B3": fill_k.launches}
        require(got == expected, f"launch counts {got} != {expected} "
                f"after set {name}")
        i0, j0 = ii - 1, jj - 1
        t0 = time.perf_counter()
        pr, ir, jc = matlab_sparse_oracle(i0, j0, ss, siz, siz)
        pr_v, _, _ = matlab_sparse_oracle(i0, j0, v.astype(np.float64),
                                          siz, siz)
        mag, _, _ = matlab_sparse_oracle(i0, j0,
                                         np.abs(v).astype(np.float64),
                                         siz, siz)
        oracle_s = time.perf_counter() - t0
        oracles[name] = (pr, ir, jc, pr_v, mag)
        for A, what in ((S, "fsparse"), (R, "refill")):
            nnz = int(A.nnz)
            require(nnz == pr.shape[0], f"{what} nnz {nnz} != oracle "
                    f"{pr.shape[0]}, set {name}")
            require(np.array_equal(A.indptr.cpu().numpy(), jc),
                    f"{what} indptr differs, set {name}")
            require(np.array_equal(A.indices[:nnz].cpu().numpy(), ir),
                    f"{what} indices differ, set {name}")
        nnz = pr.shape[0]
        data = S.data[:nnz].cpu().numpy()
        require(np.array_equal(data, pr.astype(np.float32)),
                f"fsparse data differs from the oracle, set {name}")
        require(float(pr.max()) < 2**24, "sums past 2^24")
        rdata = R.data[:nnz].cpu().numpy().astype(np.float64)
        rerr = np.abs(rdata - pr_v)
        require(np.all(np.isfinite(rdata)), f"non-finite refill, set {name}")
        require(np.all(rerr <= 1e-5 * mag),
                f"refill error {float((rerr / np.maximum(mag, 1e-300)).max())}"
                f" x sum|v| > 1e-5, set {name}")
        emit({"main_path": name, "L": int(L), "M": siz, "N": siz,
              "nnz": int(nnz), "passes": npass,
              "fsparse": "bit-identical to oracle",
              "refill_max_err_over_sum_abs": float(
                  (rerr / np.maximum(mag, 1e-300)).max()),
              "run_s": run_s, "oracle_s": oracle_s})
        del S, R, pat, coo
    launches = {"B1": hist_k.launches, "B2": place_k.launches,
                "B3": fill_k.launches}
    emit({"main_path_launches": launches, "expected": expected})
    for k in ("B1", "B2", "B3"):
        require(launches[k] > 0, f"kernel {k} never launched on the main "
                "path")

    # -- 4b. second path: counting sort, unfused fill, duplicate modes,
    #    sparse2 -------------------------------------------------------------
    kernels = {"B1": hist_k, "B2": place_k, "B3": fill_k, "B4": minmax_k,
               "B5": scan_k, "B11": cplace_k, "B12": bhist_k}

    def counts() -> dict:
        return {k: f.launches for k, f in kernels.items()}

    for f in kernels.values():
        f.launches = 0
    exp2 = dict.fromkeys(kernels, 0)
    for name, (ii, jj, ss, siz) in sets.items():
        L = ii.shape[0]
        npass = len(plan_digit_passes(siz, siz, L))
        pr, ir, jc, pr_v, mag = oracles[name]
        nnz = pr.shape[0]
        t0 = time.perf_counter()
        S = fsparse(ii, jj, ss, (siz, siz), method="pallas")
        exp2["B12"] += 2
        exp2["B11"] += 2
        exp2["B3"] += 1
        require(int(S.nnz) == nnz, f"pallas nnz differs, set {name}")
        require(np.array_equal(S.indptr.cpu().numpy(), jc)
                and np.array_equal(S.indices[:nnz].cpu().numpy(), ir)
                and np.array_equal(S.data[:nnz].cpu().numpy(),
                                   pr.astype(np.float32)),
                f"fsparse(method='pallas') differs from the oracle, "
                f"set {name}")
        coo = coo_from_matlab(ii, jj, refill[name], (siz, siz))
        pat_p = plan_coo(coo, method="pallas")
        pat = plan_coo(coo)
        exp2["B12"] += 2
        exp2["B11"] += 2
        exp2["B1"] += npass
        exp2["B2"] += npass
        require(torch.equal(pat_p.perm, pat.perm)
                and torch.equal(pat_p.slot, pat.slot),
                f"pallas permutation differs from the radix one, set {name}")
        F = fill_pallas(pat, coo.vals)
        exp2["B5"] += 1
        ferr = np.abs(F.data[:nnz].cpu().numpy().astype(np.float64) - pr_v)
        ftol = 2 * C_SCAN * EPS32 * np.cumsum(mag)
        require(np.all(ferr <= ftol), f"fill_pallas error above "
                f"{2 * C_SCAN} eps x running sum|v|, set {name}")
        row = {"second_path": name, "L": int(L), "nnz": int(nnz),
               "pallas_fsparse": "bit-identical to oracle",
               "pallas_perm": "bit-identical to radix",
               "fill_pallas_max_abs_err": float(ferr.max()),
               "fill_pallas_max_err_over_tol": float(
                   (ferr / np.maximum(ftol, 1e-300)).max())}
        if name in ACCUM_SETS:
            slot, fpos, lpos = slot_ids(ii - 1, jj - 1, siz)
            v32 = refill[name]
            n = np.bincount(slot, minlength=nnz)
            for accum in ACCUM_MODES:
                A = fsparse(ii, jj, v32.astype(np.float64), (siz, siz),
                            accum=accum)
                exp2["B1"] += npass
                exp2["B2"] += npass
                exp2["B4"] += accum in ("min", "max")
                exp2["B3"] += accum == "mean"
                got = A.data[:nnz].cpu().numpy()
                want = numpy_accum(v32, slot, fpos, lpos, accum)
                require(int(torch.count_nonzero(A.data[nnz:])) == 0,
                        f"accum={accum}: non-zero tail, set {name}")
                if accum == "mean":
                    ok = np.all(np.abs(got - want) <= 8 * EPS32 * mag / n)
                else:
                    ok = np.array_equal(got, want)
                require(ok, f"accum={accum} differs from numpy, set {name}")
                if accum in ("min", "max"):
                    require(torch.equal(A.data, gather_segment_minmax_ref(
                        coo.vals, pat.perm, pat.slot,
                        num_segments=pat.nzmax, op=accum)),
                        f"accum={accum} differs from B4's plain version, "
                        f"set {name}")
            row["accum"] = {"modes": list(ACCUM_MODES),
                            "min_max_first_last": "bit-identical to numpy",
                            "mean": "within 8 eps x sum|v| / count"}
        plan_cache_clear()
        A = sparse2(ii, jj, ss, (siz, siz))
        exp2["B1"] += npass
        exp2["B2"] += npass
        exp2["B3"] += 1
        before = counts()
        B = sparse2(ii, jj, ss, (siz, siz))
        exp2["B3"] += 1
        after = counts()
        require(all(after[k] == before[k] for k in ("B1", "B2", "B11",
                                                    "B12"))
                and after["B3"] == before["B3"] + 1,
                f"sparse2 hit launched {before} -> {after}, set {name}")
        info = plan_cache_info()
        require((info["misses"], info["hits"]) == (1, 1),
                f"sparse2 cache {info}, set {name}")
        require(torch.equal(A.data, B.data) and np.array_equal(
            B.data[:nnz].cpu().numpy(), pr.astype(np.float32)),
            f"sparse2 differs from the oracle, set {name}")
        plan_cache_clear()
        torch.cuda.synchronize()
        row["sparse2"] = "miss then hit, bit-identical to oracle"
        row["run_s"] = time.perf_counter() - t0
        require(counts() == exp2, f"launch counts {counts()} != {exp2} "
                f"after set {name}")
        emit(row)
        del S, coo, pat_p, pat, F, A, B
        torch.cuda.empty_cache()
    launches2 = counts()
    emit({"second_path_launches": launches2, "expected": exp2})
    for k in ("B4", "B5", "B11", "B12"):
        require(launches2[k] > 0, f"kernel {k} never launched on its path")
    del oracles

    # -- 5. times -----------------------------------------------------------
    cpm = sleep_cycles_per_ms()
    per_kernel = {}
    for name, (ii, jj, ss, siz) in sets.items():
        L = ii.shape[0]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        rows, cols = coo.rows, coo.cols
        pat = plan_coo(coo)
        v = torch.from_numpy(refill[name]).to(dev)
        passes = plan_digit_passes(siz, siz, L)
        t = {"times": name, "L": int(L), "passes": len(passes)}
        for what, fn in (("plan", lambda: plan_coo(coo)),
                         ("fill", lambda: pat.assemble(v))):
            t[f"{what}_ms"] = call_ms(fn)
            t[f"{what}_device_ms"] = device_ms(fn, cpm)
            t[f"{what}_device_idle_share"] = \
                1.0 - t[f"{what}_device_ms"] / t[f"{what}_ms"]
        # the plan's two device stages, and the host's share of fsparse
        t["radix_sort_device_ms"] = device_ms(
            lambda: radix_sort_pair(rows, cols, M=siz, N=siz), cpm)
        t["parts34_device_ms"] = device_ms(
            lambda: pattern_from_perm(rows, cols, pat.perm, M=siz, N=siz,
                                      nzmax=pat.nzmax), cpm)
        host_reps = REPS if L < 10**7 else 5
        t["fsparse_ms"] = host_ms(lambda: fsparse(ii, jj, ss, (siz, siz)),
                                  host_reps)
        t["host_expand_coo_ms"] = host_ms(
            lambda: coo_from_matlab(*expand_indices(ii, jj, ss), (siz, siz)),
            host_reps)
        key64 = cols.long() * (siz + 1) + rows.long()
        t["sort_key64_stable_ms"] = device_ms(
            lambda: torch.sort(key64, stable=True), cpm)
        # the second path: the counting-sort plan, the unfused fill, sparse2
        for what, fn in (("plan_pallas",
                          lambda: plan_coo(coo, method="pallas")),
                         ("fill_pallas", lambda: fill_pallas(pat, v))):
            t[f"{what}_ms"] = call_ms(fn)
            t[f"{what}_device_ms"] = device_ms(fn, cpm)
            t[f"{what}_device_idle_share"] = \
                1.0 - t[f"{what}_device_ms"] / t[f"{what}_ms"]
        t["sparse2_miss_ms"] = host_ms(
            lambda: (plan_cache_clear(), sparse2(ii, jj, ss, (siz, siz))),
            host_reps)
        t["sparse2_hit_ms"] = host_ms(lambda: sparse2(ii, jj, ss, (siz, siz)),
                                      host_reps)
        plan_cache_clear()
        # what every lookup pays before the LRU: the key over the 8L
        # bytes of host indices, built and hashed
        r_h, c_h, _, _ = host_triplets(*expand_indices(ii, jj, ss),
                                       (siz, siz))
        t["sparse2_key_ms"] = host_ms(lambda: hash(_cache_key(
            r_h, c_h, (siz, siz), None, "radix", dev, ("sum", None, 1))),
            host_reps)
        del r_h, c_h
        # a representative digit pass: the second one, whose payload is
        # the first pass's permutation (every later pass looks alike)
        p0, p1 = passes[0], passes[1]
        kw0 = dict(shift=p0.shift, bits=p0.bits, nbins=p0.nbins)
        perm0 = place_k(rows, digit_bases(hist_k(rows, **kw0)), None, **kw0)
        keys = (cols if p1.src_col else rows)[perm0]
        kw = dict(shift=p1.shift, bits=p1.bits, nbins=p1.nbins)
        base = digit_bases(hist_k(keys, **kw))
        hist_bytes = 4 * p1.nbins * -(-L // TILE)
        fill_in = (v, pat.perm, pat.slot)
        nz = dict(num_segments=pat.nzmax)
        # B11/B12 on the counting sort's first pass (rows, M + 1 bins);
        # B4/B5 on the fill's streams
        cnt = dict(nbins=siz + 1, block_b=default_block_b(siz + 1))
        table_bytes = 4 * cnt["nbins"] * -(-L // cnt["block_b"])
        offsets, _ = block_offsets(rows, **cnt)
        flat = (torch.arange(L, device=dev) // cnt["block_b"]) \
            * cnt["nbins"] + rows.long()
        keep = pat.slot < pat.nzmax
        vp = v[pat.perm]
        x = torch.where(keep, vp, 0)
        seg = torch.where(keep, pat.slot, pat.nzmax).long()
        fns = {
            "B1": (lambda: hist_k(keys, **kw),
                   lambda: digit_block_histogram_ref(keys, tile=TILE, **kw),
                   None, 4 * L + hist_bytes, 3 * L),
            "B2": (lambda: place_k(keys, base, perm0, **kw),
                   lambda: digit_placement_ref(keys, base, perm0, tile=TILE,
                                               **kw),
                   None, 12 * L + hist_bytes, 4 * L),
            "B3": (lambda: fill_k(*fill_in, **nz),
                   lambda: gather_segment_sum_ref(*fill_in, **nz),
                   lambda: torch.zeros(pat.nzmax, device=dev).index_add_(
                       0, pat.slot, v[pat.perm]),
                   4 * L + 8 * L + 4 * pat.nzmax, L),
            "B4": (lambda: minmax_k(*fill_in, op="max", **nz),
                   lambda: gather_segment_minmax_ref(*fill_in, op="max", **nz),
                   lambda: torch.full((pat.nzmax + 1,), float("-inf"),
                                      device=dev).scatter_reduce_(
                       0, seg, vp, "amax", include_self=False),
                   4 * L + 8 * L + 4 * pat.nzmax, L),
            "B5": (lambda: scan_k(x), lambda: blocked_cumsum_ref(x),
                   lambda: torch.cumsum(x, 0), 8 * L, L),
            "B11": (lambda: cplace_k(rows, offsets, **cnt),
                    lambda: placement_ref(rows, offsets, **cnt),
                    lambda: torch.sort(rows, stable=True),
                    8 * L + table_bytes, 2 * L),
            "B12": (lambda: bhist_k(rows, **cnt),
                    lambda: block_histogram_ref(rows, **cnt),
                    lambda: torch.bincount(flat, minlength=table_bytes // 4),
                    4 * L + table_bytes, L),
        }
        rows_k = {}
        for k, (kern, plain, lib, nbytes, nops) in fns.items():
            r = {"ms": device_ms(kern, cpm), "call_ms": call_ms(kern),
                 "plain_ms": device_ms(plain, cpm),
                 "library_ms": None if lib is None else device_ms(lib, cpm),
                 "bytes": nbytes, "ops": nops}
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, nops)
            r["GBps"] = nbytes / r["ms"] / 1e6
            r["share_of_3.35TBps"] = r["GBps"] / (HBM_BYTES_PER_S / 1e9)
            rows_k[k] = r
        t["kernels"] = rows_k
        t["card"] = smi_line
        emit(t)
        per_kernel[name] = rows_k
        del coo, rows, cols, pat, v, key64, perm0, keys, base, fill_in, fns
        del offsets, flat, keep, vp, x, seg
        torch.cuda.empty_cache()

    big = per_kernel["2x20"]
    meta = {
        "B1": ("digit_block_histogram", "src/repro_torch/csrc/radix_sort.cu",
               "src/repro/kernels/radix_sort/radix_sort.py:123", 0.0),
        "B2": ("digit_placement", "src/repro_torch/csrc/radix_sort.cu",
               "src/repro/kernels/radix_sort/radix_sort.py:160", 0.0),
        "B3": ("gather_segment_sum", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:263", b3_err),
        "B4": ("gather_segment_minmax", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:133", 0.0),
        "B5": ("blocked_cumsum", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:65", b5_err),
        "B11": ("placement", "src/repro_torch/csrc/counting_sort.cu",
                "src/repro/kernels/counting_sort/counting_sort.py:67", 0.0),
        "B12": ("block_histogram", "src/repro_torch/csrc/hist.cu",
                "src/repro/kernels/hist/hist.py:39", 0.0),
    }
    # launches: B1-B3 on the main path (phase 4), the rest on theirs (4b)
    path_launches = {**launches2, **launches}
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[k], "max_abs_err": err,
         "ms": big[k]["ms"], "call_ms": big[k]["call_ms"],
         "plain_ms": big[k]["plain_ms"],
         "bound_ms": big[k]["bound_ms"], "bound_by": big[k]["bound_by"],
         "library_ms": big[k]["library_ms"]}
        for k, (n, src, rep, err) in meta.items()
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
