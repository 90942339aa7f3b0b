#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. device: the card's name and count, and its power limit from
   nvidia-smi; no CUDA device is a failure.
2. build: compiles every kernel of the four paths from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together),
   and the timing probes of ``segment_sum_probe.cu``, ``merge_probe.cu``
   and ``spmv_sym_probe.cu``, and prints each kernel's ``-Xptxas -v``
   report.
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on the streams its path gives it at L = 2.5e6 and 5e7: B1
   digit histogram and B2 stable digit placement on every pass of the
   radix chain (``radix_chain``: B2 with the words it carries), B12
   block histogram and B11 counting-sort placement bit for bit; B3' fused sum and B5 prefix
   sum bit for bit on integer-valued data and within their stated
   tolerances on random float32/float64 (B5 on zero-mean and on
   same-sign data, and bit for bit from call to call; B11 also on a
   handed-over table); B4 fused min/max bit for
   bit, NaN included.  The third path's kernels (B6 product fill, B8 ELL
   SpMV, B9 symmetric streams, B10 BSR tiles) are held against their
   plain versions right after phase 4c, on the streams it gave them:
   bit for bit on integer-valued data (B6 with a NaN too), within
   ``c * eps * sum|terms|`` on random float32 for c terms an output.
   B9 also on the streams that cross its tiles (``sym_stream``: the
   arrow matrix, with a column of 2^20 entries; a column whose first
   slot is a tile's last item; runs of empty columns with sentinel rows
   and a padded tail), float32 and float64: ``up`` and ``ct`` bit for
   bit on integer-valued data, ``up`` bit for bit and ``ct`` bit for bit
   from call to call on random data and there within ``C_SEG * eps *
   sum|terms|`` of each column's exact sum; each variant of its timing
   probe bit for bit on integer-valued data.
3c. B3' and B4 on runs that cross their tiles: L = 5e7 positions in
   runs of 2^20 (``run_lengths``: each after short runs, so they start
   mid-tile) and in runs of random length 1..10^4, under a random
   permutation, with ``num_segments`` at nnz and cut mid-stream: B3' bit
   for bit on integer-valued data, bit for bit from call to call and
   within ``C_SEG * eps * sum|terms|`` of each slot's exact sum
   (``exact_segment_sums``) on random float32 and float64; B4 bit for
   bit, NaN included.
3d. B6 on product runs that cross its tiles (``product_stream``: one
   run of 2^20 products, runs of random length 1..10^4, a run that
   starts at a tile's last position, a tile of only dropped slots, sa
   and sb random into operands of 2^20 values; and ``B' B`` of the arrow
   matrix, ``arrow_gram``: one run of 2^20, 1.68e7 products), float32
   and float64: bit for bit on integer-valued data with and without a
   NaN, bit for bit from call to call and within ``C_SEG * eps *
   sum|terms|`` of each slot's exact sum on random data, one launch a
   call; each variant of its timing probe bit for bit on integer-valued
   data.
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
4c. third path, the FEM workload of ``examples/fem_poisson.py`` and
   ``examples/fem_multigrid.py`` at 10^6 degrees of freedom: the P1
   stiffness matrix of a 999 x 999-cell mesh with Dirichlet identity
   rows, planned and filled on the card and held bit for bit against
   the oracle; A @ x four ways (CSC; ``kernels.spmv`` on ELL, B8;
   SymCSC, B9; 2 x 2 BSR, B10), each within ``8 eps sum_j |a_ij x_j|``
   of the CSC result per row; CG on the B8 and the B9 operator to the
   example's error bound against sin(pi x) sin(pi y), and on a seeded
   random right-hand side within ``CG_RTOL`` of the same iterations in
   float64 on the host (relative residuals); the Galerkin
   product ``P' A P`` with a bilinear prolongation (10^6 x 250,000)
   through two cached product plans and B6, its structure bit for bit
   against a numpy expansion put through the oracle and its values
   within ``8 eps (|P'| |A| |P|)`` of scipy's float64 product slot by
   slot; a refill for ``2 A`` that launches one fill and two B6 and no
   plan kernel.  Counters are set to 0 before this phase and must rise
   by exactly the expected launches.
4d. fourth path, dynamic patterns and symmetric planning, on phase 4's
   sets and phase 4c's FEM stream: ``SparsePattern.update`` of a base
   (the first L - Ld triplets, planned with nzmax = L) by the last Ld,
   at 1% and 10% of L, bit for bit against the plan of the whole set,
   launching exactly the delta's radix passes and one B7 (an empty
   update launches nothing and returns the same plan); an edge flip of
   1% of the FEM mesh's cells (``edge_flip``) through
   ``sparse2_update`` (the drop path), bit for bit against ``fsparse``
   of the flipped stream and the oracle, then ``sparse2`` of that
   stream hitting the moved cache entry with one fill and no plan
   kernel; ``pattern_symmetric`` true on A and on the flipped plan with
   two B7 launches each, false with one mirror removed;
   ``fsparse(..., format="symcsc")`` and ``format="bsr", block=2``
   equal to phase 4c's conversions of A; ``detect_block`` of the P1
   stream 1.  Counters (all twelve) are set to 0 before this phase and
   must rise by exactly the expected launches.  Then B7 against its
   plain version and ``torch.searchsorted``, bit for bit, on both call
   sites' streams, both sides, on edge cases and on ``merge_streams``
   (random queries, ties and sentinels at the narrowed ranges' edges,
   queries below and above every target, n = 2^k +- 1), each variant of
   its timing probe too.  Then complex values
   (``complex_checks``): fills, SpMVs and a refill on the card, where
   the float kernels take them one real part at a time, against the
   CPU's plain versions, each part within the kernel's tolerance.
4e. the policy and analysis layers (``repro_torch.sparse.tuning`` and
   ``.analysis``): every family resolves to its priors on ``cuda`` and
   each build-time prior equals what its library exports; the resource
   report (registers, spills, shared bytes and blocks an SM of every
   kernel instance, read from each library) against its declared
   columns, and ``--prior-only`` consuming every row of it; the
   ``--measure`` sweep in-process (set 1 at 2.5e6 for the sorts and B7,
   the 5e7 set for ``plan``, phase 4c's FEM SymCSC for B9, whose
   cut-offs it straddles; device ms per candidate, one candidate per
   distinct call-site decision, each candidate's output held against
   the prior's: bit for bit, B9 within 16 eps; no plain method is a
   candidate on the card), its table saved and loaded through
   ``REPRO_TUNING_CACHE_DIR`` in a child process
   (``--loaded-table-check``) that checks each recorded entry steers its
   call site to the sweep's winner and runs ``fsparse`` on sets 1-3 bit
   for bit against the oracle; the host cost of one
   memoised ``resolve_policy`` and the plan and fill call ms at sets
   1-3 beside those before the policy layer;
   ``validate_pattern``/``validate_matrix`` on the plans and formats of
   phases 4-4d, a ``SymPattern``, and one ``update`` under
   ``REPRO_VALIDATE=1``; ``audit_default_paths`` on CUDA tensors.  All twelve counters are set to 0 before the sweep and
   must be above 0 after the audit; the phase must end within 90 s.
   The rest of the run resolves from the priors again.
5. times, with CUDA events: the device time of the plan (radix and
   counting sort), the fill (fused and unfused), each kernel, its plain
   version and a PyTorch yardstick (calls back to back behind a device
   sleep that hides the host's dispatch; B11 as the counting sort calls
   it, on a handed-over table, with the copy a standalone call makes
   timed apart; B1 and B2 on the radix chain's second pass, B2 with
   the words it carries there; B1 against ``torch.bincount`` of (tile,
   digit), B2 against a stable ``torch.sort`` of the digit; B4 against
   ``scatter_reduce_`` with the gather ``v[perm]`` inside the timed
   call; B3' and B4 beside the gather floor, ``gather_floor``: their
   loads without the reduction; the radix sort against a stable
   ``torch.sort`` of the int64 key ``col * (M + 1) + row``), B3' and B4
   on one run of 2^20 duplicates and on L = 5e7 in runs of 2^20, each
   against the same positions with every slot once (``*_longrun*``,
   ``*_runs1*``), and the time of one call as a
   caller pays it (device plus dispatch gaps; the ratio of the two is
   the device's idle share); host-clock medians of the whole
   ``fsparse`` call, of a ``sparse2`` miss and hit, and of building
   and hashing the ``sparse2`` key.  For the third path, at its size:
   B6, B8, B9 and B10 as above (yardsticks ``index_add_`` with the two
   gathers and the product inside the timed call, cuSPARSE CSR and BSR
   ``torch.mv``); B6 on both products of the Galerkin operator (``P'
   A`` and ``(P' A) P``, each with its own bytes and bound) beside the
   design it replaced, its two-gather floor (``gather2_floor``) and each
   variant of its timing probe (``PRODUCT_VARIANTS``: tile depths and
   register bounds, the sweep), and on one run of 2^20 products against
   2^20 runs of one; the plan and
   fill of A, each SpMV, one CG iteration, ``product_plan`` split into
   the host expansion and the device plan, and the B6 refills.  For
   the fourth path: per set and delta share the update against a
   re-plan of the whole set, the update split into delta sort, B7,
   materialisation and Parts 3-4, ``sparse2_update`` of the edge flip
   on the host clock, ``plan_symmetric`` against ``plan`` of A and the
   ``SymPattern`` refill against the full fill, and B7 at both call
   sites (yardstick ``torch.searchsorted`` with the int64 packing of
   both streams it needs inside the timed call, and each of the two
   apart; bound: the queries, the offsets and the targets the ladder
   reaches), beside the design it replaced and the other shapes of
   ``merge_probe``; B9 on the FEM stream, the arrow matrix and short
   columns of as many slots, beside the design it replaced (with its
   zeroing of ``up``) and the other shapes of ``sym_probe``.

The last lines are the ``{"kernels": [...]}`` summary, the nvidia-smi
line and ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.core.oracle import matlab_sparse_oracle  # noqa: E402
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
#: |x| (the kernel's first-order worst case is about 31 eps, see
#: csrc/segment_sum.cu); a difference of two prefixes (fill_pallas)
#: within twice that
C_SCAN = 64
#: the third path: fem_poisson's P1 mesh with 999 x 999 cells, 10^6
#: vertices; ELL width = the P1 stencil's row length; CG iterations
FEM_N = 999
FEM_K = 7
CG_ITERS = 50
#: CG on a random right-hand side: the relative residual after CG_ITERS
#: iterations on the card (float32) may differ from the same iterations
#: in float64 on the host by CG_RTOL of it, plus CG_ATOL (float32's
#: floor, for a system that converges in fewer iterations)
CG_RTOL, CG_ATOL = 1e-3, 1e-5
#: B3''s tolerance: each slot within C_SEG * eps * sum|terms| of the
#: exact sum (the kernel's first-order worst case is (K + 12) eps / 2 =
#: 10 eps at K = 8, see csrc/segment_sum.cu)
C_SEG = 16
#: the long run of B3''s and B4's run-length checks and of
#: ``B3_longrun_ms``
LONG_RUN = 1 << 20
ACCUM_SETS = ("1", "3")
ACCUM_MODES = ("min", "max", "mean", "first", "last")
#: phase 4d: the appended delta as a share of L (``benchmarks/
#: bench_update.py``'s split: the base is the first L - Ld triplets), and
#: the share of the FEM mesh's cells whose diagonal the edge flip turns
UPDATE_FRACS = (0.01, 0.1)
FLIP_FRAC = 0.01
#: the P1 matrix of a right triangle written (leg end, right-angle
#: vertex, leg end), the order of the edge flip's new triangles
K_FLIP = 0.5 * np.array([[1, -1, 0], [-1, 2, -1], [0, -1, 1]])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


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


def top_kernels(fn, k: int = 4) -> list:
    """The ``k`` CUDA kernels with the most device time in one call of
    ``fn()`` (``torch.profiler``), as ``[name, ms]`` pairs."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return [[name[:60], ms] for name, ms in
            sorted(rows, key=lambda r: -r[1])[:k]]


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


def _cut(lengths: np.ndarray, L: int) -> np.ndarray:
    """The run lengths (int64) up to position L, the last run cut there."""
    ends = np.cumsum(lengths)
    k = int(np.searchsorted(ends, L))  # the run that reaches L
    lengths = lengths[:k + 1].astype(np.int64)
    lengths[k] -= ends[k] - L
    return lengths


def run_lengths(L: int, rng, kind: str,
                long_run: int = LONG_RUN) -> np.ndarray:
    """Run lengths of a sorted slot stream of L positions.

    ``"long"``: runs of ``long_run``, each after a stretch of about 2,000
    positions in short runs (1-3), so the long runs start mid-tile;
    ``"random"``: lengths uniform in 1..10^4.
    """
    if kind == "random":
        return _cut(rng.integers(1, 10**4 + 1, L // 2500 + 2), L)
    n = L // long_run + 1
    short = rng.integers(1, 4, (n, 1000))
    return _cut(np.concatenate([short, np.full((n, 1), long_run)],
                               1).reshape(-1), L)


def ragged_slots(kind: str, tile: int, rng,
                 long_run: int = LONG_RUN) -> np.ndarray:
    """int32 slot streams that break a design of tiles of ``tile``
    positions; the kept slots count 0, 1, ... in stream order.

    ``"one_run"``: one run of ``long_run`` between about 2,000 positions
    of short runs on either side; ``"random"``: 2^21 positions in runs of
    1..10^4; ``"tile_edge"``: single slots up to a tile's last position,
    where a run of 2 tiles + 1 starts (it ends at the last position of
    the tile after next), a single at the following tile's first
    position, then runs of 1..7; ``"dropped_tile"``: runs of 1..7, then
    dropped slots (-1, then 2^30) from 3 positions before a tile to 5
    after it, then runs of 1..7 around a run of 3 tiles.
    """
    if kind == "one_run":
        lengths = run_lengths(long_run + 4000, rng, "long", long_run)
    elif kind == "random":
        lengths = run_lengths(1 << 21, rng, "random")
    elif kind == "tile_edge":
        lengths = np.concatenate([np.ones(tile - 1, np.int64),
                                  [2 * tile + 1, 1],
                                  rng.integers(1, 8, tile // 2)])
    else:
        before = _cut(rng.integers(1, 8, 2 * tile), 4 * tile - 3)
        after = np.concatenate([rng.integers(1, 8, tile // 4), [3 * tile],
                                rng.integers(1, 8, tile // 4)])
        dropped = np.full(tile + 8, 2**30, np.int64)
        dropped[:tile // 2] = -1
        return np.concatenate([
            np.repeat(np.arange(len(before)), before), dropped,
            np.repeat(np.arange(len(after)) + len(before), after)
        ]).astype(np.int32)
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


def merge_streams(kind: str, rng, block: int):
    """``(q_rows, q_cols, t_rows, t_cols, M)`` int32 numpy streams for B7,
    whose blocks of ``block`` queries narrow their search together; the
    targets are (col, row)-sorted, ``M`` is the sentinel row.

    ``"sorted_few"``: 3,001 sorted queries into 2^23 + 3 targets (Lq <<
    n, as the update's delta); ``"sorted_all"``: Lq = n = 2^17 + 3,
    sorted; ``"random"``: 4 blocks and 7 unsorted queries into 2^13
    targets, so a block's range is all of n; ``"sparse_random"``: 3,001
    of them into 2^23 + 3;
    ``"edges"``: each block's least and greatest key equal to targets of
    a long run of one key, rows M (the sentinel) among them, and queries
    on the ties at the splitters of the narrowed range; ``"below"`` and
    ``"above"``: every query under or over every target;
    ``"n_<n>"``: n targets (1, 2^k - 1, 2^k, 2^k + 1) and a ragged Lq
    (half a block and 37).
    """
    M, N = 997, 1 << 12

    def targets(n):
        tr = rng.integers(0, M + 1, n)
        tc = rng.integers(0, N, n)
        o = np.lexsort((tr, tc))
        return tr[o], tc[o]

    def queries(Lq):
        return rng.integers(0, M + 1, Lq), rng.integers(0, N, Lq)

    def sort(qr, qc):
        o = np.lexsort((qr, qc))
        return qr[o], qc[o]

    if kind == "sorted_few":
        tr, tc = targets((1 << 23) + 3)
        qr, qc = sort(*queries(3001))
    elif kind == "sorted_all":
        tr, tc = targets((1 << 17) + 3)
        qr, qc = sort(*queries((1 << 17) + 3))
    elif kind == "random":
        tr, tc = targets(1 << 13)
        qr, qc = queries(4 * block + 7)
    elif kind == "sparse_random":
        tr, tc = targets((1 << 23) + 3)
        qr, qc = queries(3001)
    elif kind == "edges":
        tr, tc = targets(1 << 13)
        # a run of 5,000 equal keys (col 7, row M) and rows M around it
        tc = np.concatenate([tc, np.full(5000, 7)])
        tr = np.concatenate([tr, np.full(5000, M)])
        o = np.lexsort((tr, tc))
        tr, tc = tr[o], tc[o]
        k = int(np.flatnonzero((tc == 7) & (tr == M))[0])
        # every block: its first and last query on targets, the rest on
        # ties with targets at evenly spaced positions
        pick = np.sort(rng.integers(0, tr.size, 9 * block + 5))
        pick[::block] = k
        pick[block - 1::block] = k + 4999
        qr, qc = tr[pick], tc[pick]
    elif kind in ("below", "above"):
        tr, tc = targets(1 << 12)
        tc = tc + 10
        qr, qc = queries(2 * block + 1)
        qc = qc % 10 if kind == "below" else qc + N + 10
    else:
        n = int(kind.split("_")[1])
        tr, tc = targets(n)
        qr, qc = queries(block // 2 + 37)
        k = min(n, qr.size) // 2
        qr[:k], qc[:k] = tr[:k], tc[:k]
    return tuple(np.asarray(a, np.int32) for a in (qr, qc, tr, tc)) + (M,)


#: the kinds of ``merge_streams`` (B7's sparse shape takes sorted_few and
#: sparse_random, its ladder n_4095 .. n_4097, its dense shape the others)
MERGE_KINDS = ("sorted_few", "sorted_all", "random", "sparse_random",
               "edges", "below", "above", "n_1", "n_4095", "n_4096",
               "n_4097")
#: B9's arrow matrix: one dense column of ARROW_DENSE strict-upper entries
ARROW_DENSE = 1 << 20
#: the slots of ``sym_lengths``' sweep streams, about the FEM matrix's
SWEEP_SLOTS = 3_000_000


def sym_lengths(kind: str, tile: int, rng, dense: int = ARROW_DENSE):
    """Column lengths of SymCSC strict-upper streams that break a design of
    tiles of ``tile`` merge items (each column end and each slot one).

    ``"arrow"``: dense + 1 columns, column c < dense with min(c, 3)
    entries (as the FEM matrix's few), the last with ``dense`` (every row
    above it: the row and column of a bordered system's Lagrange
    multiplier); ``"short"``: min(c, 3) entries a column and as many
    slots as ``"arrow"`` (its yardstick); ``"tile_edge"``: a column of
    2 tiles + 1 entries whose first slot is the last item of the fourth
    tile, a column of 1 after it and short ones around;
    ``"empty_runs"``: runs of 1 to 3 tiles of empty columns between
    stretches of short ones; ``"width_<w>"``: min(c, w) entries a column
    and ``"mixed_<w>"``: min(c, 3) with every 64th column of w (or c),
    each about ``SWEEP_SLOTS`` slots (the FEM matrix's 2.98e6), for
    timing the shapes of B9 against the longest column.
    """
    if kind == "arrow":
        return np.concatenate([np.minimum(np.arange(dense), 3), [dense]])
    if kind == "short":
        n = dense + 1 + dense // 3
        return np.minimum(np.arange(n), 3)
    if kind == "tile_edge":
        x = 3 * tile
        # columns 1 .. s hold one entry: the long column x starts at item
        # x + s = 3 tile - 1 + tile k
        s = 4 * tile - 1 - x
        return np.concatenate([[0], np.ones(s, np.int64),
                               np.zeros(x - 1 - s, np.int64),
                               [2 * tile + 1, 1],
                               np.minimum(rng.integers(0, 4, tile), 3)])
    if kind.startswith(("width_", "mixed_")):
        w = int(kind.split("_")[1])
        if kind.startswith("width_"):
            return np.minimum(np.arange(SWEEP_SLOTS // w), w)
        n = int(SWEEP_SLOTS // (3 + w / 64))
        lengths = np.minimum(np.arange(n), 3)
        lengths[63::64] = w
        return np.minimum(lengths, np.arange(n))
    runs = []
    for _ in range(8):
        runs.append(np.zeros(int(rng.integers(tile, 3 * tile)), np.int64))
        runs.append(rng.integers(1, 4, int(rng.integers(1, tile))))
    lengths = np.concatenate([[0]] + runs)
    return np.minimum(lengths, np.arange(lengths.size))


def sym_stream(kind: str, tile: int, rng, dense: int = ARROW_DENSE):
    """``(rows, indptr, M)``, int32 numpy, of ``sym_lengths(kind)``: column
    c of length l holds rows c - l .. c - 1.  ``"empty_runs"`` also has a
    row M (the sentinel) at every 64th slot and a padded tail of 37 slots
    of row M past indptr[M]."""
    lengths = sym_lengths(kind, tile, rng, dense)
    M = lengths.size
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = np.repeat(np.arange(M), lengths)
    rows = col - lengths[col] + (np.arange(col.size) - indptr[col])
    if kind == "empty_runs":
        rows[::64] = M
        rows = np.concatenate([rows, np.full(37, M)])
    return rows.astype(np.int32), indptr, M


PRODUCT_KINDS = ("one_run", "random", "tile_edge", "dropped_tile")
#: the host expansion of B' B for the arrow matrix is checked against this
#: before it is planned (B6's run check and times skip it above)
ARROW_GRAM_MAX_FLOPS = 2 * 10**7


def product_stream(kind: str, tile: int, rng, operands: int,
                   long_run: int = LONG_RUN):
    """``(sa, sb, slot)`` int32 numpy streams of B6 that break a design of
    tiles of ``tile`` positions: ``ragged_slots(kind)`` with ``sa`` and
    ``sb`` uniform into two operand vectors of ``operands`` values."""
    slot = ragged_slots(kind, tile, rng, long_run)
    sa, sb = (rng.integers(0, operands, slot.size).astype(np.int32)
              for _ in range(2))
    return sa, sb, slot


def arrow_gram_flops(dense: int = ARROW_DENSE) -> int:
    """The products of ``B' B`` for the arrow matrix ``B`` of
    ``sym_stream("arrow")``: the sum over its rows of their counts
    squared."""
    rows, _, M = sym_stream("arrow", 1, None, dense)
    return int(np.sum(np.bincount(rows, minlength=M).astype(np.int64) ** 2))


def arrow_gram(dev, rng, dense: int = ARROW_DENSE):
    """The product plan of ``B' B`` on ``dev``, ``B`` the arrow matrix of
    ``sym_stream("arrow")`` (random values): its slot for entry (M-1,
    M-1) is one run of ``dense`` products, the dense column's dot product
    with itself.  Returns ``(plan, B', B)``."""
    from repro_torch.core.csc import CSC
    from repro_torch.sparse import convert, ops, product_plan

    rows, indptr, M = sym_stream("arrow", 1, rng, dense)
    nz = rows.size
    B = CSC(data=torch.from_numpy(rng.standard_normal(nz).astype(
        np.float32)).to(dev), indices=torch.from_numpy(rows).to(dev),
        indptr=torch.from_numpy(indptr).to(dev),
        nnz=torch.tensor(nz, dtype=torch.int32, device=dev), shape=(M, M))
    Bt = convert(ops.transpose(B), "csc")
    return product_plan(Bt, B), Bt, B


def product_err_over_eps(got: torch.Tensor, va, vb, sa, sb, slot,
                         eps: float) -> float:
    """The largest |got - exact| / (eps sum|terms|) over the slots of a B6
    result: each slot's rounded products va[sa] * vb[sb], summed exactly
    (``exact_segment_sums``)."""
    terms = va[sa.long()] * vb[sb.long()]
    want, mag = exact_segment_sums(terms, slot, got.numel())
    err = np.abs(got.double().cpu().numpy() - want)
    return float((err / np.maximum(eps * mag, 1e-300)).max(initial=0.0))


def sym_err_over_eps(ct: torch.Tensor, rows, data, indptr, x,
                     eps: float) -> float:
    """The largest |ct - exact| / (eps sum|terms|) over the columns of a B9
    result: each column's terms a_s * x[r_s] as the kernel rounds them,
    summed exactly (``exact_segment_sums``)."""
    M, nz = x.shape[0], data.shape[0]
    s = torch.arange(nz, device=data.device)
    col = torch.searchsorted(indptr[1:].long(), s, right=True)
    valid = (col < M) & (rows >= 0) & (rows < M)
    lo = torch.where(valid, data * x[torch.where(valid, rows, 0).long()], 0)
    want, mag = exact_segment_sums(lo, torch.where(valid, col, -1), M)
    err = np.abs(ct.double().cpu().numpy() - want)
    return float((err / np.maximum(eps * mag, 1e-300)).max(initial=0.0))


def slot_stream(slot: np.ndarray, dev, seed: int):
    """``(perm, slot)`` int32 streams on ``dev`` as a plan gives them: the
    slot stream and a random permutation of its positions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(slot.shape[0], generator=gen, device=dev)
    return perm.to(torch.int32), torch.from_numpy(slot).to(dev)


def run_stream(lengths: np.ndarray, dev, seed: int):
    """:func:`slot_stream` of slot s repeated ``lengths[s]`` times."""
    return slot_stream(np.repeat(np.arange(len(lengths), dtype=np.int32),
                                 lengths), dev, seed)


def exact_segment_sums(v: torch.Tensor, slot: torch.Tensor, n: int):
    """Each slot's sum of ``v`` over its kept positions (``0 <= slot <
    n``, each slot one run) and its sum of ``|v|``, float64 on the host.

    The sums are taken in extended precision (``np.longdouble``): chunks
    of at most 1,024 positions of a run, then the chunks of the run, so
    a total of m terms is within (1023 + m / 1024) u sum|terms| (u =
    2^-64 on x86-64) before it is rounded to float64: within eps64 of
    sum|terms| in all for m <= 2^20.
    """
    if np.finfo(np.longdouble).eps > 2.0**-60:
        raise RuntimeError("np.longdouble is no wider than float64 here")
    out, mag = np.zeros(n), np.zeros(n)
    x, s = v.double().cpu().numpy(), slot.cpu().numpy()
    kept = np.flatnonzero((s >= 0) & (s < n))
    if kept.size == 0:
        return out, mag
    x, s = x[kept], s[kept]
    pos = np.arange(x.size)
    start = np.ones(x.size, bool)
    start[1:] = s[1:] != s[:-1]
    run0 = np.maximum.accumulate(np.where(start, pos, 0))
    chunks = np.flatnonzero(start | ((pos - run0) % 1024 == 0))
    runs = np.flatnonzero(start)
    first = np.searchsorted(chunks, runs)  # each run's first chunk
    out[s[runs]] = np.add.reduceat(np.add.reduceat(
        x.astype(np.longdouble), chunks), first).astype(np.float64)
    mag[s[runs]] = np.add.reduceat(np.abs(x), runs)
    return out, mag


def seg_err_over_eps(got: torch.Tensor, vals: torch.Tensor,
                     perm: torch.Tensor, slot: torch.Tensor,
                     eps: float) -> float:
    """The largest |got - exact| / (eps sum|terms|) over the slots of a
    B3' result, the sums of ``vals[perm]`` (0 where a slot's terms are
    all 0 and got is exact)."""
    want, mag = exact_segment_sums(vals[perm.long()], slot, got.numel())
    err = np.abs(got.double().cpu().numpy() - want)
    return float((err / np.maximum(eps * mag, 1e-300)).max(initial=0.0))


_PROBE: dict = {}


def probe_fn(name: str):
    """A launcher of ``csrc/segment_sum_probe.cu``, for timing only (the
    gather floors, B3''s, B4's and B6's variants and the design they
    replaced)."""
    if name not in _PROBE:
        from repro_torch.kernels import common
        lib = common.load_library("segment_sum_probe")
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for key, fn in (("sum", "probe_segment_sum_f32_launch"),
                        ("max", "probe_segment_max_f32_launch")):
            _PROBE[key] = common.bind(lib, fn, [I, P, P, P, P, P, LL, LL, P])
        _PROBE["floor"] = common.bind(lib, "probe_gather_floor_f32_launch",
                                      [I, P, P, P, P, LL, LL, P])
        _PROBE["sum2"] = common.bind(lib, "probe_product_sum_f32_launch",
                                     [I, P, P, P, P, P, P, P, LL, LL, P])
        _PROBE["floor2"] = common.bind(
            lib, "probe_gather2_floor_f32_launch",
            [I, P, P, P, P, P, P, LL, LL, P])
    return _PROBE[name]


def probe_fill(variant: int, vals, perm, slot, n: int, op: str = "sum"):
    """B3' (``op="sum"``) or B4's max (``"max"``) on float32 by a variant
    of the probe: 0 the replaced design (one thread walks each run), 1
    K = 4, 2 as shipped, 3 K = 16, 4 the index streams through __ldg."""
    L = slot.numel()
    out = torch.zeros(n, dtype=torch.float32, device=vals.device)
    scratch = out if variant == 0 else torch.zeros(
        1 + 2 * -(-L // 1024), dtype=torch.int64, device=vals.device)
    rc = probe_fn(op)(variant, vals.data_ptr(), perm.data_ptr(),
                      slot.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                      L, n, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"probe {op} variant {variant}: CUDA error {rc}")
    return out


def gather_floor(vals, perm, slot, n: int, variant: int = 2):
    """The gather floor: ``y[j] = vals[perm[j]]`` where ``slot[j]`` is
    kept, with B3''s loads (variant 2) or at K = 16 (3); float32."""
    L = slot.numel()
    y = torch.empty(L, dtype=torch.float32, device=vals.device)
    rc = probe_fn("floor")(variant, vals.data_ptr(), perm.data_ptr(),
                           slot.data_ptr(), y.data_ptr(), L, n,
                           torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"gather floor variant {variant}: CUDA error {rc}")
    return y


#: B6's variants in ``csrc/segment_sum_probe.cu``: the replaced design
#: (one thread walks each run), the kernel as shipped, and its tile depth
#: K and least resident blocks an SM (unbounded: the compiler's choice),
#: or its index streams through __ldg
PRODUCT_VARIANTS = {"replaced": 0, "shipped": 1, "K4": 2, "K4_min8": 3,
                    "K8": 4, "K8_min5": 5, "K8_min4": 6, "K12": 7,
                    "K12_min4": 8, "K12_min3": 9, "ldg": 10, "K8_min6": 11,
                    "K12_min5": 12}


def product_probe(variant: int, va, vb, sa, sb, slot, n: int):
    """B6 on float32 by a variant of the probe (``PRODUCT_VARIANTS``)."""
    L = slot.numel()
    out = torch.zeros(n, dtype=torch.float32, device=va.device)
    scratch = torch.zeros(1 + 2 * -(-L // 1024), dtype=torch.int64,
                          device=va.device)
    rc = probe_fn("sum2")(variant, va.data_ptr(), vb.data_ptr(),
                          sa.data_ptr(), sb.data_ptr(), slot.data_ptr(),
                          out.data_ptr(), scratch.data_ptr(), L, n,
                          torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"B6 probe variant {variant}: CUDA error {rc}")
    return out


def gather2_floor(va, vb, sa, sb, slot, n: int, variant: int = 1):
    """The two-gather floor: ``y[j] = va[sa[j]] * vb[sb[j]]`` where
    ``slot[j]`` is kept, with B6's loads (variant 1), at K = 4 (2) or
    K = 12 (3); float32."""
    L = slot.numel()
    y = torch.empty(L, dtype=torch.float32, device=va.device)
    rc = probe_fn("floor2")(variant, va.data_ptr(), vb.data_ptr(),
                            sa.data_ptr(), sb.data_ptr(), slot.data_ptr(),
                            y.data_ptr(), L, n,
                            torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"two-gather floor variant {variant}: CUDA error {rc}")
    return y


def merge_probe(variant: int, qr, qc, tr, tc, side: str):
    """B7 by a variant of ``csrc/merge_probe.cu`` (``MERGE_VARIANTS``),
    for timing only: 0 the replaced design (one thread walks a query's
    whole ladder), 1 as shipped, the others other shapes of the kernel."""
    if "merge" not in _PROBE:
        from repro_torch.kernels import common
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        _PROBE["merge"] = common.bind(common.load_library("merge_probe"),
                                      "probe_merge_search_launch",
                                      [I, P, P, P, P, P, LL, I, I, P])
    out = torch.empty(qr.numel(), dtype=torch.int32, device=qr.device)
    rc = _PROBE["merge"](variant, qr.data_ptr(), qc.data_ptr(),
                         tr.data_ptr(), tc.data_ptr(), out.data_ptr(),
                         qr.numel(), tr.numel(), int(side == "right"),
                         torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"merge probe variant {variant}: CUDA error {rc}")
    return out


#: the variants of ``merge_probe`` and of ``sym_probe``, by name
MERGE_VARIANTS = {"replaced": 0, "shipped": 1, "sparse": 2, "dense": 3,
                  "ladder_tie": 4, "split": 5, "narrow_only": 6,
                  "dense_tie": 7, "sparse_q2": 8, "ladder": 9}
SYM_VARIANTS = {"replaced": 0, "tiles": 1, "tiles_K4": 2, "tiles_K12": 3,
                "tiles_lookback_only": 4, "groups": 5, "columns": 6}
#: B9's phases, as ``sym_phase_stamps`` reads them
SYM_PHASES = ("search", "load", "walk", "carry", "write")


def sym_probe(variant: int, rows, data, indptr, x):
    """B9 on float32 by a variant of ``csrc/spmv_sym_probe.cu``
    (``SYM_VARIANTS``), for timing only: 0 the replaced design (one thread
    a column; ``up`` zeroed first, as its wrapper did), 1 the merge-path
    tiles as shipped, 6 one thread a column as shipped, 5 the column
    groups, the others other shapes of the tiles."""
    if "sym" not in _PROBE:
        from repro_torch.kernels import common
        P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib = common.load_library("spmv_sym_probe")
        _PROBE["sym"] = common.bind(lib, "probe_sym_streams_f32_launch",
                                    [I, P, P, P, P, P, P, P, LL, LL, P])
        lib.probe_sym_tile.argtypes = [I]
        lib.probe_sym_tile.restype = LL
        _PROBE["sym_tile"] = lib.probe_sym_tile
    M, nz = x.numel(), data.numel()
    tile = _PROBE["sym_tile"](variant)
    up = (torch.zeros if variant == 0 else torch.empty)(
        nz, dtype=torch.float32, device=x.device)
    ct = torch.empty(M, dtype=torch.float32, device=x.device)
    # the tiles' ticket and descriptors (the others take none)
    scratch = torch.zeros(1 + 2 * -(-(M + nz) // tile), dtype=torch.int64,
                          device=x.device) if tile else None
    rc = _PROBE["sym"](variant, rows.data_ptr(), data.data_ptr(),
                       indptr.data_ptr(), x.data_ptr(), up.data_ptr(),
                       ct.data_ptr(), scratch.data_ptr() if tile else None,
                       M, nz, torch.cuda.current_stream().cuda_stream)
    require(rc == 0, f"sym probe variant {variant}: CUDA error {rc}")
    return up, ct


def sym_phase_stamps(rows, data, indptr, x) -> dict:
    """B9 as shipped on float32 with the probe's phase stamps: the mean
    device time of the ticket and of each phase of a tile
    (``SYM_PHASES``: the merge-path search, the loads, the walk, the
    carry with its look-back, the writes; thread 0's clock), a tile's
    mean lifetime, the kernel's span and the mean number of tiles in
    flight (lifetimes over span), in us."""
    if "sym_stamped" not in _PROBE:
        from repro_torch.kernels import common
        P, LL = ctypes.c_void_p, ctypes.c_longlong
        _PROBE["sym_stamped"] = common.bind(
            common.load_library("spmv_sym_probe"),
            "probe_sym_streams_stamped_f32_launch",
            [P, P, P, P, P, P, P, LL, LL, P, P])
    from repro_torch.kernels.spmv_sym.ref import SYM_TILE
    M, nz = x.numel(), data.numel()
    ntiles = -(-(M + nz) // SYM_TILE)
    stamps = torch.zeros(8 * ntiles, dtype=torch.int64, device=x.device)
    for _ in range(2):  # the second call is read
        up = torch.empty(nz, dtype=torch.float32, device=x.device)
        ct = torch.empty(M, dtype=torch.float32, device=x.device)
        scratch = torch.zeros(1 + 2 * ntiles, dtype=torch.int64,
                              device=x.device)
        rc = _PROBE["sym_stamped"](
            rows.data_ptr(), data.data_ptr(), indptr.data_ptr(),
            x.data_ptr(), up.data_ptr(), ct.data_ptr(), scratch.data_ptr(),
            M, nz, stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
        require(rc == 0, f"stamped sym probe: CUDA error {rc}")
    raw = stamps.view(ntiles, 8).double().cpu().numpy() / 1e3
    st = raw[:, :6]
    d = np.diff(st, axis=1)
    life = st[:, 5] - raw[:, 6]
    span = st[:, 5].max() - raw[:, 6].min()
    return {"ticket_us": float((st[:, 0] - raw[:, 6]).mean()),
            **{f"{k}_us": float(d[:, i].mean())
               for i, k in enumerate(SYM_PHASES)},
            "tile_us": float(life.mean()), "span_us": float(span),
            "tiles_in_flight": float(life.sum() / span), "tiles": ntiles}


def radix_chain(rows, cols, M: int, N: int, *, upto: int | None = None,
                check=None):
    """The radix chain of ``radix_sort_pair`` driven pass by pass on B1
    and B2, with the words each pass carries.

    ``check(i, pass, args)`` runs after pass ``i`` with ``args = (keys,
    hist, base, perm, carry, kw, out)``: the pass's inputs, B1's and
    B2's outputs.
    With ``upto``, stops before pass ``upto`` and returns its inputs
    ``(keys, base, perm, carry, kw)``; else returns the permutation.
    """
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ops import (carried_words,
                                                    digit_bases,
                                                    plan_digit_passes)

    passes = plan_digit_passes(M, N, rows.shape[0])
    perm = None
    for i, p in enumerate(passes):
        keys = cols if p.src_col else rows
        want = carried_words(passes, i)
        carry = tuple(w for w, k in zip((rows, cols), want) if k)
        kw = dict(shift=p.shift, bits=p.bits, nbins=p.nbins)
        hist = rs.digit_block_histogram(keys, **kw)
        base = digit_bases(hist)
        if i == upto:
            return keys, base, perm, carry, kw
        out = rs.digit_placement(keys, base, perm, carry=carry, **kw)
        if check is not None:
            check(i, p, (keys, hist, base, perm, carry, kw, out))
        perm, moved = out if carry else (out, ())
        moved = iter(moved)
        rows = next(moved) if want[0] else rows
        cols = next(moved) if want[1] else cols
    return perm


# -- the third path's data: fem_poisson's P1 mesh and a prolongation --------
def p1_triplets(n: int):
    """Stiffness triplets of ``examples/fem_poisson.py``'s structured P1
    mesh (n x n cells, two right triangles each, nine triplets per
    triangle), vectorised, in the example's order.  Zero-offset int32
    rows and cols, float64 values, and the vertex count (n + 1)^2."""
    ix, iy = np.meshgrid(np.arange(n, dtype=np.int32),
                         np.arange(n, dtype=np.int32), indexing="ij")
    v = lambda x, y: y * (n + 1) + x  # noqa: E731 (the example's vid)
    tri = np.stack([np.stack([v(ix, iy), v(ix + 1, iy), v(ix, iy + 1)], -1),
                    np.stack([v(ix + 1, iy + 1), v(ix, iy + 1),
                              v(ix + 1, iy)], -1)], -2)  # [n, n, 2, 3]
    K = 0.5 * np.array([[2, -1, -1], [-1, 1, 0], [-1, 0, 1]])
    full = (n, n, 2, 3, 3)
    rows = np.broadcast_to(tri[..., :, None], full).ravel()
    cols = np.broadcast_to(tri[..., None, :], full).ravel()
    vals = np.broadcast_to(K, full).ravel()
    return rows, cols, vals, (n + 1) * (n + 1)


def fem_system(n: int):
    """``fem_poisson.py``'s Dirichlet system: boundary rows and columns
    dropped and replaced by identity rows; the load of u = sin(pi x)
    sin(pi y).  Returns zero-offset (rows, cols, float32 vals), the
    vertex count, the float32 right-hand side and u_exact."""
    rows, cols, vals, nv = p1_triplets(n)
    xs, ys = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1))
    boundary = ((xs == 0) | (xs == 1) | (ys == 0) | (ys == 1)).ravel()
    keep = ~(boundary[rows] | boundary[cols])
    bidx = np.nonzero(boundary)[0].astype(np.int32)
    rows_f = np.concatenate([rows[keep], bidx])
    cols_f = np.concatenate([cols[keep], bidx])
    vals_f = np.concatenate([vals[keep], np.ones(bidx.size)])
    h = 1.0 / n
    u_exact = (np.sin(np.pi * xs) * np.sin(np.pi * ys)).ravel()
    f = 2 * np.pi ** 2 * u_exact * h * h
    f[boundary] = 0.0
    return (rows_f, cols_f, vals_f.astype(np.float32), nv,
            f.astype(np.float32), u_exact)


def bilinear_prolongation(n: int):
    """P: fine vertices (n + 1)^2 -> coarse vertices at even (ix, iy),
    (n // 2 + 1)^2 of them.  Each fine vertex interpolates bilinearly
    from the coarse vertices around it (weights 1, 1/2, 1/4); a parent
    past the grid's edge is left out.  Zero-offset triplets (rows, cols,
    float32 vals) and the shape."""
    nf, nc = n + 1, n // 2 + 1
    i = np.arange(nf)
    par = np.stack([i // 2, i // 2 + 1], 1)                   # [nf, 2]
    w = np.where((i % 2 == 0)[:, None], [[1.0, 0.0]], [[0.5, 0.5]])
    ok = (w > 0) & (par < nc)
    # [iy, ix, y parent, x parent]
    rows = np.broadcast_to((i[:, None] * nf + i[None, :])[:, :, None, None],
                           (nf, nf, 2, 2))
    cols = par[:, None, :, None] * nc + par[None, :, None, :]
    vals = w[:, None, :, None] * w[None, :, None, :]
    keep = ok[:, None, :, None] & ok[None, :, None, :]
    return (rows[keep].astype(np.int32), cols[keep].astype(np.int32),
            vals[keep].astype(np.float32), (nf * nf, nc * nc))


def cg(apply, b: torch.Tensor, iters: int):
    """Conjugate gradients as ``fem_poisson.py`` runs them, a fixed number
    of iterations, on the device (no host synchronisation)."""
    x = torch.zeros_like(b)
    r = b - apply(x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        Ap = apply(p)
        alpha = rs / torch.dot(p, Ap).clamp(min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs.clamp(min=1e-30)) * p
        rs = rs_new
    return x, torch.sqrt(rs)


def cg_random_check(ops_cg, Asp, b: np.ndarray, iters: int, dev):
    """CG on ``b`` (a seeded random right-hand side, so every iteration
    has work to do) through each operator of ``ops_cg``, held against
    the same iterations in float64 on the host (``Asp`` a scipy matrix):
    the relative residuals ``||b - A u|| / ||b||``, both computed in
    float64 on the host, may differ by ``CG_RTOL`` of the float64 one
    plus ``CG_ATOL``.  Returns ``{name: residual}`` with the float64
    one under ``"float64"``."""
    b64 = b.astype(np.float64)

    def relres(u):
        return float(np.linalg.norm(b64 - Asp @ u.astype(np.float64))
                     / np.linalg.norm(b64))

    u64, _ = cg(lambda v: torch.from_numpy(Asp @ v.numpy()),
                torch.from_numpy(b64), iters)
    out = {"float64": relres(u64.numpy())}
    bd = torch.from_numpy(b).to(dev)
    for name, op in ops_cg.items():
        u, _ = cg(op, bd, iters)
        out[name] = relres(u.cpu().numpy())
        require(abs(out[name] - out["float64"])
                <= CG_RTOL * out["float64"] + CG_ATOL,
                f"CG on {name}, random b: relative residual {out[name]} "
                f"against {out['float64']} in float64")
    return out


def product_structure(ir_a, jc_a, ir_b, jc_b, M: int, N: int):
    """The structure of A @ B from host CSC arrays: every stored B(k, j)
    expanded against A's column k in numpy, the (i, j) stream put through
    the numpy oracle.  Returns the oracle's (irS, jcS)."""
    ka = np.diff(jc_a).astype(np.int64)                   # |A(:, k)|
    cols_b = np.repeat(np.arange(jc_b.size - 1), np.diff(jc_b))
    k = ir_b.astype(np.int64)
    counts = ka[k]
    start = np.repeat(jc_a[:-1].astype(np.int64)[k], counts)
    within = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                 counts)
    i = ir_a[start + within]
    j = np.repeat(cols_b, counts)
    _, ir, jc = matlab_sparse_oracle(i, j, np.ones(i.size), M, N)
    return ir, jc


def values_at(ref, indices: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """A scipy CSC matrix read at the slots of a CSC structure; slots the
    matrix does not store (scipy drops exact zeros) read 0."""
    ref = ref.tocsc()
    ref.sort_indices()
    M = ref.shape[0]
    cols = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    want = cols.astype(np.int64) * M + indices
    rcols = np.repeat(np.arange(ref.shape[1]), np.diff(ref.indptr))
    have = rcols.astype(np.int64) * M + ref.indices
    pos = np.searchsorted(have, want).clip(0, max(have.size - 1, 0))
    hit = have[pos] == want if have.size else np.zeros(want.size, bool)
    return np.where(hit, ref.data[pos] if have.size else 0.0, 0.0)


def fem_path(dev, n: int, iters: int, counts, rng):
    """Phase 4c, the third path: the FEM workload of ``examples/
    fem_poisson.py`` and ``examples/fem_multigrid.py`` at (n + 1)^2
    degrees of freedom.  ``counts()`` reads the launch counters.  Returns
    the check row (with the launches of the refill for 2 A), the
    launches of the phase, the launches it expects, and what the kernel
    checks and the timing phase need; the caller compares the counts."""
    import scipy.sparse as sp

    from repro_torch import kernels
    from repro_torch.core.csc import CSC
    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.sparse import (cached_product_plan, convert, ops, plan,
                                    product_cache_clear, product_cache_info)

    def npass(M, N, L):
        return len(plan_digit_passes(M, N, L))

    start = counts()
    exp = dict.fromkeys(start, 0)

    def expect(**kw):
        for k, v in kw.items():
            exp[k] += v

    t0 = time.perf_counter()
    rows, cols, vals, nv, f, u_exact = fem_system(n)
    pr_, pc_, pv_, pshape = bilinear_prolongation(n)
    nc2 = pshape[1]
    row = {"third_path": f"P1 mesh {n} x {n} cells", "dofs": nv,
           "triplets": int(rows.size), "data_s": time.perf_counter() - t0}
    # -- assembly of A and P (B1, B2, B3) and the oracle
    vals_d = torch.from_numpy(vals).to(dev)
    rows_d, cols_d = torch.from_numpy(rows).to(dev), \
        torch.from_numpy(cols).to(dev)
    pat = plan(rows_d, cols_d, (nv, nv))
    A = pat.assemble(vals_d)
    k = npass(nv, nv, rows.size)
    expect(B1=k, B2=k, B3=1)
    prA, irA, jcA = matlab_sparse_oracle(rows, cols, vals.astype(np.float64),
                                         nv, nv)
    nnz = int(A.nnz)
    require(nnz == prA.size
            and np.array_equal(A.indptr.cpu().numpy(), jcA)
            and np.array_equal(A.indices[:nnz].cpu().numpy(), irA)
            and np.array_equal(A.data[:nnz].cpu().numpy(),
                               prA.astype(np.float32)),
            "FEM matrix differs from the oracle")
    row.update(nnz=nnz, max_per_row=int(np.bincount(irA).max()))
    patP = plan(torch.from_numpy(pr_).to(dev), torch.from_numpy(pc_).to(dev),
                pshape)
    P = patP.assemble(torch.from_numpy(pv_).to(dev))
    k = npass(*pshape, pr_.size)
    expect(B1=k, B2=k, B3=1)
    # -- the four SpMVs, each against the CSC result
    x = torch.from_numpy(rng.standard_normal(nv).astype(np.float32)).to(dev)
    y_csc = ops.matmul(A, x)
    absA = CSC(data=A.data.abs(), indices=A.indices, indptr=A.indptr,
               nnz=A.nnz, shape=A.shape)
    tol = 8 * EPS32 * ops.matmul(absA, x.abs())
    ell_cols, ell_vals, overflow = kernels.csc_to_ell(A,
                                                      max_per_row=FEM_K)
    require(not bool(overflow), f"ELL overflow at max_per_row={FEM_K}")
    S = convert(A, "symcsc")
    Bm = convert(A, "bsr", block=2)
    ys = {"ell": kernels.spmv(ell_cols, ell_vals, x),
          "symcsc": ops.matmul(S, x), "bsr": ops.matmul(Bm, x)}
    expect(B8=1, B9=1, B10=1)
    for name, y in ys.items():
        err = (y - y_csc).abs()
        require(bool(torch.all(err <= tol)),
                f"{name} SpMV differs from CSC by more than 8 eps sum|a x|")
        row[f"spmv_{name}_max_err_over_tol"] = float(
            (err / tol.clamp(min=1e-30)).max())
    # -- CG on the B8 and the B9 operator (fem_poisson's error bound)
    b = torch.from_numpy(f).to(dev)
    bound = 10.0 / n ** 2 + 5e-2
    ops_cg = {"ell": lambda v: kernels.spmv(ell_cols, ell_vals, v),
              "symcsc": lambda v: ops.matmul(S, v)}
    for name, op in ops_cg.items():
        u, res = cg(op, b, iters)
        expect(**{"B8" if name == "ell" else "B9": iters + 1})
        err = float(np.abs(u.cpu().numpy() - u_exact).max())
        require(np.isfinite(err) and err < bound,
                f"CG on {name}: max |u - u_exact| = {err} >= {bound}")
        row[f"cg_{name}"] = {"iters": iters, "residual": float(res),
                             "max_err": err, "bound": bound}
    # -- and on a seeded random right-hand side, against float64 CG
    Asp = sp.csc_matrix((prA, irA, jcA), shape=(nv, nv))
    b_rand = rng.standard_normal(nv).astype(np.float32)
    row["cg_random_relres"] = cg_random_check(ops_cg, Asp, b_rand, iters,
                                              dev)
    expect(B8=iters + 1, B9=iters + 1)
    # -- Galerkin product P' A P: two cached product plans, B6 refills
    product_cache_clear()
    Ac = ops.matmul(ops.matmul(ops.transpose(P), A), P)
    Ptc = convert(ops.transpose(P), "csc")
    pp1 = cached_product_plan(Ptc, A)
    PtA = pp1.multiply(Ptc.data, A.data)
    pp2 = cached_product_plan(PtA, P)
    expect(B1=npass(nc2, nv, pp1.flops) + npass(nc2, nc2, pp2.flops),
           B2=npass(nc2, nv, pp1.flops) + npass(nc2, nc2, pp2.flops),
           B6=3)
    info = product_cache_info()
    require((info["misses"], info["hits"]) == (2, 2),
            f"product cache {info} after the Galerkin product")
    # structure: a numpy expansion of the same products through the oracle
    prP, irP, jcP = matlab_sparse_oracle(pr_, pc_, pv_.astype(np.float64),
                                         *pshape)
    _, irT, jcT = matlab_sparse_oracle(pc_, pr_, pv_.astype(np.float64),
                                       nc2, nv)
    irPA, jcPA = product_structure(irT, jcT, irA, jcA, nc2, nv)
    irC, jcC = product_structure(irPA, jcPA, irP, jcP, nc2, nc2)
    for C, ir, jc, what in ((PtA, irPA, jcPA, "P' A"), (Ac, irC, jcC,
                                                        "P' A P")):
        nz = int(C.nnz)
        require(nz == ir.size and C.nzmax == nz
                and np.array_equal(C.indptr.cpu().numpy(), jc)
                and np.array_equal(C.indices.cpu().numpy(), ir),
                f"{what} structure differs from the numpy expansion")
    # values: scipy's float64 products, slot by slot
    Psp = sp.csc_matrix((prP, irP, jcP), shape=pshape)
    ref = Psp.T @ Asp @ Psp
    mag = abs(Psp).T @ abs(Asp) @ abs(Psp)
    got = Ac.data.double().cpu().numpy()
    want, wmag = values_at(ref, irC, jcC), values_at(mag, irC, jcC)
    verr = np.abs(got - want)
    require(np.all(verr <= 8 * EPS32 * wmag),
            "P' A P differs from scipy by more than 8 eps (|P'| |A| |P|)")
    row.update(nnz_PtA=int(PtA.nnz), nnz_Ac=int(Ac.nnz), flops_PtA=pp1.flops,
               flops_Ac=pp2.flops, galerkin_max_abs_err=float(verr.max()),
               galerkin_scipy_zero_slots=int(np.sum(
                   values_at(ref, irC, jcC) == 0)))
    # refill for a second coefficient: B6 and one fill, no plan kernel
    before = counts()
    A2 = pat.assemble(2 * vals_d)
    Ac2 = ops.matmul(ops.matmul(ops.transpose(P), A2), P)
    expect(B3=1, B6=2)
    after = counts()
    refill = {k: after[k] - before[k] for k in after}
    require(torch.equal(Ac2.data, 2 * Ac.data) and product_cache_info()[
        "misses"] == 2, "the refill for 2 A differs from 2 (P' A P)")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got_counts = {k: counts()[k] - start[k] for k in start}
    row["run_s"] = time.perf_counter() - t0
    row["refill_launches"] = refill
    ctx = dict(A=A, pat=pat, rows_d=rows_d, cols_d=cols_d, vals_d=vals_d,
               x=x, b=torch.from_numpy(b_rand).to(dev), ell=(ell_cols,
               ell_vals), S=S, Bm=Bm, P=P, Ptc=Ptc, PtA=PtA, pp1=pp1,
               pp2=pp2, ops_cg=ops_cg, nv=nv, nc2=nc2, hostA=(irA, jcA),
               hostPt=(irT, jcT), host=(rows, cols, vals))
    return row, got_counts, exp, ctx


def fem_kernel_checks(fem, rng, dev):
    """Phase 3 for the third path's kernels, on the streams phase 4c gave
    them: B6, B8, B9 and B10 against their plain versions, bit for bit on
    integer-valued data and within stated tolerances on random float32
    data; B6 also with a NaN.  Returns each kernel's largest float32
    error against its plain version."""
    from repro_torch.core.csc import slot_columns
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import gather2_segment_sum_ref
    from repro_torch.kernels.spmv import spmv as ell_mod
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import bsr_tiles_ref, sym_streams_ref

    def ints(n):
        return torch.from_numpy(rng.integers(-8, 9, n).astype(np.float32)) \
            .to(dev)

    def floats(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)) \
            .to(dev)

    def within(got, want, mag, c, what):
        # c terms per output: any two summation orders differ by at most
        # c * eps * sum|terms| (each is within (c - 1) eps / 2 of exact)
        err = (got - want).abs()
        tol = c * EPS32 * mag
        require(bool(torch.all(err <= tol)),
                f"{what}: error above {c} eps x sum|terms|")
        return float(err.max())

    errs = dict.fromkeys(("B6", "B8", "B9", "B10"), 0.0)
    # B6 on both products of the Galerkin operator
    for what, pp, a, b in (("P' A", fem["pp1"], fem["Ptc"], fem["A"]),
                           ("P' A P", fem["pp2"], fem["PtA"], fem["P"])):
        st = (pp.sa, pp.sb, pp.pattern.slot)
        nz = dict(num_segments=pp.nzmax)
        va, vb = ints(a.nzmax), ints(b.nzmax)
        require(torch.equal(ss_mod.gather2_segment_sum(va, vb, *st, **nz),
                            gather2_segment_sum_ref(va, vb, *st, **nz)),
                f"B6 differs on integer-valued data, {what}")
        va, vb = floats(a.nzmax), floats(b.nzmax)
        run = int(torch.bincount(pp.pattern.slot.long()).max())
        errs["B6"] = max(errs["B6"], within(
            ss_mod.gather2_segment_sum(va, vb, *st, **nz),
            gather2_segment_sum_ref(va, vb, *st, **nz),
            gather2_segment_sum_ref(va.abs(), vb.abs(), *st, **nz), run,
            f"B6 float32, {what}"))
        # a NaN among integer-valued data: the rest is exact, bit for bit
        va, vb = ints(a.nzmax), ints(b.nzmax)
        va[int(pp.sa[0])] = float("nan")
        got = ss_mod.gather2_segment_sum(va, vb, *st, **nz)
        require(bool(torch.isnan(got).any()) and same_bits(
            got, gather2_segment_sum_ref(va, vb, *st, **nz)),
            f"B6 differs with a NaN, {what}")
    # B8 on the ELL arrays of A
    cols, vals = fem["ell"]
    nv = fem["nv"]
    xi, x = ints(nv), fem["x"]
    require(torch.equal(ell_mod.spmv_ell(cols, vals, xi),
                        spmv_ell_ref(cols, vals, xi)),
            "B8 differs on integer-valued data")
    errs["B8"] = within(ell_mod.spmv_ell(cols, vals, x),
                        spmv_ell_ref(cols, vals, x),
                        spmv_ell_ref(cols, vals.abs(), x.abs()), FEM_K,
                        "B8 float32")
    # B9 on SymCSC's strict-upper stream
    S = fem["S"]
    st = (S.indices, S.data, S.indptr)
    for got, want in zip(sym_mod.sym_streams(*st, xi),
                         sym_streams_ref(*st, xi)):
        require(torch.equal(got, want), "B9 differs on integer-valued data")
    (up, ct), (up0, ct0) = sym_mod.sym_streams(*st, x), sym_streams_ref(*st, x)
    require(torch.equal(up, up0), "B9's up stream differs (one product)")
    _, mag = sym_streams_ref(S.indices, S.data.abs(), S.indptr, x.abs())
    errs["B9"] = within(ct, ct0, mag, int(torch.diff(S.indptr).max()),
                        "B9 column totals, float32")
    # the same in the shape the path takes on it (SymCSC.longest: one
    # thread a column); the lines above run the tiles
    lw = dict(longest=S.longest)
    for got, want in zip(sym_mod.sym_streams(*st, xi, **lw),
                         sym_streams_ref(*st, xi)):
        require(torch.equal(got, want), "B9 differs on integer-valued data "
                "(one thread a column)")
    up, ct = sym_mod.sym_streams(*st, x, **lw)
    require(torch.equal(up, up0), "B9's up stream differs (one thread a "
            "column)")
    errs["B9"] = max(errs["B9"], within(
        ct, ct0, mag, S.longest, "B9 column totals, float32, one thread a "
        "column"))
    # B10 on the 2 x 2 BSR blocks
    Bm = fem["Bm"]
    bcols = slot_columns(Bm.indptr, Bm.nbmax).clamp(0, Bm.Nb - 1)
    st = (Bm.indices, bcols, Bm.data)
    kw = dict(Mb=Bm.Mb)
    require(torch.equal(sym_mod.bsr_tiles(*st, xi, **kw),
                        bsr_tiles_ref(*st, xi, **kw)),
            "B10 differs on integer-valued data")
    errs["B10"] = within(
        sym_mod.bsr_tiles(*st, x, **kw), bsr_tiles_ref(*st, x, **kw),
        bsr_tiles_ref(Bm.indices, bcols, Bm.data.abs(), x.abs(), **kw),
        Bm.block, "B10 float32")
    torch.cuda.synchronize()
    return errs


def product_run_checks(dev, rng) -> dict:
    """Phase 3d: B6 on streams that cross its tiles (``product_stream``:
    one run of 2^20 products, runs of random length 1..10^4, a run that
    starts at a tile's last position, a tile of only dropped slots; and
    ``B' B`` of the arrow matrix, whose dense column gives one run of
    2^20, where its host expansion stays under ``ARROW_GRAM_MAX_FLOPS``),
    float32 and float64: bit for bit against the plain version on
    integer-valued data, with and without a NaN; bit for bit from call to
    call on random data and there within ``C_SEG`` eps of each slot's
    sum|terms| of the exact sum of its rounded products; one launch a
    call.  Each variant of the probe bit for bit on integer-valued data
    on the random stream.  Returns the largest error over eps sum|terms|
    per stream and dtype."""
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import (PRODUCT_TILE,
                                                     gather2_segment_sum_ref)

    kern = ss_mod.gather2_segment_sum
    streams = {}
    for kind in PRODUCT_KINDS:
        sa, sb, slot = product_stream(kind, PRODUCT_TILE, rng,
                                      operands=1 << 20)
        n = int(slot[(slot >= 0) & (slot < 2**30)].max()) + 1
        streams[kind] = ((1 << 20, 1 << 20), *(torch.from_numpy(x).to(dev)
                                               for x in (sa, sb, slot)), n)
    flops = arrow_gram_flops()
    if flops <= ARROW_GRAM_MAX_FLOPS:
        pp, Bt, B = arrow_gram(dev, rng)
        streams["arrow_gram"] = ((Bt.nzmax, B.nzmax), pp.sa, pp.sb,
                                 pp.pattern.slot, pp.nzmax)
    out = {"arrow_gram_flops": flops}
    for name, ((na, nb), sa, sb, slot, n) in streams.items():
        st, nz = (sa, sb, slot), dict(num_segments=n)
        row = {"L": int(slot.numel()), "num_segments": n,
               "longest_run": int(torch.bincount(
                   slot[(slot >= 0) & (slot < n)].long()).max())}
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            def draw(k, ints):
                x = rng.integers(-8, 9, k) if ints else \
                    rng.standard_normal(k)
                return torch.from_numpy(x).to(dev, dtype)

            va, vb = draw(na, True), draw(nb, True)
            before = kern.launches
            got = kern(va, vb, *st, **nz)
            require(kern.launches == before + 1, "B6: not one launch a call")
            require(torch.equal(got, gather2_segment_sum_ref(va, vb, *st,
                                                             **nz)),
                    f"B6 {dtype} differs on integer-valued data, {name}")
            kept = torch.nonzero((slot >= 0) & (slot < n)).flatten()
            va[int(sa[kept[kept.numel() // 2]])] = float("nan")
            got = kern(va, vb, *st, **nz)
            require(bool(torch.isnan(got).any()) and same_bits(
                got, gather2_segment_sum_ref(va, vb, *st, **nz)),
                f"B6 {dtype} differs with a NaN, {name}")
            va, vb = draw(na, False), draw(nb, False)
            got = kern(va, vb, *st, **nz)
            require(torch.equal(kern(va, vb, *st, **nz), got),
                    f"B6 {dtype} differs from call to call, {name}")
            r = product_err_over_eps(got, va, vb, sa, sb, slot, eps)
            require(r <= C_SEG, f"B6 {dtype} error {r} eps x sum|terms| > "
                    f"{C_SEG}, {name}")
            row[f"{dtype}_max_err_over_eps_sum_abs"] = r
        out[name] = row
    # the probe's variants, bit for bit on integer-valued data
    (na, nb), sa, sb, slot, n = streams["random"]
    va, vb = (torch.from_numpy(rng.integers(-8, 9, k).astype(np.float32))
              .to(dev) for k in (na, nb))
    want = gather2_segment_sum_ref(va, vb, sa, sb, slot, num_segments=n)
    for v, i in PRODUCT_VARIANTS.items():
        require(torch.equal(product_probe(i, va, vb, sa, sb, slot, n), want),
                f"B6 probe variant {v} differs on integer-valued data")
    torch.cuda.synchronize()
    return out


def fem_times(fem, cpm, dev):
    """Phase 5 for the third path: each kernel (device time back to back,
    one call, its plain version, a PyTorch yardstick, the byte bound) and
    the path's own times.  Returns (kernel rows, path times)."""
    from repro_torch import kernels
    from repro_torch.core.csc import slot_columns
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import gather2_segment_sum_ref
    from repro_torch.kernels.spmv import spmv as ell_mod
    from repro_torch.kernels.spmv.ref import spmv_ell_ref
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import bsr_tiles_ref, sym_streams_ref
    from repro_torch.sparse import convert, ops, plan, spgemm

    A, S, Bm, x, nv = fem["A"], fem["S"], fem["Bm"], fem["x"], fem["nv"]
    cols, vals = fem["ell"]
    t = {"times": "third path", "dofs": nv}
    # cuSPARSE yardsticks: A as a torch CSR tensor, and as torch BSR
    Acsr = convert(A, "csr")
    nnz = int(A.nnz)
    A_t = torch.sparse_csr_tensor(Acsr.indptr, Acsr.indices[:nnz],
                                  Acsr.data[:nnz], A.shape)
    nb = int(Bm.nnz)
    brow = Bm.indices[:nb].long()
    bcol = slot_columns(Bm.indptr, Bm.nbmax)[:nb].long()
    order = torch.argsort(brow * Bm.Nb + bcol)
    crow = torch.cat([brow.new_zeros(1), torch.cumsum(
        torch.bincount(brow, minlength=Bm.Mb), 0)])
    B_t = torch.sparse_bsr_tensor(crow, bcol[order], Bm.data[:nb][order],
                                  Bm.shape)
    try:  # a yardstick only: PyTorch may lack a BSR product on CUDA
        torch.mv(B_t, x)
        bsr_lib = lambda: torch.mv(B_t, x)  # noqa: E731
    except (RuntimeError, NotImplementedError) as e:
        print(f"times: no PyTorch BSR product on CUDA ({e})", flush=True)
        bsr_lib = None
    # the kernels' inputs at this path's shapes
    pp, Ptc = fem["pp1"], fem["Ptc"]
    st = (pp.sa, pp.sb, pp.pattern.slot)
    nz = dict(num_segments=pp.nzmax)
    slot_l = pp.pattern.slot.long()
    sym_in = (S.indices, S.data, S.indptr, x)
    bcols = slot_columns(Bm.indptr, Bm.nbmax).clamp(0, Bm.Nb - 1)
    bsr_in = (Bm.indices, bcols, Bm.data, x)
    F, M, K, nzh, b = pp.flops, nv, FEM_K, S.nzmax, Bm.block
    # B6 gathers operand values, so it reads those the streams reach (A's
    # padded tail is never read), not whole operand vectors; on both
    # products of the Galerkin operator (B6_Ac: (P' A) P)
    pp2, PtA, P = fem["pp2"], fem["PtA"], fem["P"]
    st2 = (pp2.sa, pp2.sb, pp2.pattern.slot)
    nz2 = dict(num_segments=pp2.nzmax)
    slot2_l = pp2.pattern.slot.long()

    def b6_bytes(q):
        reached = [int(torch.unique(i).numel()) for i in (q.sa, q.sb)]
        return 12 * q.flops + 4 * sum(reached) + 4 * q.nzmax

    fns = {
        "B6": (lambda: ss_mod.gather2_segment_sum(Ptc.data, A.data, *st, **nz),
               lambda: gather2_segment_sum_ref(Ptc.data, A.data, *st, **nz),
               lambda: torch.zeros(pp.nzmax, device=dev).index_add_(
                   0, slot_l, Ptc.data[pp.sa] * A.data[pp.sb]),
               b6_bytes(pp), 2 * F),
        "B6_Ac": (lambda: ss_mod.gather2_segment_sum(PtA.data, P.data, *st2,
                                                     **nz2),
                  lambda: gather2_segment_sum_ref(PtA.data, P.data, *st2,
                                                  **nz2),
                  lambda: torch.zeros(pp2.nzmax, device=dev).index_add_(
                      0, slot2_l, PtA.data[pp2.sa] * P.data[pp2.sb]),
                  b6_bytes(pp2), 2 * pp2.flops),
        "B8": (lambda: ell_mod.spmv_ell(cols, vals, x),
               lambda: spmv_ell_ref(cols, vals, x),
               lambda: torch.mv(A_t, x), 8 * M * K + 4 * nv + 4 * M,
               2 * M * K),
        "B9": (lambda: sym_mod.sym_streams(*sym_in, longest=S.longest),
               lambda: sym_streams_ref(*sym_in),
               lambda: torch.mv(A_t, x), 12 * nzh + 12 * M + 4, 3 * nzh),
        "B10": (lambda: sym_mod.bsr_tiles(*bsr_in, Mb=Bm.Mb),
                lambda: bsr_tiles_ref(*bsr_in, Mb=Bm.Mb), bsr_lib,
                4 * b * b * Bm.nbmax + 8 * Bm.nbmax + 4 * Bm.N
                + 4 * b * Bm.nbmax, 2 * b * b * Bm.nbmax),
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
    # B6 beside the design it replaced, its two-gather floor (its loads and
    # products, no reduction) and the probe's tile depths and register
    # bounds (the sweep), on both products
    for k, (a, bm, q) in (("B6", (Ptc, A, pp)), ("B6_Ac", (PtA, P, pp2))):
        args = (a.data, bm.data, q.sa, q.sb, q.pattern.slot)
        r = rows_k[k]
        r["flops"], r["nzmax"] = q.flops, q.nzmax
        r["gather2_floor_ms"] = device_ms(
            lambda: gather2_floor(*args, q.nzmax), cpm)
        r["sweep_ms"] = {v: device_ms(
            lambda i=i: product_probe(i, *args, q.nzmax), cpm)
            for v, i in PRODUCT_VARIANTS.items()}
        r["replaced_ms"] = r["sweep_ms"].pop("replaced")
        r["sweep_winner"] = min(r["sweep_ms"], key=r["sweep_ms"].get)
    t["kernels"] = rows_k
    # the path: plan and fill of A, each SpMV, one CG iteration
    pat, vals_d = fem["pat"], fem["vals_d"]
    spmvs = {"plan_A": lambda: plan(fem["rows_d"], fem["cols_d"], A.shape),
             "fill_A": lambda: pat.assemble(vals_d),
             "spmv_csc": lambda: ops.matmul(A, x),
             "spmv_ell": lambda: kernels.spmv(cols, vals, x),
             "spmv_symcsc": lambda: ops.matmul(S, x),
             "spmv_bsr": lambda: ops.matmul(Bm, x)}
    for what, fn in spmvs.items():
        t[f"{what}_ms"] = call_ms(fn)
        t[f"{what}_device_ms"] = device_ms(fn, cpm)
        t[f"{what}_device_idle_share"] = \
            1.0 - t[f"{what}_device_ms"] / t[f"{what}_ms"]
    # where an operator's device time goes: the top kernels of one call
    for what in ("spmv_csc", "spmv_symcsc", "spmv_bsr"):
        t[f"{what}_top_kernels"] = top_kernels(spmvs[what])
    for name, op in fem["ops_cg"].items():
        t[f"cg_iteration_{name}_ms"] = call_ms(
            lambda: cg(op, fem["b"], 10), reps=5) / 10
    # product_plan: the host expansion and the device plan, both products
    for what, (a, bm, pq) in (("PtA", (Ptc, A, pp)),
                              ("Ac", (PtA, P, fem["pp2"]))):
        ir_a, jc_a, _, _ = spgemm._csc_structure(a)
        ir_b, jc_b, nnz_b, _ = spgemm._csc_structure(bm)
        t[f"product_plan_{what}_ms"] = host_ms(
            lambda: spgemm.product_plan(a, bm), 3)
        t[f"product_plan_{what}_host_expand_ms"] = host_ms(
            lambda: spgemm._expand(ir_a, jc_a, ir_b, jc_b, nnz_b, a.M, None),
            3)
        rc, cc = (torch.from_numpy(v).to(dev) for v in spgemm._expand(
            ir_a, jc_a, ir_b, jc_b, nnz_b, a.M, None)[:2])
        t[f"product_plan_{what}_device_plan_ms"] = device_ms(
            lambda: plan(rc, cc, pq.shape, nzmax=pq.flops), cpm, reps=5)
        t[f"refill_{what}_ms"] = call_ms(lambda: pq.multiply(a.data, bm.data))
        t[f"refill_{what}_device_ms"] = device_ms(
            lambda: pq.multiply(a.data, bm.data), cpm)
    t["galerkin_refill_ms"] = host_ms(
        lambda: ops.matmul(ops.matmul(ops.transpose(P), A), P), 5)
    return rows_k, t


def complex_checks(dev, sets, rng, n: int = 199):
    """Complex values on the card, which the float kernels take one real
    part at a time (``kernels.common.split_complex``), against the CPU's
    plain versions on the complex values: the fills of Table 4.1's set 1
    (sum and mean through B3', ``fill_pallas`` through B5), and on the
    FEM matrix of an ``n`` x ``n``-cell mesh the ELL, SymCSC and BSR
    SpMVs (B8, B9, B10) and the refill of ``P' A`` (B6).  Each part
    within the kernel's own ``c eps sum|terms|`` (a part of a complex
    product has twice the terms).  Returns the largest error over its
    tolerance, per result."""
    from repro_torch import kernels
    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.kernels.assembly_ops import fill_pallas
    from repro_torch.sparse import convert, ops, plan, product_plan
    from repro_torch.sparse.pattern import plan_coo

    def cplx(k):
        return (rng.standard_normal(k) + 1j * rng.standard_normal(k)) \
            .astype(np.complex64)

    ii, jj, ss, siz = sets["1"]
    v = cplx(ii.shape[0])
    rows_h, cols_h, vals_h, nv, _, _ = fem_system(n)
    pr_, pc_, pv_, pshape = bilinear_prolongation(n)
    w = complex(*rng.standard_normal(2))  # keeps A symmetric
    x = cplx(nv)

    def run(d):
        coo = coo_from_matlab(ii, jj, ss, (siz, siz), device=d)
        pat = plan_coo(coo)
        vd = torch.from_numpy(v).to(d)
        out = {"sum": pat.assemble(vd).data,
               "mean": plan_coo(coo, accum="mean").assemble(vd).data,
               "fill_pallas": fill_pallas(pat, vd).data}
        mag = pat.assemble(vd.abs()).data
        mags = {"sum": 8 * mag,
                "mean": 8 * plan_coo(coo, accum="mean").assemble(
                    vd.abs()).data,
                "fill_pallas": 2 * C_SCAN * torch.cumsum(mag.double(), 0)}
        A = plan(torch.from_numpy(rows_h).to(d),
                 torch.from_numpy(cols_h).to(d), (nv, nv)).assemble(
            torch.from_numpy(vals_h).to(d) * w)
        P = plan(torch.from_numpy(pr_).to(d), torch.from_numpy(pc_).to(d),
                 pshape).assemble(torch.from_numpy(pv_).to(d))
        Pt = convert(ops.transpose(P), "csc")
        xd = torch.from_numpy(x).to(d)
        ell_cols, ell_vals, _ = kernels.csc_to_ell(A, max_per_row=FEM_K)
        out.update(ell=kernels.spmv(ell_cols, ell_vals, xd),
                   symcsc=ops.matmul(convert(A, "symcsc"), xd),
                   bsr=ops.matmul(convert(A, "bsr", block=2), xd))
        spmv_mag = 2 * 8 * kernels.spmv(ell_cols, ell_vals.abs(), xd.abs())
        mags.update(ell=spmv_mag, symcsc=spmv_mag, bsr=spmv_mag)
        pp = product_plan(Pt, A)
        out["product"] = pp.multiply(Pt.data, A.data).data
        mags["product"] = 2 * 8 * pp.multiply(Pt.data.abs(),
                                              A.data.abs()).data
        return ({k: t.cpu() for k, t in out.items()},
                {k: t.cpu() for k, t in mags.items()})

    got, mags = run(dev)
    want, _ = run("cpu")
    ratios = {}
    for k, g in got.items():
        require(g.dtype == want[k].dtype == torch.complex64,
                f"complex {k}: dtype {g.dtype}")
        tol = EPS32 * mags[k].double() + 1e-30
        ratios[k] = max(float(((part(g) - part(want[k])).abs().double()
                               / tol).max())
                        for part in (torch.real, torch.imag))
        require(ratios[k] <= 1.0, f"complex {k} on the card differs from "
                f"the CPU path by {ratios[k]} x its tolerance")
    return ratios


# -- the fourth path: dynamic patterns and symmetric planning --------------
def edge_flip(n: int, rng):
    """The edge flip of phase 4d on ``fem_system(n)``'s stream.

    ``FLIP_FRAC`` of the n x n cells, drawn with ``rng`` among the cells
    with ``1 <= ix, iy <= n - 2`` (so none of their vertices is a
    Dirichlet row), turn their diagonal: the 18 triplets of their two
    triangles are dropped and the 18 of ``(v00, v10, v11)`` and ``(v00,
    v01, v11)`` appended (``K_FLIP``; values stay dyadic).  Returns the
    drop mask over the stream's order and the new zero-offset triplets
    (int32 rows, int32 cols, float32 vals)."""
    k = round(FLIP_FRAC * n * n)
    m = n - 2
    pick = rng.choice(m * m, k, replace=False)
    ix, iy = pick // m + 1, pick % m + 1
    # the cells' raw positions in p1_triplets' order ([ix, iy, 2, 3, 3])
    raw = ((ix * n + iy)[:, None] * 18 + np.arange(18)).ravel()
    rows, cols, _, nv = p1_triplets(n)
    vx, vy = np.arange(nv) % (n + 1), np.arange(nv) // (n + 1)
    boundary = (vx == 0) | (vx == n) | (vy == 0) | (vy == n)
    keep = ~(boundary[rows] | boundary[cols])   # fem_system's filter
    require(bool(np.all(keep[raw])), "a flipped cell touches the boundary")
    L = int(keep.sum()) + int(boundary.sum())   # + the identity rows
    drop = np.zeros(L, bool)
    drop[(np.cumsum(keep) - 1)[raw]] = True
    v = lambda x, y: (y * (n + 1) + x).astype(np.int32)  # noqa: E731
    v00, v10, v01, v11 = v(ix, iy), v(ix + 1, iy), v(ix, iy + 1), \
        v(ix + 1, iy + 1)
    tri = np.stack([np.stack([v00, v10, v11], -1),
                    np.stack([v00, v01, v11], -1)], 1)       # [k, 2, 3]
    full = (k, 2, 3, 3)
    return drop, (np.broadcast_to(tri[..., :, None], full).ravel(),
                  np.broadcast_to(tri[..., None, :], full).ravel(),
                  np.broadcast_to(K_FLIP, full).ravel().astype(np.float32))


def ladder_reach(qr, qc, tr, tc, side: str) -> int:
    """The number of distinct targets the merge search's ladder compares
    against for these queries: the targets it must read (B7's bound)."""
    from repro_torch.kernels.merge.ref import _below, search_steps

    n = tr.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=tr.device)
    lo = torch.zeros_like(qr)
    hi = torch.full_like(qr, n)
    for _ in range(search_steps(n)):
        active = lo < hi
        mid = torch.clamp((lo + hi) // 2, max=n - 1).long()
        seen[mid[active]] = True
        below = _below(tc[mid], tr[mid], qc, qr, inclusive=side == "right")
        lo = torch.where(active & below, mid.int() + 1, lo)
        hi = torch.where(active & ~below, mid.int(), hi)
    return int(seen.sum())


def update_path(dev, sets, fem, counts, rng):
    """Phase 4d, the fourth path: ``SparsePattern.update`` on appended
    deltas of the main path's sets, the FEM edge flip through
    ``sparse2_update``, and symmetric and block planning of the FEM
    matrix.  ``counts()`` reads the launch counters.  Returns the check
    rows, the launches of the phase, the launches it expects, and the
    streams the B7 checks and the timing phase need."""
    from repro_torch.kernels.radix_sort.ops import plan_digit_passes
    from repro_torch.core.coo import host_triplets
    from repro_torch.sparse import (detect_block, fsparse, pattern_symmetric,
                                    plan, plan_cache_clear, plan_cache_info,
                                    plan_lookup, sparse2, sparse2_update)

    fields = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")

    def npass(M, N, L):
        return len(plan_digit_passes(M, N, L))

    start = counts()
    exp = dict.fromkeys(start, 0)

    def expect(**kw):
        for k, v in kw.items():
            exp[k] += v

    def launched(fn):
        """``fn()`` and the launches it made, by kernel."""
        before = counts()
        out = fn()
        after = counts()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    rows_out, ctx = [], {}
    # -- 1. appended deltas on the main path's sets -------------------------
    for name, (ii, jj, ss, siz) in sets.items():
        t0 = time.perf_counter()
        r_h, c_h, _, _ = host_triplets(ii, jj, ss, (siz, siz))
        r, c = torch.from_numpy(r_h).to(dev), torch.from_numpy(c_h).to(dev)
        del r_h, c_h
        L = r.shape[0]
        full = plan(r, c, (siz, siz))  # phase 4's radix plan of the set
        expect(B1=npass(siz, siz, L), B2=npass(siz, siz, L))
        row = {"fourth_path": f"update, set {name}", "L": L}
        for frac in UPDATE_FRACS:
            Ld = round(frac * L)
            Lb = L - Ld
            base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
            expect(B1=npass(siz, siz, Lb), B2=npass(siz, siz, Lb))
            got, made = launched(lambda: base.update(r[Lb:], c[Lb:]))
            k = npass(siz, siz, Ld)
            require(made == {"B1": k, "B2": k, "B7": 1},
                    f"update of set {name} at {frac} launched {made}, "
                    f"expected {k} B1, {k} B2 and one B7")
            expect(B1=k, B2=k, B7=1)
            for f in fields:
                require(torch.equal(getattr(got, f), getattr(full, f)),
                        f"update of set {name} at {frac}: {f} differs from "
                        "the plan of the whole set")
            require(got.epoch == 1 and got.nzmax == L,
                    f"update of set {name}: epoch {got.epoch}, nzmax "
                    f"{got.nzmax}")
            same, made = launched(lambda: base.update(r[:0], c[:0]))
            require(same is base and not made, f"an empty update of set "
                    f"{name} launched {made} or made a new plan")
            row[f"Ld_{frac}"] = Ld
            row[f"delta_passes_{frac}"] = k
            if name == "2x20":
                ctx[f"update_{frac}"] = (base.srows, base.scols, r[Lb:],
                                         c[Lb:], siz)
            del base, got
        row["update"] = "bit-identical to the plan of the whole set"
        row["run_s"] = time.perf_counter() - t0
        rows_out.append(row)
        del r, c, full
        torch.cuda.empty_cache()
    # -- 2. the FEM edge flip through sparse2_update -------------------------
    t0 = time.perf_counter()
    rows_f, cols_f, vals_f = fem["host"]
    nv, A = fem["nv"], fem["A"]
    drop, (ar, ac, av) = edge_flip(FEM_N, rng)
    Lf, Ld = rows_f.size, ar.size
    keep = ~drop
    ci = np.concatenate([rows_f[keep], ar])
    cj = np.concatenate([cols_f[keep], ac])
    cv = np.concatenate([vals_f[keep], av])
    plan_cache_clear()
    t1 = time.perf_counter()
    F, made = launched(lambda: sparse2_update(
        rows_f + 1, cols_f + 1, vals_f, ar + 1, ac + 1, av, (nv, nv),
        drop_mask=drop))
    torch.cuda.synchronize()
    flip_s = time.perf_counter() - t1
    kb, kd = npass(nv, nv, Lf), npass(nv, nv, Ld)
    require(made == {"B1": kb + kd, "B2": kb + kd, "B3": 1, "B7": 1},
            f"sparse2_update of the edge flip launched {made}")
    expect(B1=kb + kd, B2=kb + kd, B3=1, B7=1)
    G = fsparse(ci + 1, cj + 1, cv, (nv, nv), nzmax=F.nzmax)
    expect(B1=npass(nv, nv, ci.size), B2=npass(nv, nv, ci.size), B3=1)
    for f in ("data", "indices", "indptr", "nnz"):
        require(torch.equal(getattr(F, f), getattr(G, f)),
                f"edge flip: sparse2_update's {f} differs from fsparse")
    prF, irF, jcF = matlab_sparse_oracle(ci, cj, cv.astype(np.float64),
                                         nv, nv)
    nz = int(F.nnz)
    require(nz == prF.size and nz == int(A.nnz)
            and np.array_equal(F.indptr.cpu().numpy(), jcF)
            and np.array_equal(F.indices[:nz].cpu().numpy(), irF)
            and np.array_equal(F.data[:nz].cpu().numpy(),
                               prF.astype(np.float32))
            and bool(torch.all(F.indices[nz:] == nv))
            and int(torch.count_nonzero(F.data[nz:])) == 0,
            "edge flip differs from the oracle")
    H, made = launched(lambda: sparse2(ci + 1, cj + 1, cv, (nv, nv),
                                       nzmax=F.nzmax))
    expect(B3=1)
    info = plan_cache_info()
    require(made == {"B3": 1} and info["hits"] == 1
            and torch.equal(H.data, F.data),
            f"sparse2 after the flip launched {made} (cache {info})")
    _, pat_f, _ = plan_lookup(ci + 1, cj + 1, cv, (nv, nv), nzmax=F.nzmax)
    sym_f, made = launched(lambda: pattern_symmetric(pat_f))
    require(sym_f and made == {"B7": 2},
            f"the flipped plan: symmetric {sym_f}, launched {made}")
    expect(B7=2)
    torch.cuda.synchronize()
    rows_out.append({
        "fourth_path": f"edge flip, P1 mesh {FEM_N} x {FEM_N} cells",
        "cells": Ld // 18, "dropped": int(drop.sum()), "added": Ld, "L": Lf,
        "nnz": nz, "sparse2_update_s": flip_s,
        "result": "bit-identical to fsparse and the oracle; sparse2 hit "
                  "runs one fill; pattern symmetric",
        "run_s": time.perf_counter() - t0})
    plan_cache_clear()
    del F, G, H, pat_f, prF, irF, jcF
    # -- 3. symmetric and block planning of the FEM matrix -------------------
    t0 = time.perf_counter()
    pat = fem["pat"]
    sym, made = launched(lambda: pattern_symmetric(pat))
    require(sym and made == {"B7": 2},
            f"pattern_symmetric(A): {sym}, launched {made}")
    expect(B7=2)
    first = pat.first
    sr, sc = pat.srows[first].contiguous(), pat.scols[first].contiguous()
    require(sr.shape[0] == int(A.nnz), "first-flagged stream != nnz(A)")
    ctx["symmetric"] = (sc, sr, sr, sc)  # queries: the mirrored keys
    k = int(np.nonzero(rows_f != cols_f)[0][0])
    one = ~((fem["rows_d"] == int(rows_f[k])) & (fem["cols_d"] ==
                                                  int(cols_f[k])))
    pat_m = plan(fem["rows_d"][one], fem["cols_d"][one], (nv, nv))
    Lm = int(one.sum())
    expect(B1=npass(nv, nv, Lm), B2=npass(nv, nv, Lm))
    require(not pattern_symmetric(pat_m),
            "a copy with one mirror removed tests symmetric")
    expect(B7=2)
    del pat_m, one
    Y = fsparse(rows_f + 1, cols_f + 1, vals_f, (nv, nv), format="symcsc")
    Lu = int(np.sum(rows_f < cols_f))
    Ldiag = int(np.sum(rows_f == cols_f))
    expect(B1=npass(nv, nv, Lu), B2=npass(nv, nv, Lu), B3=1)
    S = fem["S"]
    nzu = int(S.nnz)
    require(int(Y.nnz) == nzu and torch.equal(Y.diag, S.diag)
            and torch.equal(Y.data[:nzu], S.data)
            and torch.equal(Y.indices[:nzu], S.indices)
            and torch.equal(Y.indptr, S.indptr)
            and bool(torch.all(Y.indices[nzu:] == nv))
            and int(torch.count_nonzero(Y.data[nzu:])) == 0,
            "fsparse(format='symcsc') differs from convert(A, 'symcsc')")
    Bz = fsparse(rows_f + 1, cols_f + 1, vals_f, (nv, nv), format="bsr",
                 block=2)
    expect(B1=npass(nv, nv, Lf), B2=npass(nv, nv, Lf), B3=1)
    require(all(torch.equal(getattr(Bz, f), getattr(fem["Bm"], f))
                for f in ("data", "indices", "indptr", "nnz")),
            "fsparse(format='bsr', block=2) differs from convert(A, 'bsr')")
    blk = detect_block(rows_f, cols_f, (nv, nv))
    require(blk == 1, f"detect_block of the P1 stream is {blk}, not 1")
    torch.cuda.synchronize()
    rows_out.append({
        "fourth_path": "symmetric and block planning, FEM matrix",
        "pattern_symmetric": "true on A and the flipped stream, false "
                             "with one mirror removed",
        "B7_Lq_n": int(sr.shape[0]), "symcsc": "equal to convert(A)",
        "symcsc_values_streamed": Lu + Ldiag, "full_values_streamed": Lf,
        "bsr_block2": "equal to convert(A)", "detect_block": blk,
        "run_s": time.perf_counter() - t0})
    del Y, Bz
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got = {k: counts()[k] - start[k] for k in start}
    return rows_out, got, exp, ctx


def merge_kernel_checks(ctx, rng, dev):
    """Phase 3 for B7: the kernel against its plain version, bit for bit,
    on both call sites' streams (the update's sorted delta into the 5e7
    set's survivors at each delta share; the FEM structure's mirrors)
    and both sides, on edge cases (ties, sentinel rows, n = 1, a query
    count that is no multiple of the block) and on ``merge_streams``
    (random queries, ties at the narrowed ranges' edges, queries below
    and above every target, n = 2^k +- 1), each also against
    ``torch.searchsorted`` of the packed keys."""
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import merge_search_ref
    from repro_torch.sparse.dispatch import sorted_permutation

    cases = {}
    for frac in UPDATE_FRACS:
        sr_a, sc_a, ar, ac, siz = ctx[f"update_{frac}"]
        d = sorted_permutation(ar, ac, M=siz, N=siz).long()
        cases[f"update 2x20 {frac}"] = (ar[d], ac[d], sr_a, sc_a, siz)
    qr, qc, tr, tc = ctx["symmetric"]
    cases["symmetric FEM"] = (qr, qc, tr, tc, int(tr.max()) + 1)
    M = 1000

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    tr_e = np.sort(rng.integers(0, M + 1, 5000))   # one column, sentinels
    tc_e = np.zeros(5000, np.int32)
    cases["ties"] = (i32(tr_e[::7]), i32(tc_e[::7]), i32(tr_e), i32(tc_e), M)
    q = rng.integers(0, M + 1, mg.BLOCK_Q * 3 + 5)
    q[::4] = M
    cases["sentinels, ragged Lq"] = (i32(q), i32(np.zeros_like(q)),
                                     i32(tr_e), i32(tc_e), M)
    cases["n = 1"] = (i32([3, 4, 5, 4]), i32([2, 2, 2, 1]), i32([4]),
                      i32([2]), M)
    # the streams that break a search narrowed by blocks of queries
    for kind in MERGE_KINDS:
        qr, qc, tr, tc, Mk = merge_streams(kind, rng, mg.BLOCK_Q)
        cases[kind] = (i32(qr), i32(qc), i32(tr), i32(tc), Mk)
    for name, (qr, qc, tr, tc, Mk) in cases.items():
        key = tc.long() * (Mk + 1) + tr.long()
        qkey = qc.long() * (Mk + 1) + qr.long()
        for side in ("left", "right"):
            got = mg.merge_search_kernel(qr, qc, tr, tc, side=side)
            require(torch.equal(got, merge_search_ref(qr, qc, tr, tc,
                                                      side=side)),
                    f"B7 differs from its plain version, {name}, {side}")
            require(torch.equal(got.long(), torch.searchsorted(
                key, qkey, right=side == "right")),
                f"B7 differs from searchsorted, {name}, {side}")
            for v, k in MERGE_VARIANTS.items():  # what phase 5 times
                require(torch.equal(merge_probe(k, qr, qc, tr, tc, side),
                                    got),
                        f"B7's probe variant {v} differs, {name}, {side}")
    torch.cuda.synchronize()
    return list(cases)


def sym_kernel_checks(fem, rng, dev):
    """Phase 3 for B9 on the streams that break its shapes (``sym_stream``:
    the arrow matrix with a column of 2^20 entries, a column starting at
    a tile's last item, runs of empty columns with sentinel rows and a
    padded tail), both shapes, float32 and float64: ``up`` and ``ct`` bit
    for bit on integer-valued data, ``up`` bit for bit and ``ct`` bit for
    bit from call to call on random data, ``ct`` there within C_SEG eps
    of each column's sum|terms| of the exact sum.  Returns the largest
    error over eps sum|terms| per stream, shape and dtype."""
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import (SYM_TILE, sym_shape,
                                                  sym_streams_ref)

    out = {}
    for kind in ("arrow", "tile_edge", "empty_runs"):
        rows_h, indptr_h, M = sym_stream(kind, SYM_TILE, rng)
        rows = torch.from_numpy(rows_h).to(dev)
        indptr = torch.from_numpy(indptr_h).to(dev)
        nz = rows.numel()
        for dtype, eps in ((torch.float32, EPS32), (torch.float64, EPS64)):
            def draw(k, ints):
                v = rng.integers(-8, 9, k) if ints else \
                    rng.standard_normal(k)
                return torch.from_numpy(v).to(dev, dtype)

            sti = (rows, draw(nz, True), indptr)
            xi = draw(M, True)
            stf = (rows, draw(nz, False), indptr)
            x = draw(M, False)
            # a longest column of 1 takes one thread a column (these
            # streams hold at most 4 slots a column on average), an unknown
            # one the tiles, whatever the stream
            require(sym_shape(1, M, nz) == "columns",
                    f"{kind} takes the tiles whatever its longest column")
            for shape, hint in (("columns", 1), ("tiles", None)):
                kw = dict(longest=hint)
                for got, want in zip(sym_mod.sym_streams(*sti, xi, **kw),
                                     sym_streams_ref(*sti, xi)):
                    require(torch.equal(got, want), f"B9 ({shape}) differs on "
                            f"integer-valued data, {kind}, {dtype}")
                up, ct = sym_mod.sym_streams(*stf, x, **kw)
                up0, _ = sym_streams_ref(*stf, x)
                require(torch.equal(up, up0),
                        f"B9's up ({shape}) differs, {kind}, {dtype}")
                require(torch.equal(sym_mod.sym_streams(*stf, x, **kw)[1],
                                    ct), f"B9's ct ({shape}) differs from "
                        f"call to call, {kind}, {dtype}")
                r = sym_err_over_eps(ct, *stf, x, eps)
                require(r <= C_SEG, f"B9's ct ({shape}) {dtype} error {r} "
                        f"eps x sum|terms| > {C_SEG}, {kind}")
                out[f"{kind}_{shape}_{dtype}"] = r
            if dtype == torch.float32:  # what phase 5 times
                want = sym_streams_ref(*sti, xi)
                for v, k in SYM_VARIANTS.items():
                    require(all(torch.equal(a, b) for a, b in zip(
                        sym_probe(k, *sti, xi), want)),
                        f"B9's probe variant {v} differs, {kind}")
        del rows, indptr, sti, stf, x, up, ct, up0
    torch.cuda.synchronize()
    return out


def sym_times(fem, cpm, dev):
    """Phase 5 for B9 beside the design it replaced (``sym_probe``, with
    the zeroing of ``up`` its wrapper did) and the probe's other tile
    depths, on the FEM matrix's SymCSC stream, on the arrow matrix and on
    a stream of as many slots in short columns (``sym_stream``), float32;
    device ms, back to back."""
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import SYM_TILE

    S, x = fem["S"], fem["x"]
    streams = {"fem": (S.indices, S.data, S.indptr, x)}
    g = np.random.default_rng([SEED, 9])
    for kind in ("arrow", "short"):
        rows_h, indptr_h, M = sym_stream(kind, SYM_TILE, g)
        streams[kind] = (
            torch.from_numpy(rows_h).to(dev),
            torch.from_numpy(g.standard_normal(rows_h.size).astype(
                np.float32)).to(dev),
            torch.from_numpy(indptr_h).to(dev),
            torch.from_numpy(g.standard_normal(M).astype(np.float32)).to(dev))
    t = {"times": "B9 streams"}
    for name, st in streams.items():
        M, nz = st[3].numel(), st[1].numel()
        longest = int(torch.diff(st[2]).max())
        row = {"M": M, "nzmax": nz, "longest_column": longest,
               "ms": device_ms(lambda: sym_mod.sym_streams(
                   *st, longest=longest), cpm)}
        for v, k in SYM_VARIANTS.items():
            # on the arrow matrix the shapes that walk a column on one
            # thread or one warp take 20-150 ms a call: a few calls
            slow = name == "arrow" and v in ("replaced", "groups", "columns")
            row[f"{v}_ms"] = device_ms(lambda: sym_probe(k, *st), cpm,
                                       reps=3 if slow else REPS)
        row["bound_ms"], _ = bound_ms(12 * nz + 12 * M + 4, 3 * nz)
        t[name] = row
    return t


def update_times(sets, fem, ctx, cpm, dev):
    """Phase 5 for the fourth path: per set and delta share the update
    against a re-plan of the whole set (device and call time), the
    update split into delta sort, B7, materialisation and Parts 3-4;
    ``sparse2_update`` of the edge flip on the host clock; the
    symmetric plan against the full plan and their refills; B7 at both
    call sites against its plain version and ``torch.searchsorted``
    (packing apart).  Returns (B7's kernel row, the path's times)."""
    from repro_torch.core.coo import host_triplets
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import merge_search_ref
    from repro_torch.sparse import (pattern_symmetric, plan,
                                    plan_cache_clear, plan_lookup,
                                    plan_symmetric, sparse2_update)
    from repro_torch.sparse.dispatch import merge_search, sorted_permutation
    from repro_torch.sparse.pattern import _merge_gather, pattern_from_sorted

    t = {"times": "fourth path"}
    for name, (ii, jj, ss, siz) in sets.items():
        r_h, c_h, _, _ = host_triplets(ii, jj, ss, (siz, siz))
        r, c = torch.from_numpy(r_h).to(dev), torch.from_numpy(c_h).to(dev)
        del r_h, c_h
        L = r.shape[0]
        u = {"L": L}
        u["replan_ms"] = call_ms(lambda: plan(r, c, (siz, siz)))
        u["replan_device_ms"] = device_ms(lambda: plan(r, c, (siz, siz)),
                                          cpm)
        for frac in UPDATE_FRACS:
            Ld = round(frac * L)
            Lb = L - Ld
            base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
            rd, cd = r[Lb:], c[Lb:]
            f = f"_{frac}"
            fn = lambda: base.update(rd, cd)  # noqa: E731
            u["update" + f + "_ms"] = call_ms(fn)
            u["update" + f + "_device_ms"] = device_ms(fn, cpm)
            u["update" + f + "_device_idle_share"] = \
                1.0 - u["update" + f + "_device_ms"] / u["update" + f + "_ms"]
            u["replan_over_update" + f + "_device"] = \
                u["replan_device_ms"] / u["update" + f + "_device_ms"]
            u["replan_over_update" + f + "_call"] = \
                u["replan_ms"] / u["update" + f + "_ms"]
            # the split: the same steps as _merge_sorted_streams
            d = sorted_permutation(rd, cd, M=siz, N=siz)
            qr, qc = rd[d.long()], cd[d.long()]
            pb = d + Lb
            off = merge_search(qr, qc, base.srows, base.scols, side="right")
            r_m, c_m, p_m = _merge_gather(base.srows, base.scols, base.perm,
                                          qr, qc, pb, off)
            steps = {
                "delta_sort": lambda: sorted_permutation(rd, cd, M=siz,
                                                         N=siz),
                "B7": lambda: merge_search(qr, qc, base.srows, base.scols,
                                           side="right"),
                "materialise": lambda: _merge_gather(
                    base.srows, base.scols, base.perm, qr, qc, pb, off),
                "parts34": lambda: pattern_from_sorted(
                    r_m, c_m, p_m, M=siz, N=siz, nzmax=L),
            }
            for k, step in steps.items():
                u[f"update{f}_{k}_device_ms"] = device_ms(step, cpm)
            del base, d, qr, qc, pb, off, r_m, c_m, p_m, steps, fn
            torch.cuda.empty_cache()
        t[f"set_{name}"] = u
        del r, c
        torch.cuda.empty_cache()
    # -- the FEM edge flip and symmetric planning
    rows_f, cols_f, vals_f = fem["host"]
    nv, pat, vals_d = fem["nv"], fem["pat"], fem["vals_d"]
    drop, (ar, ac, av) = edge_flip(FEM_N, np.random.default_rng(SEED))
    base_args = (rows_f + 1, cols_f + 1, vals_f)
    times = []
    for _ in range(3):
        plan_cache_clear()
        plan_lookup(*base_args, (nv, nv))     # the base, cached
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sparse2_update(*base_args, ar + 1, ac + 1, av, (nv, nv),
                       drop_mask=drop)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t["sparse2_update_flip_ms"] = float(np.median(times))
    plan_cache_clear()
    t["sparse2_miss_fem_ms"] = host_ms(
        lambda: (plan_cache_clear(), plan_lookup(*base_args, (nv, nv))), 3)
    plan_cache_clear()
    t["pattern_symmetric_ms"] = call_ms(lambda: pattern_symmetric(pat), 5)
    t["plan_symmetric_ms"] = host_ms(
        lambda: plan_symmetric(rows_f, cols_f, (nv, nv), device=dev), 3)
    t["plan_A_host_ms"] = host_ms(
        lambda: plan(fem["rows_d"], fem["cols_d"], (nv, nv)), 3)
    up = rows_f < cols_f
    ru, cu = (torch.from_numpy(a[up]).to(dev) for a in (rows_f, cols_f))
    t["plan_upper_device_ms"] = device_ms(lambda: plan(ru, cu, (nv, nv)),
                                          cpm)
    t["plan_A_device_ms"] = device_ms(
        lambda: plan(fem["rows_d"], fem["cols_d"], (nv, nv)), cpm)
    spat = plan_symmetric(rows_f, cols_f, (nv, nv), device=dev)
    for what, fn in (("sym_refill", lambda: spat.assemble(vals_d)),
                     ("fill_A", lambda: pat.assemble(vals_d))):
        t[f"{what}_ms"] = call_ms(fn)
        t[f"{what}_device_ms"] = device_ms(fn, cpm)
    del spat, ru, cu
    # -- B7 at both call sites
    sites = {}
    sr_a, sc_a, ar1, ac1, siz = ctx[f"update_{UPDATE_FRACS[0]}"]
    d = sorted_permutation(ar1, ac1, M=siz, N=siz).long()
    sites["update"] = (ar1[d], ac1[d], sr_a, sc_a, siz, ("right",))
    qr, qc, tr, tc = ctx["symmetric"]
    sites["symmetric"] = (qr, qc, tr, tc, nv, ("left", "right"))
    rows_k = {}
    for site, (qr, qc, tr, tc, Mk, sides) in sites.items():
        Lq, n = qr.shape[0], tr.shape[0]
        for side in sides:
            key = tc.long() * (Mk + 1) + tr.long()
            qkey = qc.long() * (Mk + 1) + qr.long()
            right = side == "right"
            reached = ladder_reach(qr, qc, tr, tc, side)
            nbytes = 12 * Lq + 8 * reached
            r = {"Lq": Lq, "n": n, "side": side,
                 "ms": device_ms(lambda: mg.merge_search_kernel(
                     qr, qc, tr, tc, side=side), cpm),
                 "call_ms": call_ms(lambda: mg.merge_search_kernel(
                     qr, qc, tr, tc, side=side)),
                 "plain_ms": device_ms(lambda: merge_search_ref(
                     qr, qc, tr, tc, side=side), cpm),
                 # like for like: searchsorted needs both streams packed
                 # into int64 keys, so the packing is timed with it
                 "library_ms": device_ms(lambda: torch.searchsorted(
                     tc.long() * (Mk + 1) + tr.long(),
                     qc.long() * (Mk + 1) + qr.long(), right=right), cpm),
                 "searchsorted_alone_ms": device_ms(
                     lambda: torch.searchsorted(key, qkey, right=right),
                     cpm),
                 "pack_ms": device_ms(lambda: (
                     tc.long() * (Mk + 1) + tr.long(),
                     qc.long() * (Mk + 1) + qr.long()), cpm),
                 **{f"{v}_ms": device_ms(lambda: merge_probe(
                     k, qr, qc, tr, tc, side), cpm)
                    for v, k in MERGE_VARIANTS.items()},
                 "targets_reached": reached, "bytes": nbytes, "ops": 0,
                 "bound_all_targets_ms": (12 * Lq + 8 * n)
                 / HBM_BYTES_PER_S * 1e3}
            r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 0)
            r["GBps"] = nbytes / r["ms"] / 1e6
            r["share_of_3.35TBps"] = r["GBps"] / (HBM_BYTES_PER_S / 1e9)
            rows_k[f"{site}_{side}"] = r
            del key, qkey
    t["B7"] = rows_k
    return rows_k["update_right"], t


#: phase 4e: the plan and fill call ms on sets 1-3 before the policy
#: layer (NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5), printed
#: beside this run's
CALL_MS_BEFORE = {"1": (0.9400, 0.1146), "2": (1.097, 0.09291),
                 "3": (1.437, 0.1076)}
#: phase 4e's time limit, in seconds
PHASE_4E_LIMIT_S = 90
#: host calls timed for one memoised resolve_policy
RESOLVE_CALLS = 100_000


def priors_match_builds() -> dict:
    """Phase 4e: every family resolved on ``cuda`` (an empty table: the
    priors) and each build-time prior against what its library exports."""
    from repro_torch.kernels.common import bind, load_library
    from repro_torch.sparse import tuning

    def export(lib: str, fn: str) -> int:
        return int(bind(load_library(lib), fn, [])())

    for fam in tuning.registered_families():
        require(tuning.resolve_policy(fam, backend="cuda")
                == tuning.prior_policy(fam, "cuda"),
                f"{fam} does not resolve to its priors on cuda")
    rk, sk, mk, ck, yk = (tuning.build_knobs(f) for f in (
        "radix_sort", "segment_sum", "merge", "counting_sort", "spmv_sym"))
    pairs = {
        "radix_sort.tile": (rk["tile"], export("radix_sort", "radix_tile")),
        "radix_sort.kernel_max_bits": (1 << rk["kernel_max_bits"], export(
            "radix_sort", "radix_max_bins")),
        "segment_sum.seg_per": (sk["threads"] * sk["seg_per"], export(
            "segment_sum", "segment_tile")),
        "segment_sum.sum2_per": (sk["threads"] * sk["sum2_per"], export(
            "segment_sum", "product_tile")),
        "segment_sum.scan_per": (sk["threads"] * sk["scan_per"], export(
            "segment_sum", "scan_tile")),
        "merge.block_q": (mk["block_q"], export("merge",
                                                "merge_block_queries")),
        "merge.splitters": (mk["splitters"], export("merge",
                                                    "merge_splitters")),
        "counting_sort.place_tile": (ck["place_tile"], export(
            "counting_sort", "placement_tile")),
        "spmv.block_r": (tuning.build_knobs("spmv")["block_r"], export(
            "spmv", "spmv_block_rows")),
        "spmv_sym.sym_per": (yk["threads"] * yk["sym_per"], export(
            "spmv_sym", "sym_tile")),
    }
    for k, (want, got) in pairs.items():
        require(want == got, f"build-time prior {k}: the registry gives "
                f"{want}, the library {got}")
    return {k: got for k, (_, got) in pairs.items()}


def loaded_table_check(fingerprint: str, n_entries: int,
                       reach: str) -> None:
    """Phase 4e's child process: the table of the sweep, loaded through
    ``REPRO_TUNING_CACHE_DIR``, steers each recorded family's call site
    to the sweep's winner (``reach``: a JSON list of the recorded
    families' dataset sizes and winning decisions) and ``fsparse`` on
    sets 1-3, each bit for bit against the oracle."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.sparse import fsparse, tuning
    from repro_torch.sparse.analysis import validate_tuning_table
    from repro_torch.sparse.tuning.measure import decision

    table = tuning.get_table()
    require(tuning.default_cache_path() is not None
            and table.fingerprint() == fingerprint
            and len(table) == n_entries,
            f"the loaded table ({len(table)} entries, "
            f"{table.fingerprint()}) is not the sweep's ({n_entries}, "
            f"{fingerprint})")
    validate_tuning_table(table)
    won = json.loads(Path(reach).read_text())
    require(len(won) == n_entries, f"{len(won)} winners for {n_entries} "
            "entries")
    for w in won:
        got = decision(w["family"], w["dims"], None, "cuda")
        require(got == w["decision"], f"the loaded {w['family']} entry "
                f"steers its call site to {got}, not the sweep's "
                f"{w['decision']}")
    out = {"loaded_table": fingerprint, "entries": n_entries,
           "call_sites_reached": [f"{w['family']}: {w['decision']}"
                                  for w in won], "sets": {}}
    for k, cfg in DATA_SETS.items():
        ii, jj, ss, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                    seed=SEED)
        S = fsparse(ii, jj, ss, (siz, siz))
        pr, ir, jc = matlab_sparse_oracle(ii - 1, jj - 1, ss, siz, siz)
        nnz = pr.shape[0]
        require(int(S.nnz) == nnz
                and np.array_equal(S.indptr.cpu().numpy(), jc)
                and np.array_equal(S.indices[:nnz].cpu().numpy(), ir)
                and np.array_equal(S.data[:nnz].cpu().numpy(),
                                   pr.astype(np.float32)),
                f"fsparse under the loaded table differs from the oracle, "
                f"set {k}")
        pol = {f: tuning.resolve_policy(f, backend="cuda", M=siz, N=siz,
                                        L=ii.shape[0])
               for f in ("plan", "radix_sort")}
        out["sets"][str(k)] = {
            "plan_method": pol["plan"]["method"],
            "radix_max_bits": pol["radix_sort"]["max_bits"],
            "fsparse": "bit-identical to oracle"}
    emit(out)


def policy_phase(dev, sets, fem, kernels, refill, smi_line) -> dict:
    """Phase 4e: the policy and analysis layers on the card (the module
    docstring); returns the phase's launch counts."""
    import os
    import shutil
    import tempfile

    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.sparse import (convert, plan, plan_coo, plan_symmetric,
                                    tuning, validate_matrix,
                                    validate_pattern)
    from repro_torch.sparse.analysis import (audit_default_paths,
                                             invariants,
                                             validate_tuning_table)
    from repro_torch.sparse.analysis.vmem import (check_report, dump_json,
                                                  format_table, vmem_report)
    from repro_torch.sparse.tuning.__main__ import main as tuning_cli
    from repro_torch.sparse.tuning.__main__ import run_measure
    from repro_torch.sparse.tuning.measure import (MEASURABLE_FAMILIES,
                                                   make_dataset)

    t_phase = time.perf_counter()
    require(os.environ.get("REPRO_TUNING_CACHE_DIR") is None,
            "phase 4e runs under the priors: unset REPRO_TUNING_CACHE_DIR")
    tuning.set_table(tuning.TuningTable())
    row = {"phase": "4e", "card": smi_line,
           "build_time_priors": priors_match_builds()}
    # the resource report, measured, against its declared columns
    report = vmem_report()
    print(f"resource report ({smi_line}):\n{format_table(report)}",
          flush=True)
    bad = check_report(report)
    require(not bad, "resource report: " + "; ".join(bad))
    # the autotuner's prior-only mode consumes every row of it
    with tempfile.TemporaryDirectory(prefix="repro-report-") as tmp:
        dump_json(report, f"{tmp}/report.json")
        require(tuning_cli(["--prior-only", "--vmem-report",
                            f"{tmp}/report.json", "--json",
                            f"{tmp}/table.json"]) == 0,
                "--prior-only did not consume the resource report")
        artifact = json.loads(Path(f"{tmp}/table.json").read_text())
    require(artifact["consumed_vmem_rows"] == len(report)
            and artifact["fingerprint"] == "prior",
            f"--prior-only consumed {artifact['consumed_vmem_rows']} of "
            f"{len(report)} rows")
    row["resource_report"] = [
        {k: r[k] for k in ("kernel", "name", "threads", "registers",
                           "max_registers", "spill_bytes", "static_smem",
                           "static_smem_measured", "dynamic_smem",
                           "blocks_per_sm")} for r in report]
    for f in kernels.values():
        f.launches = 0
    # the sweep: set 1 at 2.5e6 for every family, the 5e7 set for plan;
    # every candidate held against the prior's output
    t0 = time.perf_counter()
    on_set1 = tuple(f for f in MEASURABLE_FAMILIES if f != "spmv_sym")
    d1 = make_dataset(triplets=sets["1"], families=on_set1)
    d5 = make_dataset(triplets=sets["2x20"], families=("plan",))
    # B9 on the FEM SymCSC: about 3 slots a column, so the candidates of
    # short_mean fall on both sides of its cut-off (set 1 has about 25 a
    # column: every candidate would take the tiles)
    rows_f, cols_f, vals_f = fem["host"]
    dF = make_dataset(triplets=(rows_f + 1, cols_f + 1, vals_f, fem["nv"]),
                      sym=fem["S"], families=("spmv_sym",))
    results = run_measure(
        datasets=[(d1, on_set1), (d5, ("plan",)), (dF, ("spmv_sym",))],
        log=lambda s: print(f"sweep: {s}", flush=True))
    del d1, d5, dF
    require({r["family"] for r in results} == set(MEASURABLE_FAMILIES),
            "the sweep missed a family")
    require(all(len(r["candidates"]) > 1 for r in results),
            "the sweep timed no alternative for some family")
    table = tuning.get_table()
    require(validate_tuning_table(table) == len(table), "the swept table "
            "does not validate")
    cache = tempfile.mkdtemp(prefix="repro-tuning-")
    try:
        table.save(Path(cache) / tuning.TABLE_FILENAME)
        fp, n = table.fingerprint(), len(table)
        row["sweep"] = {
            "s": time.perf_counter() - t0, "fingerprint": fp, "entries": n,
            "chosen": table.entries(),
            "families": [{k: r[k] for k in ("family", "L", "prior_ms",
                                            "best_ms", "gain", "recorded",
                                            "key")}
                         | {"best": {k: v for k, v in r["best"].items()
                                     if v != r["prior"][k]},
                            "timed": len(r["candidates"])}
                         for r in results]}
        reach = Path(cache) / "reach.json"
        reach.write_text(json.dumps(
            [{k: r[k] for k in ("family", "dims", "decision")}
             for r in results if r["recorded"]]))
        # the table through REPRO_TUNING_CACHE_DIR in a fresh process
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--loaded-table-check", fp, str(n), str(reach)],
            env=dict(os.environ, REPRO_TUNING_CACHE_DIR=cache),
            capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, "the loaded-table check failed:\n"
                + proc.stdout[-2000:] + proc.stderr[-4000:])
        row["loaded_table"] = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    tuning.reset_table()  # the rest of the run: the priors
    require(tuning.tuning_fingerprint() == "prior", "priors not restored")
    # hot-path cost: one memoised resolution, the plan and fill calls
    ii, jj, _, siz = sets["1"]
    t0 = time.perf_counter()
    for _ in range(RESOLVE_CALLS):
        tuning.resolve_policy("plan", backend="cuda", M=siz, N=siz,
                              L=ii.shape[0])
    row["resolve_policy_host_us"] = \
        (time.perf_counter() - t0) / RESOLVE_CALLS * 1e6
    calls = {}
    for name in ("1", "2", "3"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        pat = plan_coo(coo)
        v = torch.from_numpy(refill[name]).to(dev)
        calls[name] = {"plan_ms": call_ms(lambda: plan_coo(coo)),
                       "fill_ms": call_ms(lambda: pat.assemble(v)),
                       "before_policy_layer_ms": CALL_MS_BEFORE[name]}
    row["hot_path"] = calls
    # validators on the structures phases 4-4d built (the FEM path's
    # plans, products and formats; the plans of sets 1 and 2x20), a
    # SymPattern, and one update under REPRO_VALIDATE=1
    checked = []
    for name in ("1", "2x20"):
        ii, jj, ss, siz = sets[name]
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        pat = validate_pattern(plan_coo(coo))
        validate_matrix(pat.assemble(coo.vals))
        checked += [f"SparsePattern, CSC (set {name})"]
    A = fem["A"]
    for label, obj in (("pat", fem["pat"]), ("pp1", fem["pp1"]),
                       ("pp2", fem["pp2"])):
        validate_pattern(obj, subject=f"FEM {label}")
    for label, obj in (("A", A), ("S", fem["S"]), ("Bm", fem["Bm"]),
                       ("P", fem["P"]), ("Ptc", fem["Ptc"]),
                       ("PtA", fem["PtA"]), ("CSR", convert(A, "csr")),
                       ("COO", convert(A, "coo"))):
        validate_matrix(obj, subject=f"FEM {label}")
    r_s, c_s, _, nv_s, _, _ = fem_system(199)
    validate_pattern(plan_symmetric(r_s, c_s, (nv_s, nv_s)))
    checked += ["FEM: SparsePattern, 2 ProductPattern, CSC x4, SymCSC, "
                "BSR, CSR, COO", "SymPattern (199 x 199 cells)"]
    ii, jj, ss, siz = sets["1"]
    r = torch.from_numpy(ii - 1).to(dev, torch.int32)
    c = torch.from_numpy(jj - 1).to(dev, torch.int32)
    L = r.shape[0]
    Lb = L - L // 100
    base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
    seen = []
    real = invariants.validate_pattern
    invariants.validate_pattern = \
        lambda p, subject=None: seen.append(subject) or real(p,
                                                             subject=subject)
    os.environ["REPRO_VALIDATE"] = "1"
    try:
        got = base.update(r[Lb:], c[Lb:])
    finally:
        del os.environ["REPRO_VALIDATE"]
        invariants.validate_pattern = real
    require(seen == ["SparsePattern.update"], f"the update under "
            f"REPRO_VALIDATE=1 validated {seen}")
    full = plan(r, c, (siz, siz))
    require(all(torch.equal(getattr(got, f), getattr(full, f)) for f in (
        "perm", "slot", "indices", "indptr", "nnz")),
        "the validated update differs from the plan of the whole set")
    checked.append("update of set 1 (1%) under REPRO_VALIDATE=1")
    row["validators"] = checked
    # the contract audit on CUDA tensors
    reports = audit_default_paths()
    row["contracts"] = {"paths": [x["name"] for x in reports],
                        "verdict": "clean"}
    launches = {k: f.launches for k, f in kernels.items()}
    row["launches"] = launches
    for k, n in launches.items():
        require(n > 0, f"kernel {k} never launched on phase 4e's path")
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4E_LIMIT_S,
            f"phase 4e took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4E_LIMIT_S} s")
    return launches


#: phase 4f's time limit, in seconds
PHASE_4F_LIMIT_S = 90
#: phase 4f's warm regime (``benchmarks/bench_serving.py``'s): threads,
#: requests a thread per set, and the value scales the requests cycle
#: through (the sets' values are ones, so every scaled result is exact)
SERVE_THREADS, SERVE_REQUESTS = 4, 8
SERVE_SCALES = (1.0, 2.0, 3.0, 4.0)


def csc_digest(A) -> str:
    """sha256 of a CSC's ``indptr``, ``indices`` and ``data`` bytes."""
    h = hashlib.sha256()
    for t in (A.indptr, A.indices, A.data):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def serving_restart_check(cache_dir: str) -> None:
    """Phase 4f's child process: a ``PlanService`` pointed at the parent's
    ``cache_dir`` loads its plans, re-plans nothing and times its first
    request per set; prints the digests of the results for the parent
    to hold against phase 4's oracle-checked ones."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.sparse import PlanService, plan_cache_info

    t0 = time.perf_counter()
    svc = PlanService(cache_dir=cache_dir)
    torch.cuda.synchronize()
    out = {"loaded_plans": svc.loaded_plans,
           "load_ms": (time.perf_counter() - t0) * 1e3,
           "first_request_ms": {}, "digest": {}}
    for k, cfg in DATA_SETS.items():
        ii, jj, ss, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                    seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = svc.assemble(ii, jj, ss, (siz, siz))
        torch.cuda.synchronize()
        out["first_request_ms"][str(k)] = (time.perf_counter() - t0) * 1e3
        out["digest"][str(k)] = csc_digest(A)
    out["plan_misses"] = plan_cache_info()["misses"]
    out["graphs"] = svc.stats()["graphs"]
    emit(out)


def _kernel_names(fn) -> list:
    """The CUDA kernels ``torch.profiler`` saw in one call of ``fn()``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.self_device_time_total > 0})


def serving_phase(dev, sets, fem, verified, kernels, cpm,
                  smi_line) -> dict:
    """Phase 4f: the plan service and its CUDA-graph tier (the module
    docstring); returns the phase's launch counts.  The service persists
    into a temporary ``cache_dir``, removed at the end."""
    import shutil
    import tempfile

    cache = tempfile.mkdtemp(prefix="repro-serve-")
    try:
        return _serving_phase(dev, sets, fem, verified, kernels, cpm,
                              smi_line, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def _serving_phase(dev, sets, fem, verified, kernels, cpm, smi_line,
                   cache) -> dict:
    import dataclasses
    import gc
    import threading

    from repro_torch.sparse import (PlanService, convert, fsparse, ops,
                                    plan_cache_clear, plan_cache_info,
                                    sparse2)
    from repro_torch.sparse.analysis import audit_retraces
    from repro_torch.sparse.analysis.contracts import audit_trace, record_ops
    from repro_torch.sparse.errors import InvariantViolation
    from repro_torch.sparse.matlab import plan_lookup
    from repro_torch.sparse.serving import _SPMV_NUMERIC_FIELDS
    from repro_torch.sparse.spgemm import _structure_key

    t_phase = time.perf_counter()
    row = {"phase": "4f", "card": smi_line}
    plan_cache_clear()
    for f in kernels.values():
        f.launches = 0
    names = ("1", "2", "3")
    torch.cuda.synchronize()
    mem = {"phase_start": torch.cuda.memory_reserved() / 2**20}
    svc = PlanService(cache_dir=cache)
    require(svc.stats()["graph_mode"] == "cuda-graph",
            "the service does not capture on the card")
    # uncached results per set and value scale: each scale is the
    # oracle-checked result of phase 4 times the scale, exactly
    want = {}
    for name in names:
        ii, jj, ss, siz = sets[name]
        base = fsparse(ii, jj, ss, (siz, siz))
        require(csc_digest(base) == verified[name], "uncached fsparse "
                f"differs from phase 4's, set {name}")
        require(float(base.data.max()) * max(SERVE_SCALES) < 2**24,
                "scaled sums past 2^24")
        want[name] = {k: fsparse(ii, jj, ss * k, (siz, siz)).data
                      for k in SERVE_SCALES}
        for k, d in want[name].items():
            require(torch.equal(d, k * base.data), f"fsparse of the "
                    f"values times {k} is not the oracle's, set {name}")
    # -- cold: the first request of each set (plan, persist, capture)
    cold = {}
    for name in names:
        ii, jj, ss, siz = sets[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = svc.assemble(ii, jj, ss, (siz, siz))
        torch.cuda.synchronize()
        cold[name] = (time.perf_counter() - t0) * 1e3
        require(csc_digest(A) == verified[name], "the cold request "
                f"differs from the oracle, set {name}")
    row["cold_ms"] = cold
    # -- warm: threads x requests per set, every result bit for bit
    lat = {name: [[] for _ in range(SERVE_THREADS)] for name in names}
    errors = []

    def worker(t):
        try:
            for name in names:
                ii, jj, ss, siz = sets[name]
                for r in range(SERVE_REQUESTS):
                    k = SERVE_SCALES[(t + r) % len(SERVE_SCALES)]
                    t0 = time.perf_counter()
                    A = svc.assemble(ii, jj, ss * k, (siz, siz))
                    torch.cuda.current_stream().synchronize()
                    lat[name][t].append(
                        (time.perf_counter() - t0) * 1e3)
                    if not torch.equal(A.data, want[name][k]):
                        errors.append(f"set {name}, scale {k}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    warm_s = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a warm thread hung")
    require(not errors, f"warm requests differ: {errors[:5]}")
    row["warm"] = {"threads": SERVE_THREADS,
                   "requests_per_thread_per_set": SERVE_REQUESTS,
                   "requests_per_s": SERVE_THREADS * SERVE_REQUESTS
                   * len(names) / warm_s}
    for name in names:
        ms = np.concatenate(lat[name])
        row["warm"][name] = {"p50_ms": float(np.percentile(ms, 50)),
                             "p99_ms": float(np.percentile(ms, 99))}
    torch.cuda.synchronize()
    mem["with_3_fill_graphs"] = torch.cuda.memory_reserved() / 2**20
    st = svc.stats()
    require(st["graphs"]["captures"] == {"fill": 3}
            and st["plan"]["misses"] == 3,
            f"warm requests captured or planned again: {st}")
    # -- restart: a child process on the same cache_dir
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()),
         "--serving-restart-check", cache],
        capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, "the restart child failed:\n"
            + proc.stdout[-2000:] + proc.stderr[-4000:])
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    require(child["loaded_plans"] >= 3 and child["plan_misses"] == 0,
            f"the restart re-planned: {child}")
    for name in names:
        require(child["digest"][name] == verified[name],
                f"the restarted service differs, set {name}")
    row["restart"] = {k: child[k] for k in (
        "loaded_plans", "plan_misses", "load_ms", "first_request_ms",
        "graphs")}
    row["persisted_MB"] = sum(
        p.stat().st_size for p in Path(cache).glob("*.pkl")) / 2**20
    # -- one accum="max" request: B4 captured
    ii, jj, ss, siz = sets["1"]
    vr = np.random.default_rng([SEED, 6]).standard_normal(
        ii.shape[0]).astype(np.float32)
    require(torch.equal(svc.assemble(ii, jj, vr, (siz, siz),
                                     accum="max").data,
                        sparse2(ii, jj, vr, (siz, siz), accum="max").data),
            "the captured max fill differs from sparse2")

    # -- replay against eager: the fill at sets 1-3 (float32 and float64,
    #    bit for bit), as a caller pays it and on the device
    rng = np.random.default_rng([SEED, 5])
    rep = {}
    for name in names:
        ii, jj, ss, siz = sets[name]
        key, pat, _ = plan_lookup(ii, jj, ss, (siz, siz))
        r = {}
        for dtype in (torch.float32, torch.float64):
            v = torch.from_numpy(rng.standard_normal(pat.L)).to(dev, dtype)
            got = svc._fill(key, pat, v)
            require(torch.equal(got, pat.scatter(v)), f"the {dtype} fill "
                    f"replay differs from eager, set {name}")
        v = torch.from_numpy(rng.standard_normal(pat.L)
                             .astype(np.float32)).to(dev)
        for what, fn in (("replay", lambda: svc._fill(key, pat, v)),
                         ("eager", lambda: pat.scatter(v))):
            r[f"{what}_ms"] = call_ms(fn)
            r[f"{what}_device_ms"] = device_ms(fn, cpm)
        rep[f"fill_{name}"] = r
    # the SpMV in four formats on the FEM matrix: within 8 eps sum|a x|
    # of eager on random x, bit for bit on integer-valued operands; on a
    # service with no cache_dir (the product plan of P' A is 0.5 GB)
    fsvc = PlanService()
    A, x = fem["A"], fem["x"]
    absA = dataclasses.replace(A, data=A.data.abs())
    tol = 8 * EPS32 * ops.matmul(absA, x.abs())
    xi = torch.from_numpy(rng.integers(-3, 4, x.shape[0]).astype(
        np.float32)).to(dev)
    fmts = {"csc": A, "csr": convert(A, "csr"), "symcsc": fem["S"],
            "bsr": fem["Bm"]}
    spmv_err = {}
    for fmt, F in fmts.items():
        y = fsvc.spmv(F, x)
        err = (y - ops.matmul(F, x)).abs()
        require(bool(torch.all(err <= tol)), f"the {fmt} spmv replay is "
                "not within 8 eps sum|a x| of eager")
        spmv_err[fmt] = float((err / tol.clamp(min=1e-30)).max())
        Fi = dataclasses.replace(F, **{
            f: torch.round(4 * getattr(F, f))
            for f in _SPMV_NUMERIC_FIELDS[type(F).__name__]})
        require(torch.equal(fsvc.spmv(Fi, xi), ops.matmul(Fi, xi)),
                f"the {fmt} spmv replay differs on integer-valued data")
        r = {}
        for what, fn in (("replay", lambda: fsvc.spmv(F, x)),
                         ("eager", lambda: ops.matmul(F, x))):
            r[f"{what}_ms"] = call_ms(fn)
            r[f"{what}_device_ms"] = device_ms(fn, cpm)
        rep[f"spmv_{fmt}"] = r
    row["spmv_max_err_over_tol"] = spmv_err
    # one CG iteration on the SymCSC operator through the service
    S, b = fem["S"], fem["b"]
    _, res_r = cg(lambda v: fsvc.spmv(S, v), b, 10)
    _, res_e = cg(lambda v: ops.matmul(S, v), b, 10)
    require(abs(float(res_r) - float(res_e)) <= 1e-3 * float(res_e) + 1e-6,
            f"CG through the service: residual {float(res_r)} against "
            f"{float(res_e)} eager")
    rep["cg_iteration_symcsc"] = {
        "replay_ms": call_ms(lambda: cg(lambda v: fsvc.spmv(S, v), b, 10),
                             reps=5) / 10,
        "eager_ms": call_ms(lambda: cg(lambda v: ops.matmul(S, v), b, 10),
                            reps=5) / 10}
    # the product P' A (B6), float32 and float64, bit for bit
    Ptc, pp1 = fem["Ptc"], fem["pp1"]
    for dtype in (torch.float32, torch.float64):
        P2 = dataclasses.replace(Ptc, data=Ptc.data.to(dtype))
        A2 = dataclasses.replace(A, data=A.data.to(dtype))
        require(torch.equal(fsvc.multiply(P2, A2).data,
                            pp1.multiply(P2.data, A2.data).data),
                f"the {dtype} multiply replay differs from eager")
    # the service's call keys both operands on the host (a copy of
    # their structures, which syncs), so its graph is also timed alone
    ex = next(e for k, e in fsvc._execs.items()
              if k[0] == "multiply" and k[2] == str(torch.float32))
    rep["multiply_PtA"] = {
        "service_call_ms": call_ms(lambda: fsvc.multiply(Ptc, A)),
        "replay_ms": call_ms(lambda: ex(Ptc.data, A.data)),
        "eager_ms": call_ms(lambda: pp1.multiply(Ptc.data, A.data)),
        "replay_device_ms": device_ms(lambda: ex(Ptc.data, A.data), cpm),
        "eager_device_ms": device_ms(
            lambda: pp1.multiply(Ptc.data, A.data), cpm),
        "product_key_host_ms": host_ms(
            lambda: (_structure_key(Ptc), _structure_key(A)), 5)}
    del ex
    torch.cuda.synchronize()
    mem["with_fem_graphs"] = torch.cuda.memory_reserved() / 2**20
    # the spmv key: the structure's bytes to the host, or the memo's hit
    rep["spmv_key"] = {"unmemoised_ms": host_ms(lambda: _structure_key(A),
                                                 REPS),
                       "memoised_ms": host_ms(
                           lambda: fsvc._structure_keys(A), REPS)}
    row["replay_vs_eager"] = rep
    # the contract audit over hits: no host sync and, on the card, no
    # copy to the host (an unmemoised key would copy its structure)
    hits = {"PlanService.assemble": lambda: svc.assemble(
        *sets["1"][:3], (sets["1"][3],) * 2).data,
        "PlanService.multiply": lambda: fsvc.multiply(Ptc, A).data,
        **{f"PlanService.spmv[{f}]": (lambda F=F: fsvc.spmv(F, x))
           for f, F in fmts.items()}}
    for name, fn in hits.items():
        fn()
        try:
            audit_trace(record_ops(fn), name=name)
        except InvariantViolation as e:
            fail(f"the contract audit over {name}: {e}")
    row["contract_audit"] = {"paths": list(hits), "verdict": "clean"}

    # -- update_structure of set 1: base the first 99%, delta the last 1%
    ii, jj, ss, siz = sets["1"]
    L = ii.shape[0]
    Lb = L - L // 100
    svc.assemble(ii[:Lb], jj[:Lb], ss[:Lb], (siz, siz), L)
    before = {k[:2] for k, _ in svc._execs.items()}
    caps = svc.stats()["graphs"]["captures"]["fill"]
    U = svc.update_structure(ii[:Lb], jj[:Lb], ss[:Lb], ii[Lb:], jj[Lb:],
                             ss[Lb:], (siz, siz), L)
    require(csc_digest(U) == verified["1"], "the update differs from a cold "
            "assemble of the whole set")
    after = {k[:2] for k, _ in svc._execs.items()}
    gone, new = before - after, after - before
    require(len(gone) == 1 and len(new) == 1
            and all(k[0] == "fill" for k in gone | new),
            f"the update purged {gone} and added {new}")
    require(svc.stats()["graphs"]["captures"]["fill"] == caps + 1,
            "the update captured more than its fill")
    row["update"] = {"purged": 1, "added": 1, "survived": len(after) - 1,
                     "result": "bit-identical to the oracle"}

    # -- assemble_many: 8 requests over sets 1 and 3, one graph a group
    order = [("1", 1.0), ("3", 1.0), ("1", 2.0), ("1", 3.0), ("3", 2.0),
             ("1", 4.0), ("3", 3.0), ("1", 1.0)]
    batch = PlanService()
    outs = batch.assemble_many([
        (sets[n][0], sets[n][1], sets[n][2] * k, (sets[n][3],) * 2)
        for n, k in order])
    for (n, k), got in zip(order, outs):
        one = svc.assemble(sets[n][0], sets[n][1], sets[n][2] * k,
                           (sets[n][3],) * 2)
        require(torch.equal(got.data, want[n][k])
                and torch.equal(got.data, one.data),
                f"assemble_many differs from per-request results ({n}, {k})")
    bst = batch.stats()
    require(bst["graphs"]["captures"] == {"fill": 2}
            and bst["exec"]["size"] == 2, f"assemble_many captured "
            f"{bst['graphs']}")
    row["assemble_many"] = {"requests": len(order), "groups": 2,
                            "captures": 2, "order": "request order, "
                            "bit-identical"}

    # -- the capture audit, and the kernels a replay runs
    row["audit_retraces"] = audit_retraces()
    key1, pat1, v1 = plan_lookup(*sets["1"][:3], (sets["1"][3],) * 2)
    fill_names = _kernel_names(lambda: svc._fill(key1, pat1, v1))
    sym_names = _kernel_names(lambda: fsvc.spmv(S, x))
    require(any("segment_reduce_kernel" in k and "Gather<" in k
                and "MinMax" not in k for k in fill_names),
            f"a fill replay ran no B3' kernel: {fill_names}")
    require(any("sym_threads_kernel" in k or "sym_streams_kernel" in k
                for k in sym_names),
            f"a SymCSC spmv replay ran no B9 kernel: {sym_names}")
    row["witness"] = {"fill_replay": [k[:90] for k in fill_names],
                      "symcsc_spmv_replay": [k[:90] for k in sym_names]}

    # -- no path fell back: every entry of both services holds a graph
    for service in (svc, fsvc, batch):
        require(all(ex.graph is not None
                    for _, ex in service._execs.items()),
                "an executable holds no graph")
    row["graphs"] = {"sets": svc.stats()["graphs"],
                     "fem": fsvc.stats()["graphs"]}
    torch.cuda.synchronize()
    mem["with_all_graphs"] = torch.cuda.memory_reserved() / 2**20
    svc._execs.clear()
    del fsvc, batch, outs
    gc.collect()
    torch.cuda.empty_cache()
    mem["graphs_evicted"] = torch.cuda.memory_reserved() / 2**20
    row["memory_reserved_MB"] = mem

    # -- the 5e7 set: one request and one replay, no threads
    ii, jj, ss, siz = sets["2x20"]
    big = PlanService()
    t = {}
    for what in ("cold", "replay"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A5 = big.assemble(ii, jj, ss, (siz, siz))
        torch.cuda.synchronize()
        t[f"{what}_ms"] = (time.perf_counter() - t0) * 1e3
        require(csc_digest(A5) == verified["2x20"], f"the {what} request "
                "differs from the oracle at 5e7")
    require(big.stats()["graphs"] == {"captures": {"fill": 1},
                                      "replays": {"fill": 2}},
            "the 5e7 requests did not replay one graph")
    row["set_2x20"] = t
    del big, A5
    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()

    launches = {k: f.launches for k, f in kernels.items()}
    row["launches"] = launches
    for k in ("B1", "B2", "B3", "B4", "B6", "B7", "B9", "B10"):
        require(launches[k] > 0, f"kernel {k} never launched on phase "
                "4f's path")
    row["plan_cache"] = plan_cache_info()
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    require(row["phase_s"] < PHASE_4F_LIMIT_S,
            f"phase 4f took {row['phase_s']:.1f} s, over its "
            f"{PHASE_4F_LIMIT_S} s")
    return launches


def main() -> None:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels import common
    from repro_torch.kernels.assembly_ops import fill_pallas
    from repro_torch.kernels.counting_sort import counting_sort as cs_mod
    from repro_torch.kernels.counting_sort.ref import placement_ref
    from repro_torch.kernels.hist import hist as hist_mod
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.kernels.hist.ref import block_histogram_ref
    from repro_torch.kernels.merge import merge as merge_mod
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ops import (digit_bases,
                                                    plan_digit_passes,
                                                    radix_sort_pair)
    from repro_torch.kernels.radix_sort.ref import (
        digit_block_histogram_ref, digit_placement_ref, radix_sort_pair_ref)
    from repro_torch.kernels.segment_sum import segment_sum as ss_mod
    from repro_torch.kernels.segment_sum.ref import (
        PRODUCT_TILE, blocked_cumsum_ref, gather_segment_minmax_ref,
        gather_segment_sum_ref)
    from repro_torch.kernels.spmv import spmv as ell_mod
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.sparse.matlab import (_cache_key, expand_indices,
                                           fsparse, plan_cache_clear,
                                           plan_cache_info, sparse2)
    from repro_torch.sparse.pattern import pattern_from_perm, plan_coo
    from repro_torch.core.coo import coo_from_matlab, host_triplets

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = nvidia_smi_line()
    print(f"device: {kind} (count {count}); {smi_line}", flush=True)
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = common.build(["radix_sort", "segment_sum", "hist",
                         "counting_sort", "spmv", "spmv_sym", "merge",
                         "segment_sum_probe", "merge_probe",
                         "spmv_sym_probe"])
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
    sum2_k = ss_mod.gather2_segment_sum
    ell_k, sym_k, bsr_k = (ell_mod.spmv_ell, sym_mod.sym_streams,
                           sym_mod.bsr_tiles)
    merge_k = merge_mod.merge_search_kernel
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

        def check_pass(i, p, args):
            keys, hist, base, perm, carry, kw, out = args
            require(torch.equal(hist, digit_block_histogram_ref(
                keys, tile=TILE, **kw)), f"B1 differs on set {name}, {p}")
            want = digit_placement_ref(keys, base, perm, carry=carry,
                                       tile=TILE, **kw)
            got, want = (((out,), (want,)) if not carry else
                         ((out[0], *out[1]), (want[0], *want[1])))
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"B2 (carrying {len(carry)} words) differs on set "
                    f"{name}, {p}")

        perm = radix_chain(rows, cols, siz, siz, check=check_pass)
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
              "B1": "bit-identical", "B2": "bit-identical, carried words "
              "included", "B3_integer": "bit-identical"})
        del coo, rows, cols, perm, pat, fill_args
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
            require(torch.equal(cplace_k(keys, offsets.clone(),
                                         consume_offsets=True, **kw), pos),
                    f"B11 on a handed-over table differs, set {name}")
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
        # zero-mean values, and same-sign ones (uniform in [0, 1)), whose
        # prefixes grow with L: the chained tile prefixes' error shows
        for (dtype, eps), (data, draw) in itertools.product(
                ((torch.float32, EPS32), (torch.float64, EPS64)),
                (("normal", rng.standard_normal), ("uniform", rng.random))):
            vn = torch.from_numpy(draw(L)).to(dev, dtype)
            x = torch.where(keep, vn[pat.perm], 0)
            got = scan_k(x)
            require(torch.equal(scan_k(x), got), f"B5 {dtype} differs "
                    f"from call to call, set {name}")
            err = (got - blocked_cumsum_ref(x)).abs().double()
            tol = C_SCAN * eps * torch.cumsum(x.abs().double(), 0)
            require(bool(torch.all(err <= tol)),
                    f"B5 {dtype} error above {C_SCAN} eps x running "
                    f"sum|x| on {data} data, set {name}")
            if dtype == torch.float32 and data == "normal":
                b5_err = max(b5_err, float(err.max()))
            emit({"check": "B5 vs plain", "set": name, "dtype": str(dtype),
                  "data": data, "max_abs_err": float(err.max()),
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

    # -- 3c. B3' and B4 on long runs and runs of random length -------------
    # L = 5e7 positions in runs of 2^20 (each after short runs, so they
    # start mid-tile) or of 1..10^4, a random permutation, num_segments at
    # nnz and cut mid-stream: sums bit for bit on integer-valued data,
    # bit for bit from call to call and within C_SEG eps sum|terms| of
    # the exact sum on random data; min/max bit for bit, NaN included
    seg_rng = np.random.default_rng([SEED, 3])
    L5 = BIG["siz"] * BIG["nnz_row"]
    for runs in ("long", "random"):
        lengths = run_lengths(L5, seg_rng, runs)
        perm, slot = run_stream(lengths, dev, SEED)
        nnz = len(lengths)
        row = {"check": "B3', B4 vs plain", "runs": runs, "L": L5,
               "nnz": nnz, "longest_run": int(lengths.max())}
        for n in (nnz, nnz // 2):
            nz = dict(num_segments=n)
            vi = torch.from_numpy(
                seg_rng.integers(-8, 9, L5).astype(np.float32)).to(dev)
            require(torch.equal(fill_k(vi, perm, slot, **nz),
                                gather_segment_sum_ref(vi, perm, slot, **nz)),
                    f"B3' differs on integer-valued data, {runs} runs, "
                    f"num_segments {n}")
            for dtype, eps in ((torch.float32, EPS32),
                               (torch.float64, EPS64)):
                vn = torch.from_numpy(seg_rng.standard_normal(L5)).to(
                    dev, dtype)
                got = fill_k(vn, perm, slot, **nz)
                require(torch.equal(fill_k(vn, perm, slot, **nz), got),
                        f"B3' {dtype} differs from call to call, {runs} runs")
                if n == nnz:
                    r = seg_err_over_eps(got, vn, perm, slot, eps)
                    require(r <= C_SEG, f"B3' {dtype} error {r} eps x "
                            f"sum|terms| > {C_SEG}, {runs} runs")
                    row[f"B3_{dtype}_max_err_over_eps_sum_abs"] = r
                vn[[3, L5 // 2]] = float("nan")
                for op in ("min", "max"):
                    require(same_bits(
                        minmax_k(vn, perm, slot, op=op, **nz),
                        gather_segment_minmax_ref(vn, perm, slot, op=op,
                                                  **nz)),
                        f"B4 {op} {dtype} differs, {runs} runs, "
                        f"num_segments {n}")
        row.update(B3_integer="bit-identical", B3_repeat="bit-identical",
                   B4="bit-identical (NaN included)",
                   num_segments=[nnz, nnz // 2], tolerance_eps=C_SEG)
        emit(row)
        del perm, slot, vi, vn, got
        torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # -- 3d. B6 on product runs that cross its tiles -----------------------
    emit({"check": "B6 vs plain on runs that cross its tiles",
          "integer_data": "bit-identical", "nan": "bit-identical",
          "repeat": "bit-identical", "tolerance_eps": C_SEG,
          "probe_variants": "bit-identical on integer-valued data",
          "streams": product_run_checks(dev, np.random.default_rng(
              [SEED, 4]))})
    torch.cuda.empty_cache()

    # -- 4. main path -------------------------------------------------------
    counters = (hist_k, place_k, fill_k)
    for f in counters:
        f.launches = 0
    expected = {"B1": 0, "B2": 0, "B3": 0}
    oracles, verified = {}, {}
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
        verified[name] = csc_digest(S)  # the oracle's, for phase 4f
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
    torch.cuda.empty_cache()

    # -- 4c. third path: FEM SpMV four ways, CG, the Galerkin product ------
    kernels3 = {"B1": hist_k, "B2": place_k, "B3": fill_k, "B6": sum2_k,
                "B8": ell_k, "B9": sym_k, "B10": bsr_k}

    def counts3() -> dict:
        return {k: f.launches for k, f in kernels3.items()}

    for f in kernels3.values():
        f.launches = 0
    row3, launches3, exp3, fem = fem_path(dev, FEM_N, CG_ITERS, counts3, rng)
    require(launches3 == exp3, f"launch counts {launches3} != {exp3} on the "
            "third path")
    want = dict.fromkeys(kernels3, 0)
    want.update(B3=1, B6=2)
    require(row3["refill_launches"] == want, "the P' A P refill for 2 A "
            f"launched {row3['refill_launches']}, expected {want}")
    emit(row3)
    emit({"third_path_launches": launches3, "expected": exp3})
    for k in ("B6", "B8", "B9", "B10"):
        require(launches3[k] > 0, f"kernel {k} never launched on its path")
    # phase 3 for B6, B8, B9, B10, on the streams this path gave them
    errs3 = fem_kernel_checks(fem, rng, dev)
    emit({"check": "B6, B8, B9, B10 vs plain", "path": "third",
          "integer_data": "bit-identical", "B6_nan": "bit-identical",
          "max_abs_err_float32": errs3})
    emit({"check": "B9 vs plain on the arrow matrix, a column at a tile's "
                   "last item, runs of empty columns",
          "integer_data": "bit-identical", "up": "bit-identical",
          "ct_repeat": "bit-identical", "tolerance_eps": C_SEG,
          "ct_max_err_over_eps_sum_abs": sym_kernel_checks(fem, rng, dev)})

    # -- 4d. fourth path: update, the edge flip, symmetric planning ---------
    kernels4 = {"B1": hist_k, "B2": place_k, "B3": fill_k, "B4": minmax_k,
                "B5": scan_k, "B6": sum2_k, "B7": merge_k, "B8": ell_k,
                "B9": sym_k, "B10": bsr_k, "B11": cplace_k, "B12": bhist_k}

    def counts4() -> dict:
        return {k: f.launches for k, f in kernels4.items()}

    for f in kernels4.values():
        f.launches = 0
    rows4, launches4, exp4, upd = update_path(dev, sets, fem, counts4, rng)
    for row in rows4:
        emit(row)
    require(launches4 == exp4, f"launch counts {launches4} != {exp4} on "
            "the fourth path")
    emit({"fourth_path_launches": launches4, "expected": exp4})
    require(launches4["B7"] > 0, "kernel B7 never launched on its path")
    # phase 3 for B7, on the streams this path gave it
    cases7 = merge_kernel_checks(upd, rng, dev)
    emit({"check": "B7 vs plain and torch.searchsorted", "path": "fourth",
          "cases": cases7, "sides": ["left", "right"],
          "B7": "bit-identical"})
    # complex values through the float kernels, against the CPU path
    emit({"check": "complex on the card vs the CPU path",
          "max_err_over_tol": complex_checks(dev, sets, rng)})

    # -- 4e. the policy and analysis layers: priors against the builds,
    #    the sweep, a loaded table, validators, the contract audit -------
    policy_phase(dev, sets, fem, kernels4, refill, smi_line)

    # -- 4f. the plan service: cold, warm and restarted requests, graph
    #    replays against eager calls, an update, a batch, the witness ---
    cpm = sleep_cycles_per_ms()
    serving_phase(dev, sets, fem, verified, kernels4, cpm, smi_line)

    # -- 5. times -----------------------------------------------------------
    fem_k, t3 = fem_times(fem, cpm, dev)
    t3["card"] = smi_line
    emit(t3)
    t9 = sym_times(fem, cpm, dev)
    t9["card"] = smi_line
    emit(t9)
    fem_k["B9"].update(replaced_ms=t9["fem"]["replaced_ms"],
                       columns_ms=t9["fem"]["columns_ms"],
                       tiles_ms=t9["fem"]["tiles_ms"],
                       arrow_ms=t9["arrow"]["ms"],
                       arrow_replaced_ms=t9["arrow"]["replaced_ms"],
                       short_ms=t9["short"]["ms"])
    b7_row, t4 = update_times(sets, fem, upd, cpm, dev)
    t4["card"] = smi_line
    emit(t4)
    del fem, upd
    torch.cuda.empty_cache()
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
        # a representative digit pass: the second one as the chain calls
        # it, its payload the first pass's permutation, with the words it
        # carries (at 5e7 a row pass carrying rows and cols)
        keys, base, perm0, carry, kw = radix_chain(rows, cols, siz, siz,
                                                   upto=1)
        p1 = passes[1]
        hist_bytes = 4 * p1.nbins * -(-L // TILE)
        # B2 reads the keys and the payload, writes the payload, and reads
        # and writes each carried word (a carried key is read once)
        b2_bytes = 12 * L + hist_bytes + sum(
            4 * L * (1 + (w is not keys)) for w in carry)
        fill_in = (v, pat.perm, pat.slot)
        nz = dict(num_segments=pat.nzmax)
        # B11/B12 on the counting sort's first pass (rows, M + 1 bins);
        # B4/B5 on the fill's streams
        cnt = dict(nbins=siz + 1, block_b=default_block_b(siz + 1))
        table_bytes = 4 * cnt["nbins"] * -(-L // cnt["block_b"])
        offsets, _ = block_offsets(rows, **cnt)
        flat = (torch.arange(L, device=dev) // cnt["block_b"]) \
            * cnt["nbins"] + rows.long()
        # B11 as the counting sort calls it: on a table handed over
        # (consume_offsets=True), which each timed call advances again;
        # the counters' values change, the work does not.  The copy a
        # standalone call makes first is timed apart.
        handed = offsets.clone()
        keep = pat.slot < pat.nzmax
        x = torch.where(keep, v[pat.perm], 0)
        seg = torch.where(keep, pat.slot, pat.nzmax).long()
        # the yardsticks of B1 and B2: bincount of (tile, digit) and a
        # stable sort of the digit
        digit = (keys >> p1.shift) & ((1 << p1.bits) - 1)
        flat1 = (torch.arange(L, device=dev) // TILE) * p1.nbins + digit
        nflat1 = -(-L // TILE) * p1.nbins
        fns = {
            "B1": (lambda: hist_k(keys, **kw),
                   lambda: digit_block_histogram_ref(keys, tile=TILE, **kw),
                   lambda: torch.bincount(flat1, minlength=nflat1),
                   4 * L + hist_bytes, 3 * L),
            "B2": (lambda: place_k(keys, base, perm0, carry=carry, **kw),
                   lambda: digit_placement_ref(keys, base, perm0,
                                               carry=carry, tile=TILE, **kw),
                   lambda: torch.sort(digit, stable=True),
                   b2_bytes, 4 * L),
            "B3": (lambda: fill_k(*fill_in, **nz),
                   lambda: gather_segment_sum_ref(*fill_in, **nz),
                   lambda: torch.zeros(pat.nzmax, device=dev).index_add_(
                       0, pat.slot, v[pat.perm]),
                   4 * L + 8 * L + 4 * pat.nzmax, L),
            "B4": (lambda: minmax_k(*fill_in, op="max", **nz),
                   lambda: gather_segment_minmax_ref(*fill_in, op="max", **nz),
                   lambda: torch.full((pat.nzmax + 1,), float("-inf"),
                                      device=dev).scatter_reduce_(
                       0, seg, v[pat.perm], "amax", include_self=False),
                   4 * L + 8 * L + 4 * pat.nzmax, L),
            "B5": (lambda: scan_k(x), lambda: blocked_cumsum_ref(x),
                   lambda: torch.cumsum(x, 0), 8 * L, L),
            "B11": (lambda: cplace_k(rows, handed, consume_offsets=True,
                                     **cnt),
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
        rows_k["B11"]["table_copy_ms"] = device_ms(lambda: offsets.clone(),
                                                   cpm)
        # no design that gathers vals[perm] beats the gather alone
        rows_k["B3"]["gather_floor_ms"] = rows_k["B4"]["gather_floor_ms"] = \
            device_ms(lambda: gather_floor(*fill_in, pat.nzmax), cpm)
        rows_k["B11"]["standalone_ms"] = device_ms(
            lambda: cplace_k(rows, offsets, **cnt), cpm)
        t["kernels"] = rows_k
        t["card"] = smi_line
        emit(t)
        per_kernel[name] = rows_k
        del coo, rows, cols, pat, v, key64, perm0, keys, base, carry, fill_in
        del fns
        del offsets, handed, flat, keep, x, seg, digit, flat1
        torch.cuda.empty_cache()

    # B3' and B4 on one run of 2^20 duplicates, and on L = 5e7 in runs of
    # 2^20, each against the same positions with every slot once (one
    # permutation for both): no run is reduced by one thread, so a long
    # run should cost a small factor of runs of 1
    lr = {"times": "long runs", "card": smi_line}
    for size, tag in ((LONG_RUN, ""), (L5, "_5e7")):
        long_runs = np.array([LONG_RUN]) if size == LONG_RUN else \
            run_lengths(L5, seg_rng, "long")
        vl = torch.from_numpy(
            seg_rng.standard_normal(size).astype(np.float32)).to(dev)
        for runs, lengths in (("longrun", long_runs),
                              ("runs1", np.ones(size, np.int64))):
            perm, slot = run_stream(lengths, dev, SEED)
            nz = dict(num_segments=len(lengths))
            lr[f"B3_{runs}{tag}_ms"] = device_ms(
                lambda: fill_k(vl, perm, slot, **nz), cpm)
            lr[f"B3_{runs}{tag}_plain_ms"] = device_ms(
                lambda: gather_segment_sum_ref(vl, perm, slot, **nz), cpm)
            lr[f"B4_{runs}{tag}_ms"] = device_ms(
                lambda: minmax_k(vl, perm, slot, op="max", **nz), cpm)
            del perm, slot
        del vl
        torch.cuda.empty_cache()
    # B6 on one run of 2^20 products against 2^20 runs of one, sa and sb
    # random into operands of 2^20 values; the replaced design too (one
    # thread walks the long run: a few calls)
    va, vb = (torch.from_numpy(seg_rng.standard_normal(LONG_RUN).astype(
        np.float32)).to(dev) for _ in range(2))
    sa, sb = (torch.from_numpy(seg_rng.integers(0, LONG_RUN, LONG_RUN).astype(
        np.int32)).to(dev) for _ in range(2))
    for runs, n in (("longrun", 1), ("runs1", LONG_RUN)):
        slot = torch.arange(LONG_RUN, dtype=torch.int32, device=dev) \
            if n > 1 else torch.zeros(LONG_RUN, dtype=torch.int32, device=dev)
        nz = dict(num_segments=n)
        lr[f"B6_{runs}_ms"] = device_ms(
            lambda: sum2_k(va, vb, sa, sb, slot, **nz), cpm)
        lr[f"B6_{runs}_replaced_ms"] = device_ms(
            lambda: product_probe(PRODUCT_VARIANTS["replaced"], va, vb, sa,
                                  sb, slot, n), cpm, reps=3)
        lr[f"B6_{runs}_gather2_floor_ms"] = device_ms(
            lambda: gather2_floor(va, vb, sa, sb, slot, n), cpm)
    del va, vb, sa, sb, slot
    emit(lr)

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
        "B6": ("gather2_segment_sum", "src/repro_torch/csrc/segment_sum.cu",
               "src/repro/kernels/segment_sum/segment_sum.py:211",
               errs3["B6"]),
        "B8": ("spmv_ell", "src/repro_torch/csrc/spmv.cu",
               "src/repro/kernels/spmv/spmv.py:32", errs3["B8"]),
        "B9": ("sym_streams", "src/repro_torch/csrc/spmv_sym.cu",
               "src/repro/kernels/spmv_sym/spmv_sym.py:52", errs3["B9"]),
        "B10": ("bsr_tiles", "src/repro_torch/csrc/spmv_sym.cu",
                "src/repro/kernels/spmv_sym/spmv_sym.py:104", errs3["B10"]),
        "B7": ("merge_search_kernel", "src/repro_torch/csrc/merge.cu",
               "src/repro/kernels/merge/merge.py:47", 0.0),
    }
    # launches: B1-B3 on the main path (phase 4), B4, B5, B11, B12 on
    # theirs (4b), B6, B8, B9, B10 on the third path (4c), B7 on the
    # fourth (4d); times at 5e7 for the first seven, at the third path's
    # size for B6 and B8-B10, B7 at the update of the 5e7 set (1% delta)
    path_launches = {**launches2, **launches,
                     **{k: launches3[k] for k in fem_k if k in launches3},
                     "B7": launches4["B7"]}
    big = {**big, **fem_k, "B7": b7_row}
    emit({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[k], "max_abs_err": err,
         "ms": big[k]["ms"], "call_ms": big[k]["call_ms"],
         "plain_ms": big[k]["plain_ms"],
         "bound_ms": big[k]["bound_ms"], "bound_by": big[k]["bound_by"],
         "library_ms": big[k]["library_ms"],
         **({"gather_floor_ms": big[k]["gather_floor_ms"]}
            if k in ("B3", "B4") else {}),
         **({"longrun_ms": lr[f"{k}_longrun_ms"],
             "runs1_ms": lr[f"{k}_runs1_ms"]} if k in ("B3", "B4", "B6")
            else {}),
         **({"replaced_ms": big[k]["replaced_ms"]} if k in ("B6", "B7", "B9")
            else {}),
         **({"gather2_floor_ms": big[k]["gather2_floor_ms"],
             "shipped": f"K = {PRODUCT_TILE // 256}",
             "sweep_winner": big[k]["sweep_winner"],
             "second_product": {
                 "what": "(P' A) P", **{f: big["B6_Ac"][f] for f in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "bytes", "flops", "replaced_ms", "gather2_floor_ms",
                     "sweep_winner")}}} if k == "B6" else {})}
        for k, (n, src, rep, err) in meta.items()
    ]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loaded-table-check"]:
        loaded_table_check(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--serving-restart-check"]:
        serving_restart_check(sys.argv[2])
    else:
        main()
