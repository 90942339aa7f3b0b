"""Device times of the kernels redesigned for the H100 (queue D) on the
card, on ``chip_smoke.py``'s inputs, next to their library calls.

    python3 kernel_times.py

Set 2 of Table 4.1 (L = 2.5e6) and the 5e7 set:
  - B12 (block histogram) and B11 (counting-sort placement, on a
    handed-over table as the counting sort calls it) on the counting
    sort's first pass (the coo rows, M + 1 bins), against
    ``torch.bincount`` of the flattened (block, key) and a stable
    ``torch.sort``;
  - B5 (prefix sum) on L random float32 values, against
    ``torch.cumsum``;
  - B2 (digit placement) on the radix chain's second pass as
    ``radix_sort_pair`` calls it (with its carried words), B1 on the same
    keys, the whole radix sort against a stable ``torch.sort`` of the
    int64 key ``col * (M + 1) + row``, and the two plans.
Each kernel is first held against its plain version (B12, B11, B2 and
the radix permutation bit for bit, B5 within 64 eps of the running sum
of |x|).

Then B3' (fused fill) and B4 (fused min/max, as max) on the streams of
sets 1, 2 and 2x20's plans, of the FEM matrix A's plan (1.79e7 triplets
in element order: a local gather) and of one run of 2^20 duplicates
against the same positions with every slot once, each stream's variants
timed in turns (forward, then backward) in one call: the wrapper as
shipped, the probe's variants (``csrc/segment_sum_probe.cu``: the
kernel as shipped, K = 4, 8, 12, 16 with and without a bound on the
registers, the index streams through __ldg, and the design B3' and B4
replaced, one thread walking each run), the gather floor (B3''s loads, no
reduction) at K = 8 and 16, and ``index_add_`` with the gather.  Each
variant is first held against the plain version (integer-valued data
bit for bit, B4 bit for bit).

Prints the card's name and power limit, then one JSON line a set and
one a stream.  A quicker measure than ``chip_smoke.py`` when two
versions of these kernels are compared on one card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as smoke  # noqa: E402  (also puts src/ on the path)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels import common
    from repro_torch.kernels.counting_sort.counting_sort import placement
    from repro_torch.kernels.counting_sort.ref import placement_ref
    from repro_torch.kernels.hist.hist import block_histogram
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.kernels.hist.ref import block_histogram_ref
    from repro_torch.kernels.radix_sort import radix_sort as rs
    from repro_torch.kernels.radix_sort.ops import radix_sort_pair
    from repro_torch.kernels.radix_sort.ref import (digit_placement_ref,
                                                    radix_sort_pair_ref)
    from repro_torch.kernels.segment_sum.ref import blocked_cumsum_ref
    from repro_torch.kernels.segment_sum.segment_sum import blocked_cumsum
    from repro_torch.sparse.pattern import plan_coo

    print(smoke.nvidia_smi_line(), flush=True)
    logs = common.build(["hist", "counting_sort", "segment_sum",
                         "radix_sort", "segment_sum_probe"])
    for lib, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"ptxas[{lib}]: {line.strip()}", flush=True)
    cpm = smoke.sleep_cycles_per_ms()
    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED)
    for name, cfg in (("2", DATA_SETS[2]), ("2x20", smoke.BIG)):
        ii, jj, ss, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                    seed=smoke.SEED)
        coo = coo_from_matlab(ii, jj, ss, (siz, siz))
        rows, cols = coo.rows, coo.cols
        L = rows.shape[0]
        cnt = dict(nbins=siz + 1, block_b=default_block_b(siz + 1))
        smoke.require(torch.equal(block_histogram(rows, **cnt),
                                  block_histogram_ref(rows, **cnt)),
                      f"B12 differs, set {name}")
        offsets, _ = block_offsets(rows, **cnt)
        smoke.require(torch.equal(placement(rows, offsets, **cnt),
                                  placement_ref(rows, offsets, **cnt)),
                      f"B11 differs, set {name}")
        handed = offsets.clone()
        flat = (torch.arange(L, device=dev) // cnt["block_b"]) \
            * cnt["nbins"] + rows.long()
        nflat = offsets.numel()
        x = torch.from_numpy(rng.standard_normal(L)).to(dev, torch.float32)
        err = (blocked_cumsum(x) - blocked_cumsum_ref(x)).abs().double()
        tol = 64 * smoke.EPS32 * torch.cumsum(x.abs().double(), 0)
        smoke.require(bool(torch.all(err <= tol)), f"B5 error, set {name}")
        keys, base, perm0, carry, kw = smoke.radix_chain(rows, cols, siz,
                                                         siz, upto=1)
        got = rs.digit_placement(keys, base, perm0, carry=carry, **kw)
        want = digit_placement_ref(keys, base, perm0, carry=carry,
                                   tile=rs.TILE, **kw)
        smoke.require(all(torch.equal(a, b) for a, b in zip(
            (got[0], *got[1]), (want[0], *want[1]))),
            f"B2 differs on the chain's second pass, set {name}")
        smoke.require(torch.equal(
            radix_sort_pair(rows, cols, M=siz, N=siz),
            radix_sort_pair_ref(rows, cols, M=siz, N=siz)),
            f"radix permutation differs, set {name}")
        key64 = cols.long() * (siz + 1) + rows.long()
        print(json.dumps({
            "set": name, "L": L, **cnt, "B2_pass": kw,
            "B2_carried_words": len(carry),
            "B12_ms": smoke.device_ms(
                lambda: block_histogram(rows, **cnt), cpm),
            "bincount_ms": smoke.device_ms(
                lambda: torch.bincount(flat, minlength=nflat), cpm),
            "B11_ms": smoke.device_ms(
                lambda: placement(rows, handed, consume_offsets=True, **cnt),
                cpm),
            "sort_stable_ms": smoke.device_ms(
                lambda: torch.sort(rows, stable=True), cpm),
            "B5_f32_ms": smoke.device_ms(lambda: blocked_cumsum(x), cpm),
            "cumsum_f32_ms": smoke.device_ms(lambda: torch.cumsum(x, 0),
                                             cpm),
            "B1_ms": smoke.device_ms(
                lambda: rs.digit_block_histogram(keys, **kw), cpm),
            "B2_ms": smoke.device_ms(
                lambda: rs.digit_placement(keys, base, perm0, carry=carry,
                                           **kw), cpm),
            "radix_sort_device_ms": smoke.device_ms(
                lambda: radix_sort_pair(rows, cols, M=siz, N=siz), cpm),
            "sort_key64_stable_ms": smoke.device_ms(
                lambda: torch.sort(key64, stable=True), cpm),
            "plan_device_ms": smoke.device_ms(lambda: plan_coo(coo), cpm),
            "plan_pallas_device_ms": smoke.device_ms(
                lambda: plan_coo(coo, method="pallas"), cpm),
        }), flush=True)
        del ii, jj, ss, coo, rows, cols, offsets, handed, flat, x, err, tol
        del keys, base, perm0, carry, got, want, key64
        torch.cuda.empty_cache()


def segment_times(cpm, dev) -> None:
    """B3', B4, their variants and the gather floor, per stream."""
    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.kernels.segment_sum import segment_sum as ss
    from repro_torch.kernels.segment_sum.ref import (
        gather_segment_minmax_ref, gather_segment_sum_ref)
    from repro_torch.sparse.pattern import plan, plan_coo

    rng = np.random.default_rng(smoke.SEED)

    def streams():
        for name in ("1", "2", "2x20"):
            cfg = smoke.BIG if name == "2x20" else DATA_SETS[int(name)]
            ii, jj, ss_, siz = ransparse(cfg["siz"], cfg["nnz_row"],
                                         cfg["nrep"], seed=smoke.SEED)
            pat = plan_coo(coo_from_matlab(ii, jj, ss_, (siz, siz)))
            yield name, pat.perm, pat.slot, pat.nzmax
        rows, cols, _, nv, _, _ = smoke.fem_system(smoke.FEM_N)
        pat = plan(torch.from_numpy(rows).to(dev),
                   torch.from_numpy(cols).to(dev), (nv, nv))
        yield "fem_A", pat.perm, pat.slot, pat.nzmax
        for kind, lengths in (
                ("one_run_2^20", np.array([smoke.LONG_RUN])),
                ("runs_of_1_2^20", np.ones(smoke.LONG_RUN, np.int64))):
            perm, slot = smoke.run_stream(lengths, dev, smoke.SEED)
            yield kind, perm, slot, len(lengths)

    for name, perm, slot, n in streams():
        L = slot.numel()
        nz = dict(num_segments=n)
        v = torch.from_numpy(rng.standard_normal(L).astype(np.float32)) \
            .to(dev)
        vi = torch.from_numpy(rng.integers(-8, 9, L).astype(np.float32)) \
            .to(dev)
        want_i = gather_segment_sum_ref(vi, perm, slot, **nz)
        want_max = gather_segment_minmax_ref(v, perm, slot, op="max", **nz)
        variants = {
            "B3_ms": lambda x: ss.gather_segment_sum(x, perm, slot, **nz),
            **{f"B3_{tag}_ms": (lambda x, k=k: smoke.probe_fill(
                k, x, perm, slot, n))
               for k, tag in ((0, "replaced"), (1, "K4"), (2, "shipped"),
                              (3, "K16"), (4, "ldg"), (5, "K8_min6"),
                              (6, "K16_min4"), (7, "K12"), (8, "K8"),
                              (9, "K4_min8"), (10, "K12_min5"))},
            "B4_ms": lambda x: ss.gather_segment_minmax(x, perm, slot,
                                                        op="max", **nz),
            "B4_replaced_ms": lambda x: smoke.probe_fill(0, x, perm, slot, n,
                                                         op="max"),
        }
        for key, fn in variants.items():
            if key.startswith("B3"):
                smoke.require(torch.equal(fn(vi), want_i),
                              f"{key} differs on integer-valued data, {name}")
            else:
                smoke.require(smoke.same_bits(fn(v), want_max),
                              f"{key} differs, {name}")
        timed = {k: (lambda f=f: f(v)) for k, f in variants.items()}
        timed.update({
            "gather_floor_K8_ms": lambda: smoke.gather_floor(v, perm, slot,
                                                             n, 2),
            "gather_floor_K16_ms": lambda: smoke.gather_floor(v, perm, slot,
                                                              n, 3),
            "index_add_ms": lambda: torch.zeros(n, device=dev).index_add_(
                0, slot, v[perm]),
        })
        # the replaced design walks a long run on one thread: a few calls
        reps = {k: 3 if k.endswith("replaced_ms") and name.startswith("one")
                else smoke.REPS for k in timed}
        row = {"stream": name, "L": L, "num_segments": n,
               "longest_run": int(torch.bincount(slot).max())}
        row["bound_ms"], _ = smoke.bound_ms(12 * L + 4 * n, L)
        order = list(timed)
        for turn, keys in (("fwd", order), ("bwd", order[::-1])):
            for k in keys:
                row.setdefault(k, {})[turn] = smoke.device_ms(
                    timed[k], cpm, reps=reps[k])
        print(json.dumps(row), flush=True)
        del perm, slot, v, vi, want_i, want_max
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
    segment_times(smoke.sleep_cycles_per_ms(), torch.device("cuda"))
