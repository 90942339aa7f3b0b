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

Then B7 (merge search) at its two call sites, the updates of set 2 and
of the 5e7 set by their last 1% and 10% (sorted delta into the plan of
the rest, side "right") and the FEM matrix's symmetry probe (its
mirrored keys into its structure, both sides), and B9 (symmetric
streams) on the FEM matrix's SymCSC stream, on the arrow matrix (a
column of 2^20 entries) and on as many slots in short columns
(``chip_smoke.sym_stream``): each beside the design it replaced and
the probes' other shapes
(``csrc/merge_probe.cu``, ``csrc/spmv_sym_probe.cu``), timed in turns
(forward, then backward) in one call, with ``torch.searchsorted`` on
keys packed beforehand beside B7 and the mean time of each phase of a
B9 tile (``chip_smoke.sym_phase_stamps``).  Then the sweeps that set
the shapes' thresholds: B7's kernels over n = 2^21 .. 2^25 and n / Lq =
1 .. 128, and B9's two shapes over the longest column (4 .. 256, every
column that long or one in 64) at about 3e6 slots.  Each variant is
first held against the plain version (B7 bit for bit, B9 bit for bit on
integer-valued data).

Then B6 (product fill) on the Galerkin operator's two products at 10^6
DOFs (``P' A`` and ``(P' A) P``), on one run of 2^20 products against
2^20 runs of one, on runs of random length 1..10^4 and on ``B' B`` of
the arrow matrix (``chip_smoke.arrow_gram``: one run of 2^20): the
wrapper, each variant of its probe (``chip_smoke.PRODUCT_VARIANTS``:
the replaced design, tile depths K = 4, 8, 12 at several register
bounds, the index streams through __ldg), the two-gather floor at K =
4, 8, 12 and ``index_add_`` with both gathers and the product, timed in
turns (forward, then backward), each variant first held against the
plain version bit for bit on integer-valued data.

    python3 kernel_times.py [queue_d] [segment] [merge_sym] [product]

runs the named sections (all four without arguments).  Prints the
card's name and power limit, then one JSON line a set, a stream or a
site.  A quicker measure than ``chip_smoke.py`` when two versions of
these kernels are compared on one card.
"""
from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as smoke  # noqa: E402  (also puts src/ on the path)


def queue_d_times() -> None:
    """B12, B11, B5, B1, B2, the radix sort and the plans, per set."""
    from repro_torch.core.coo import coo_from_matlab
    from repro_torch.core.ransparse import DATA_SETS, ransparse
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


def product_times(cpm, dev) -> None:
    """B6 (product fill), its probe's variants and the two-gather floor,
    per product stream."""
    from repro_torch.kernels.segment_sum import segment_sum as ss
    from repro_torch.kernels.segment_sum.ref import (PRODUCT_TILE,
                                                     gather2_segment_sum_ref)
    from repro_torch.sparse import convert, ops, plan, product_plan

    rng = np.random.default_rng(smoke.SEED)
    n_ops = smoke.LONG_RUN

    def streams():
        # the Galerkin operator's two products at 10^6 DOFs
        rows, cols, vals, nv, _, _ = smoke.fem_system(smoke.FEM_N)
        A = plan(torch.from_numpy(rows).to(dev),
                 torch.from_numpy(cols).to(dev), (nv, nv)).assemble(
            torch.from_numpy(vals).to(dev))
        pr, pc, pv, pshape = smoke.bilinear_prolongation(smoke.FEM_N)
        P = plan(torch.from_numpy(pr).to(dev), torch.from_numpy(pc).to(dev),
                 pshape).assemble(torch.from_numpy(pv).to(dev))
        Ptc = convert(ops.transpose(P), "csc")
        pp = product_plan(Ptc, A)
        yield "PtA", (Ptc.nzmax, A.nzmax), pp.sa, pp.sb, pp.pattern.slot, \
            pp.nzmax
        PtA = pp.multiply(Ptc.data, A.data)
        pp = product_plan(PtA, P)
        yield "PtA_P", (PtA.nzmax, P.nzmax), pp.sa, pp.sb, \
            pp.pattern.slot, pp.nzmax
        del A, P, Ptc, PtA, pp
        # one run of 2^20 products and 2^20 runs of one, sa and sb random
        sa, sb = (torch.from_numpy(rng.integers(0, n_ops, n_ops).astype(
            np.int32)).to(dev) for _ in range(2))
        for kind, slot in (
                ("one_run_2^20", torch.zeros(n_ops, dtype=torch.int32,
                                             device=dev)),
                ("runs_of_1_2^20", torch.arange(n_ops, dtype=torch.int32,
                                                device=dev))):
            yield kind, (n_ops, n_ops), sa, sb, slot, int(slot.max()) + 1
        st = smoke.product_stream("random", PRODUCT_TILE, rng, n_ops)
        sa, sb, slot = (torch.from_numpy(x).to(dev) for x in st)
        yield "random_runs", (n_ops, n_ops), sa, sb, slot, \
            int(st[2].max()) + 1
        flops = smoke.arrow_gram_flops()
        if flops <= smoke.ARROW_GRAM_MAX_FLOPS:
            pp, Bt, B = smoke.arrow_gram(dev, rng)
            yield "arrow_gram", (Bt.nzmax, B.nzmax), pp.sa, pp.sb, \
                pp.pattern.slot, pp.nzmax

    for name, (na, nb), sa, sb, slot, n in streams():
        L = slot.numel()
        st, nz = (sa, sb, slot), dict(num_segments=n)
        va, vb = (torch.from_numpy(rng.standard_normal(k).astype(
            np.float32)).to(dev) for k in (na, nb))
        vai, vbi = (torch.from_numpy(rng.integers(-8, 9, k).astype(
            np.float32)).to(dev) for k in (na, nb))
        want = gather2_segment_sum_ref(vai, vbi, *st, **nz)
        variants = {
            "B6_ms": lambda a, b: ss.gather2_segment_sum(a, b, *st, **nz),
            **{f"B6_{v}_ms": (lambda a, b, i=i: smoke.product_probe(
                i, a, b, *st, n)) for v, i in smoke.PRODUCT_VARIANTS.items()},
        }
        for key, fn in variants.items():
            smoke.require(torch.equal(fn(vai, vbi), want),
                          f"{key} differs on integer-valued data, {name}")
        timed = {k: (lambda f=f: f(va, vb)) for k, f in variants.items()}
        for v, tag in ((1, "K8"), (2, "K4"), (3, "K12")):
            timed[f"gather2_floor_{tag}_ms"] = \
                lambda v=v: smoke.gather2_floor(va, vb, *st, n, v)
        slot_l = slot.long()
        timed["index_add_ms"] = lambda: torch.zeros(n, device=dev) \
            .index_add_(0, slot_l, va[sa] * vb[sb])
        reps = {k: 3 if k == "B6_replaced_ms" and name.startswith(
            ("one", "arrow")) else smoke.REPS for k in timed}
        reached = [int(torch.unique(i).numel()) for i in (sa, sb)]
        row = {"stream": name, "L": L, "num_segments": n,
               "longest_run": int(torch.bincount(
                   slot[(slot >= 0) & (slot < n)].long()).max()),
               "reached": reached}
        row["bound_ms"], _ = smoke.bound_ms(
            12 * L + 4 * sum(reached) + 4 * n, 2 * L)
        order = list(timed)
        for turn, keys in (("fwd", order), ("bwd", order[::-1])):
            for k in keys:
                row.setdefault(k, {})[turn] = smoke.device_ms(
                    timed[k], cpm, reps=reps[k])
        print(json.dumps(row), flush=True)
        del sa, sb, slot, slot_l, va, vb, vai, vbi, want, st
        torch.cuda.empty_cache()


def _turns(row: dict, timed: dict, cpm) -> None:
    """Each of ``timed`` into ``row``, forward then backward."""
    order = list(timed)
    for turn, keys in (("fwd", order), ("bwd", order[::-1])):
        for k in keys:
            row.setdefault(k, {})[turn] = smoke.device_ms(timed[k], cpm)


def merge_sym_times(cpm, dev) -> None:
    """B7 at both call sites and B9 on three streams, each beside its
    probe's variants."""
    from repro_torch.core.coo import host_triplets
    from repro_torch.kernels.merge import merge as mg
    from repro_torch.kernels.merge.ref import merge_search_ref
    sym_mod = importlib.import_module(
        "repro_torch.kernels.spmv_sym.spmv_sym")
    from repro_torch.kernels.spmv_sym.ref import SYM_TILE, sym_streams_ref
    from repro_torch.core.ransparse import DATA_SETS, ransparse
    from repro_torch.sparse import convert, plan
    from repro_torch.sparse.dispatch import sorted_permutation

    sites = {}
    for name, cfg in (("2", DATA_SETS[2]), ("2x20", smoke.BIG)):
        ii, jj, ss_, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                     seed=smoke.SEED)
        r_h, c_h, _, _ = host_triplets(ii, jj, ss_, (siz, siz))
        r, c = torch.from_numpy(r_h).to(dev), torch.from_numpy(c_h).to(dev)
        L = r.numel()
        for frac in smoke.UPDATE_FRACS:
            Lb = L - round(frac * L)
            base = plan(r[:Lb], c[:Lb], (siz, siz), nzmax=L)
            d = sorted_permutation(r[Lb:], c[Lb:], M=siz, N=siz).long()
            sites[f"update_{name}_{frac}"] = (
                r[Lb:][d], c[Lb:][d], base.srows, base.scols, siz,
                ("right",))
        del ii, jj, ss_, r_h, c_h, r, c, d, base
    rows_f, cols_f, vals_f, nv, _, _ = smoke.fem_system(smoke.FEM_N)
    pat = plan(torch.from_numpy(rows_f).to(dev),
               torch.from_numpy(cols_f).to(dev), (nv, nv))
    sr = pat.srows[pat.first].contiguous()
    sc = pat.scols[pat.first].contiguous()
    sites["symmetric"] = (sc, sr, sr, sc, nv, ("left", "right"))
    for site, (qr, qc, tr, tc, Mk, sides) in sites.items():
        key = tc.long() * (Mk + 1) + tr.long()
        qkey = qc.long() * (Mk + 1) + qr.long()
        for side in sides:
            want = merge_search_ref(qr, qc, tr, tc, side=side)
            timed = {"B7_ms": lambda: mg.merge_search_kernel(
                qr, qc, tr, tc, side=side)}
            for v, k in smoke.MERGE_VARIANTS.items():
                timed[f"{v}_ms"] = (lambda k=k: smoke.merge_probe(
                    k, qr, qc, tr, tc, side))
            for k, fn in timed.items():
                smoke.require(torch.equal(fn(), want),
                              f"{k} differs, {site}, {side}")
            timed["searchsorted_alone_ms"] = lambda: torch.searchsorted(
                key, qkey, right=side == "right")
            row = {"B7_site": site, "side": side, "Lq": qr.numel(),
                   "n": tr.numel()}
            _turns(row, timed, cpm)
            print(json.dumps(row), flush=True)
    del sites, key, qkey
    torch.cuda.empty_cache()

    A = pat.assemble(torch.from_numpy(vals_f).to(dev))
    S = convert(A, "symcsc")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(nv).astype(
        np.float32)).to(dev)
    streams = {"fem": (S.indices, S.data, S.indptr, x)}
    g = np.random.default_rng([smoke.SEED, 9])
    for kind in ("arrow", "short"):
        rows_h, indptr_h, M = smoke.sym_stream(kind, SYM_TILE, g)
        streams[kind] = (
            torch.from_numpy(rows_h).to(dev),
            torch.from_numpy(g.standard_normal(rows_h.size).astype(
                np.float32)).to(dev),
            torch.from_numpy(indptr_h).to(dev),
            torch.from_numpy(g.standard_normal(M).astype(np.float32)).to(dev))
    for name, (rows, data, indptr, xs) in streams.items():
        di = data.round()
        xi = xs.mul(4).round()
        want = sym_streams_ref(rows, di, indptr, xi)
        longest = int(torch.diff(indptr).max())
        kw = dict(longest=longest)
        timed = {"B9_ms": lambda: sym_mod.sym_streams(rows, data, indptr, xs,
                                                      **kw)}
        checks = {"B9_ms": lambda: sym_mod.sym_streams(rows, di, indptr, xi,
                                                       **kw)}
        for v, k in smoke.SYM_VARIANTS.items():
            timed[f"{v}_ms"] = (lambda k=k: smoke.sym_probe(
                k, rows, data, indptr, xs))
            checks[f"{v}_ms"] = (lambda k=k: smoke.sym_probe(
                k, rows, di, indptr, xi))
        for k, fn in checks.items():
            smoke.require(all(torch.equal(a, b) for a, b in zip(fn(), want)),
                          f"{k} differs on integer-valued data, {name}")
        M, nz = xs.numel(), data.numel()
        row = {"B9_stream": name, "M": M, "nzmax": nz,
               "longest_column": longest}
        row["bound_ms"], _ = smoke.bound_ms(12 * nz + 12 * M + 4, 3 * nz)
        _turns(row, timed, cpm)
        row["phases"] = smoke.sym_phase_stamps(rows, data, indptr, xs)
        print(json.dumps(row), flush=True)
    del streams
    torch.cuda.empty_cache()
    merge_sweep(cpm, dev)
    sym_sweep(cpm, dev)


def merge_sweep(cpm, dev) -> None:
    """B7's kernels whatever Lq and n (the dense kernel, the ladder
    reading rows on ties, the ladder reading both arrays) over n = 2^21 ..
    2^25 random (col, row) targets, about 50 a column, and n / Lq = 1 ..
    128 sorted random queries, side "right": the thresholds the launcher
    chooses by."""
    from repro_torch.kernels.merge.ref import merge_shape

    g = torch.Generator(device=dev).manual_seed(smoke.SEED)

    def keys(k, cols):
        c = torch.randint(0, cols, (k,), device=dev, generator=g,
                          dtype=torch.int32)
        r = torch.randint(0, 10**6 + 1, (k,), device=dev, generator=g,
                          dtype=torch.int32)
        o = torch.sort(c.long() * (10**6 + 1) + r.long()).indices
        return r[o].contiguous(), c[o].contiguous()

    for lg in range(21, 26):
        n = 1 << lg
        tr, tc = keys(n, n // 50)
        tk = tc.long() * (10**6 + 1) + tr.long()
        for ratio in (1, 2, 4, 8, 16, 32, 64, 128):
            qr, qc = keys(n // ratio, n // 50)
            want = torch.searchsorted(tk, qc.long() * (10**6 + 1)
                                      + qr.long(), right=True).int()
            timed = {f"{v}_ms": (lambda k=smoke.MERGE_VARIANTS[v]:
                                 smoke.merge_probe(k, qr, qc, tr, tc,
                                                   "right"))
                     for v in ("dense", "sparse", "ladder")}
            for k, fn in timed.items():
                smoke.require(torch.equal(fn(), want),
                              f"{k} differs, n {n}, n / Lq {ratio}")
            row = {"B7_sweep": lg, "n": n, "Lq": qr.numel(),
                   "shipped": merge_shape(qr.numel(), n)}
            _turns(row, timed, cpm)
            print(json.dumps(row), flush=True)
        del tr, tc, tk, qr, qc, want
    torch.cuda.empty_cache()


def sym_sweep(cpm, dev) -> None:
    """B9's two shapes (one thread a column, the merge-path tiles; the
    probe's variants) against the longest column w = 4 .. 256 at about
    the FEM matrix's slots: every column of min(c, w) entries
    (``width_<w>``) and columns of 3 with every 64th of w
    (``mixed_<w>``; ``chip_smoke.sym_lengths``)."""
    from repro_torch.kernels.spmv_sym.ref import (SYM_TILE, sym_shape,
                                                  sym_streams_ref)

    g = np.random.default_rng([smoke.SEED, 10])
    for kind in ("width", "mixed"):
        for w in (4, 8, 12, 16, 24, 32, 64, 256):
            rows_h, indptr_h, M = smoke.sym_stream(f"{kind}_{w}", SYM_TILE, g)
            rows = torch.from_numpy(rows_h).to(dev)
            indptr = torch.from_numpy(indptr_h).to(dev)
            nz = rows.numel()
            data = torch.from_numpy(g.standard_normal(nz).astype(
                np.float32)).to(dev)
            x = torch.from_numpy(g.standard_normal(M).astype(
                np.float32)).to(dev)
            di, xi = data.round(), x.mul(4).round()
            want = sym_streams_ref(rows, di, indptr, xi)
            timed = {f"{v}_ms": (lambda k=smoke.SYM_VARIANTS[v], d=data, y=x:
                                 smoke.sym_probe(k, rows, d, indptr, y))
                     for v in ("columns", "tiles")}
            for v in ("columns", "tiles"):
                got = smoke.sym_probe(smoke.SYM_VARIANTS[v], rows, di, indptr,
                                      xi)
                smoke.require(all(torch.equal(a, b)
                                  for a, b in zip(got, want)),
                              f"B9 {v} differs on integer-valued data, "
                              f"{kind}_{w}")
            row = {"B9_sweep": kind, "longest_column": w, "M": M,
                   "nzmax": nz, "shipped": sym_shape(w, M, nz)}
            row["bound_ms"], _ = smoke.bound_ms(12 * nz + 12 * M + 4, 3 * nz)
            _turns(row, timed, cpm)
            print(json.dumps(row), flush=True)


SECTIONS = ("queue_d", "segment", "merge_sym", "product")


def main(sections) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.kernels import common

    unknown = set(sections) - set(SECTIONS)
    if unknown:
        sys.exit(f"unknown sections {sorted(unknown)}; choose from "
                 f"{SECTIONS}")
    print(smoke.nvidia_smi_line(), flush=True)
    libs = {"queue_d": ["hist", "counting_sort", "segment_sum",
                        "radix_sort"],
            "segment": ["segment_sum", "segment_sum_probe", "radix_sort"],
            "merge_sym": ["merge", "merge_probe", "spmv_sym",
                          "spmv_sym_probe", "radix_sort", "segment_sum"],
            "product": ["segment_sum", "segment_sum_probe", "radix_sort"]}
    logs = common.build(sorted({n for s in sections for n in libs[s]}))
    for lib, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"ptxas[{lib}]: {line.strip()}", flush=True)
    cpm = smoke.sleep_cycles_per_ms()
    dev = torch.device("cuda")
    if "queue_d" in sections:
        queue_d_times()
    if "segment" in sections:
        segment_times(cpm, dev)
    if "merge_sym" in sections:
        merge_sym_times(cpm, dev)
    if "product" in sections:
        product_times(cpm, dev)


if __name__ == "__main__":
    main(sys.argv[1:] or SECTIONS)
