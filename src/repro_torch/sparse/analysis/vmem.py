"""The per-kernel resource report of the H100 kernels.

Counterpart of ``repro/sparse/analysis/vmem.py`` (the file keeps its
path, and :func:`vmem_report`, :func:`format_table` and
:func:`dump_json` their names).  The reference tabulates its Pallas
VMEM residency frontier; the port has no residency budget (every kernel
reads its operands from device memory), so the report is what decides a
CUDA kernel's occupancy instead: one row per kernel instance a launch
path takes (B1-B12, per dtype), with

* the *declared* columns, from the tuning registry's build-time knobs
  and the same formulas as the ``.cu`` sources: threads a block, the
  tile, the resident blocks an SM its ``__launch_bounds__`` asks for,
  the register cap that implies, and its static and dynamic shared
  bytes (e.g. B11's ``sizeof(Smem)`` over ``kPadded = kTile + kTile /
  32``, ``csrc/counting_sort.cu``);
* the *measured* columns, on the card only: registers, local (spill)
  bytes, static shared bytes, resident blocks an SM and the card's
  opt-in shared bytes a block, from each library's ``resource_query``
  (``cudaFuncGetAttributes`` and
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on its own kernels,
  ``csrc/resources.cuh``).  On the CPU they are ``None``: not measured.

``python -m repro_torch.sparse.tuning --prior-only --vmem-report R``
consumes the rows: each row's ``knobs`` must be what the registry
resolves for its family.  This replaces the reference's
``merge_vmem_spec``, ``fill_vmem_spec`` and the like.

Row schema (one dict per kernel instance)::

    {"kernel": "B3'", "family": str, "library": str, "name": str,
     "dtype": str | None, "knobs": {...}, "threads": int, "tile": int,
     "min_blocks": int | None, "max_registers": int,
     "static_smem": int, "dynamic_smem": int, "measured": bool,
     "registers": int | None, "spill_bytes": int | None,
     "static_smem_measured": int | None, "blocks_per_sm": int | None,
     "smem_optin": int | None}
"""
from __future__ import annotations

import ctypes
import json

from .. import tuning

__all__ = ["check_report", "dump_json", "format_table", "vmem_report"]

#: registers an SM holds; a thread may use at most 255
_SM_REGISTERS = 65536
_MAX_REGISTERS = 255
#: the bins of the shared-counter B12 instance the report describes
#: (Table 4.1 set 2: M + 1 = 50,001), as ``csrc/hist.cu``'s table
HIST_REPORT_BINS = 50_001
#: the static shared bytes the card may add to a declared sum (alignment
#: of the arrays the compiler lays out)
SMEM_SLACK = 64
_SIZE = {"float32": 4, "float64": 8}
#: the look-back's carried type: double for float32, a TwoSum pair for
#: float64 (``csrc/lookback.cuh`` ``Chain``)
_ACC = {"float32": 8, "float64": 16}


def _cap(threads: int, min_blocks: int | None) -> int:
    """The register cap ``__launch_bounds__(threads, min_blocks)`` sets."""
    per = _SM_REGISTERS // (threads * (min_blocks or 1))
    return min(_MAX_REGISTERS, per // 8 * 8)


def _row(kernel, family, library, name, *, dtype=None, knobs, threads,
         tile, min_blocks=None, static=0, dynamic=0) -> dict:
    return {"kernel": kernel, "family": family, "library": library,
            "name": name, "dtype": dtype, "knobs": knobs,
            "threads": threads, "tile": tile, "min_blocks": min_blocks,
            "max_registers": _cap(threads, min_blocks),
            "static_smem": static, "dynamic_smem": dynamic,
            "measured": False, "registers": None, "spill_bytes": None,
            "static_smem_measured": None, "blocks_per_sm": None,
            "smem_optin": None}


def declared_rows() -> list[dict]:
    """Every kernel instance with its declared columns (no card)."""
    rows = []
    # B1, B2 (csrc/radix_sort.cu)
    rk = tuning.build_knobs("radix_sort")
    t, tile = rk["threads"], rk["tile"]
    warps, bins = t // 32, 1 << rk["kernel_max_bits"]
    knobs = {k: rk[k] for k in ("threads", "tile")}
    # the counted chunk, [bins + 1][hist_chunk + 1] (a row for the keys
    # that count nowhere)
    chunk = rk["hist_chunk"]
    rows.append(_row("B1", "radix_sort", "radix_sort", "digit_histogram",
                     knobs={**knobs, "hist_per_sm": rk["hist_per_sm"],
                            "hist_chunk": chunk},
                     threads=t, tile=tile, min_blocks=rk["hist_per_sm"],
                     static=4 * (bins + 1) * (chunk + 1)))
    # cnt[warps][bins + 1], gbase[bins], wsum[warps], nvalid; staging of
    # the key, the payload and nc carried words (4 B) + position (2 B)
    # and digit (1 B) a key
    for nc in range(3):
        rows.append(_row(
            "B2", "radix_sort", "radix_sort", f"digit_placement_c{nc}",
            knobs=knobs, threads=t, tile=tile,
            static=4 * warps * (bins + 1) + 4 * bins + 4 * warps + 4,
            dynamic=(nc + 2) * tile * 4 + tile * 3))
    # B3', B4, B6, B5 (csrc/segment_sum.cu)
    sk = tuning.build_knobs("segment_sum")
    t = sk["threads"]
    w = t // 32
    for kernel, prefix, per_knob, ops in (
            ("B3'", "gather_segment", "seg", ("sum",)),
            ("B4", "gather_segment", "seg", ("max", "min")),
            ("B6", "gather2_segment", "sum2", ("sum",))):
        for op in ops:
            for dt, sfx in (("float32", "f32"), ("float64", "f64")):
                s, acc = _SIZE[dt], _ACC[dt]
                tile = t * sk[f"{per_knob}_per"]
                mb = sk[f"{per_knob}_min_blocks_{sfx}"]
                # ss, vv (each padded), warp_f, warp_v, look, excl_s, 4 ints
                static = (4 * (tile + tile // 32)
                          + s * (tile + tile // (128 // s)) + 4 * w + s * w
                          + acc * 8 * 32 + acc + 16)
                rows.append(_row(
                    kernel, "segment_sum", "segment_sum",
                    f"{prefix}_{op}_{sfx}", dtype=dt,
                    knobs={"threads": t, f"{per_knob}_per":
                           sk[f"{per_knob}_per"],
                           f"{per_knob}_min_blocks_{sfx}": mb},
                    threads=t, tile=tile, min_blocks=mb, static=static))
    for dt, sfx in (("float32", "f32"), ("float64", "f64")):
        s, acc = _SIZE[dt], _ACC[dt]
        tile = t * sk["scan_per"]
        mb = sk[f"scan_min_blocks_{sfx}"]
        # tile (padded), warps, look, excl_s, tile_s
        static = s * (tile + tile // (128 // s)) + s * w + acc * 8 * 32 \
            + s + 4
        rows.append(_row(
            "B5", "segment_sum", "segment_sum", f"blocked_cumsum_{sfx}",
            dtype=dt, knobs={"threads": t, "scan_per": sk["scan_per"],
                             f"scan_min_blocks_{sfx}": mb},
            threads=t, tile=tile, min_blocks=mb, static=static))
    # B7 (csrc/merge.cu): red[2][warps] and split[splitters - 1] int64,
    # range_s[2]; the ladder holds nothing in shared memory
    mk = tuning.build_knobs("merge")
    t = mk["threads"]
    knobs = {k: mk[k] for k in ("threads", "block_q", "splitters")}
    rows.append(_row("B7", "merge", "merge", "merge_dense", knobs=knobs,
                     threads=t, tile=mk["block_q"],
                     static=8 * 2 * (t // 32) + 8 * (mk["splitters"] - 1)
                     + 8))
    for shape in ("sparse", "ladder"):
        rows.append(_row("B7", "merge", "merge", f"merge_{shape}",
                         knobs=knobs, threads=t, tile=t))
    # B8 (csrc/spmv.cu): one row a thread
    br = tuning.build_knobs("spmv")["block_r"]
    for sfx, dt in (("f32", "float32"), ("f64", "float64")):
        rows.append(_row("B8", "spmv", "spmv", f"spmv_ell_{sfx}", dtype=dt,
                         knobs={"block_r": br}, threads=br, tile=br))
    # B9, B10 (csrc/spmv_sym.cu)
    yk = tuning.build_knobs("spmv_sym")
    t = yk["threads"]
    w = t // 32
    for dt, sfx in (("float32", "f32"), ("float64", "f64")):
        s, acc = _SIZE[dt], _ACC[dt]
        d = t * yk["sym_per"]
        mb = yk[f"sym_min_blocks_{sfx}"]
        # s_idx, s_val, s_lo, warp_f, warp_v, look, excl_s, coord_s, tile_s
        static = 4 * d + 2 * s * d + 4 * w + s * w + acc * 8 * 32 + acc \
            + 16 + 4
        rows.append(_row(
            "B9", "spmv_sym", "spmv_sym", f"sym_streams_tiles_{sfx}",
            dtype=dt, knobs={"threads": t, "sym_per": yk["sym_per"],
                             f"sym_min_blocks_{sfx}": mb},
            threads=t, tile=d, min_blocks=mb, static=static))
    for dt, sfx in (("float32", "f32"), ("float64", "f64")):
        rows.append(_row("B9", "spmv_sym", "spmv_sym",
                         f"sym_streams_columns_{sfx}", dtype=dt,
                         knobs={"threads": t}, threads=t, tile=t))
    for dt, sfx in (("float32", "f32"), ("float64", "f64")):
        rows.append(_row("B10", "spmv_sym", "spmv_sym", f"bsr_tiles_b2_{sfx}",
                         dtype=dt, knobs={"threads": t}, threads=t, tile=t))
    # B11 (csrc/counting_sort.cu): Smem of key[kPadded] (4 B), idx and
    # start[kPadded] (2 B), cnt[warps][256], warp_max[warps], ticket;
    # B12 (csrc/hist.cu): nbins counters a block, or none (global mode)
    ck = tuning.build_knobs("counting_sort")
    t, tile = ck["threads"], ck["place_tile"]
    padded = tile + tile // 32
    warps = t // 32
    rows.append(_row(
        "B11", "counting_sort", "counting_sort", "placement",
        knobs={"threads": t, "place_tile": tile}, threads=t, tile=tile,
        min_blocks=2,
        dynamic=4 * padded + 2 * 2 * padded + 4 * warps * 256 + 4 * warps
        + 4))
    ht = ck["hist_threads"]
    rows.append(_row("B12", "counting_sort", "hist",
                     "block_histogram_shared", knobs={"hist_threads": ht},
                     threads=ht, tile=ht, dynamic=4 * HIST_REPORT_BINS))
    rows.append(_row("B12", "counting_sort", "hist",
                     "block_histogram_global", knobs={"hist_threads": ht},
                     threads=ht, tile=ht))
    return rows


def _measure(rows: list[dict]) -> None:
    """Fill the measured columns from each library on the card."""
    from ...kernels.common import bind, load_library

    libs = {}
    for r in rows:
        lib = libs.get(r["library"])
        if lib is None:
            lib = load_library(r["library"])
            bind(lib, "resource_count", [])
            lib.resource_name.argtypes = [ctypes.c_int]
            lib.resource_name.restype = ctypes.c_char_p
            bind(lib, "resource_query", [ctypes.c_int, ctypes.c_void_p])
            names = [lib.resource_name(i).decode()
                     for i in range(lib.resource_count())]
            libs[r["library"]] = lib = (lib, names)
        handle, names = lib
        if r["name"] not in names:
            raise RuntimeError(f"csrc/{r['library']}.cu reports no kernel "
                               f"{r['name']!r} (it has {names})")
        out = (ctypes.c_longlong * 8)()
        rc = handle.resource_query(names.index(r["name"]), out)
        if rc:
            raise RuntimeError(f"resource query of {r['name']} failed with "
                               f"CUDA error {rc}")
        if out[0] != r["threads"] or out[4] != r["dynamic_smem"]:
            raise RuntimeError(
                f"{r['name']}: csrc/{r['library']}.cu launches {out[0]} "
                f"threads with {out[4]} dynamic shared bytes, declared "
                f"{r['threads']} and {r['dynamic_smem']}")
        r.update(measured=True, registers=int(out[1]),
                 spill_bytes=int(out[2]), static_smem_measured=int(out[3]),
                 blocks_per_sm=int(out[6]), smem_optin=int(out[7]))


def vmem_report(*, device=None) -> list[dict]:
    """The resource report: declared columns everywhere, measured ones
    on the card.  ``device`` is ``"cuda"`` unless the caller passes
    another (``"cpu"``: nothing measured); with no card and no
    ``device="cpu"`` it raises."""
    from ...kernels.common import resolve_device

    rows = declared_rows()
    if resolve_device(device).type == "cuda":
        _measure(rows)
    return rows


def check_report(rows: list[dict]) -> list[str]:
    """What a measured report must show against its declared columns:
    registers within the launch bounds' cap, static shared bytes the
    declared sum (within :data:`SMEM_SLACK` of alignment), at least one
    resident block an SM.  Returns the failures (empty: clean)."""
    bad = []
    for r in rows:
        if not r["measured"]:
            continue
        if r["registers"] > r["max_registers"]:
            bad.append(f"{r['name']}: {r['registers']} registers > the "
                       f"cap of {r['max_registers']}")
        got, want = r["static_smem_measured"], r["static_smem"]
        if not want <= got <= want + SMEM_SLACK:
            bad.append(f"{r['name']}: {got} static shared bytes, "
                       f"declared {want}")
        if r["blocks_per_sm"] < 1:
            bad.append(f"{r['name']}: no block fits an SM")
    return bad


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}K"
    return str(n)


def format_table(rows: list[dict]) -> str:
    """Render report rows as an aligned text table ("-": not measured)."""
    header = ("kernel", "name", "threads", "tile", "regs", "cap", "spill",
              "static", "dynamic", "blocks/SM")
    table = [header]
    for r in rows:
        table.append((
            r["kernel"], r["name"], str(r["threads"]), str(r["tile"]),
            "-" if r["registers"] is None else str(r["registers"]),
            str(r["max_registers"]),
            "-" if r["spill_bytes"] is None else str(r["spill_bytes"]),
            _fmt_bytes(r["static_smem_measured"]
                       if r["measured"] else r["static_smem"]),
            _fmt_bytes(r["dynamic_smem"]),
            "-" if r["blocks_per_sm"] is None else str(r["blocks_per_sm"])))
    widths = [max(len(row[i]) for row in table) for i in range(len(header))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def dump_json(rows: list[dict], path: str) -> None:
    """Write the report as JSON (the autotuner-consumable artifact)."""
    with open(path, "w") as fh:
        json.dump({"vmem_report": rows}, fh, indent=2, sort_keys=True)
        fh.write("\n")
