"""Device times of B11 (counting-sort placement) and B5 (prefix sum) on
the card, on ``chip_smoke.py``'s inputs, next to their library calls.

    python3 kernel_times.py

Set 2 of Table 4.1 (L = 2.5e6) and the 5e7 set: B11 on the counting
sort's first pass (the coo rows, M + 1 bins, a handed-over table as the
counting sort calls it), B5 on L random float32 values.  Each kernel is
first held against its plain version (B11 bit for bit, B5 within 64 eps
of the running sum of |x|).  Prints the card's name and power limit, then
one JSON line a set.  A quicker measure than ``chip_smoke.py`` when two
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
    from repro_torch.kernels.hist.ops import block_offsets, default_block_b
    from repro_torch.kernels.segment_sum.ref import blocked_cumsum_ref
    from repro_torch.kernels.segment_sum.segment_sum import blocked_cumsum

    print(smoke.nvidia_smi_line(), flush=True)
    logs = common.build(["hist", "counting_sort", "segment_sum"])
    for lib, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                print(f"ptxas[{lib}]: {line.strip()}", flush=True)
    cpm = smoke.sleep_cycles_per_ms()
    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED)
    for name, cfg in (("2", DATA_SETS[2]), ("2x20", smoke.BIG)):
        ii, jj, ss, siz = ransparse(cfg["siz"], cfg["nnz_row"], cfg["nrep"],
                                    seed=smoke.SEED)
        rows = coo_from_matlab(ii, jj, ss, (siz, siz)).rows
        L = rows.shape[0]
        cnt = dict(nbins=siz + 1, block_b=default_block_b(siz + 1))
        offsets, _ = block_offsets(rows, **cnt)
        smoke.require(torch.equal(placement(rows, offsets, **cnt),
                                  placement_ref(rows, offsets, **cnt)),
                      f"B11 differs, set {name}")
        handed = offsets.clone()
        x = torch.from_numpy(rng.standard_normal(L)).to(dev, torch.float32)
        err = (blocked_cumsum(x) - blocked_cumsum_ref(x)).abs().double()
        tol = 64 * smoke.EPS32 * torch.cumsum(x.abs().double(), 0)
        smoke.require(bool(torch.all(err <= tol)), f"B5 error, set {name}")
        print(json.dumps({
            "set": name, "L": L, **cnt,
            "B11_ms": smoke.device_ms(
                lambda: placement(rows, handed, consume_offsets=True, **cnt),
                cpm),
            "sort_stable_ms": smoke.device_ms(
                lambda: torch.sort(rows, stable=True), cpm),
            "B5_f32_ms": smoke.device_ms(lambda: blocked_cumsum(x), cpm),
            "cumsum_f32_ms": smoke.device_ms(lambda: torch.cumsum(x, 0),
                                             cpm),
        }), flush=True)
        del ii, jj, ss, rows, offsets, handed, x, err, tol
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
