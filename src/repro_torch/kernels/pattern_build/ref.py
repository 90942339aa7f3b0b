"""Plain-PyTorch versions of Parts 3-4 of the plan (``csrc/pattern_build.cu``).

``pattern_fields_ref`` is the plain version the wrapper takes for a CPU
tensor: the reference's gather-side phrasing
(``repro/sparse/pattern.py:pattern_from_sorted``), a cumsum of the
boundary flags and two ``searchsorted`` lookups, every shape static (the
dry run traces it on fake tensors).
"""
from __future__ import annotations

import torch


def pattern_fields_ref(r_s: torch.Tensor, c_s: torch.Tensor, *, M: int,
                       N: int, nzmax: int) -> dict:
    """``slot``, ``indices``, ``indptr`` and ``nnz`` of the (col,row)-sorted
    int32 keys ``r_s``/``c_s`` (``L >= 1``), with the keys themselves as
    ``srows``/``scols``."""
    dev = r_s.device
    L = r_s.shape[0]
    valid = r_s < M
    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (c_s[1:] != c_s[:-1]) | (r_s[1:] != r_s[:-1]),
    ]) & valid
    cum_first = torch.cumsum(first, 0, dtype=torch.int32)
    cum0 = torch.cat([cum_first.new_zeros(1), cum_first])
    # column j's pointer = uniques strictly before its first position
    col_bnd = torch.searchsorted(
        c_s, torch.arange(N + 1, dtype=torch.int32, device=dev),
        side="left", out_int32=True)
    indptr = cum0[col_bnd]
    slot = torch.where(valid, cum_first - 1, nzmax).to(torch.int32)
    # row of the s-th unique = r_s where cum_first first reaches s+1;
    # s >= nnz searches past the stream and gets the sentinel M
    upos = torch.searchsorted(
        cum_first, torch.arange(1, nzmax + 1, dtype=torch.int32, device=dev),
        side="left", out_int32=True)
    indices = torch.where(upos < L, r_s[upos.clamp(max=L - 1)], M)
    return {"slot": slot, "indices": indices.to(torch.int32),
            "indptr": indptr, "nnz": indptr[-1].clone(), "srows": r_s,
            "scols": c_s}
