"""Parts 3-4 of the plan: the wrapper of ``csrc/pattern_build.cu``.

``pattern_build`` (the gathered entry: keys ``rows[perm]``,
``cols[perm]``) and ``pattern_build_sorted`` (the presorted entry of
``SparsePattern.update``'s merge: keys as given) return the plan's
``slot``, ``indices``, ``indptr``, ``nnz``, ``srows`` and ``scols``.
For a CPU tensor they run the plain version (:mod:`.ref`); for fake or
meta tensors (the dry run's trace) they return empty outputs of the
right shapes; for a CUDA tensor they launch the kernels
(:func:`pattern_build_kernel`, :func:`pattern_build_sorted_kernel`), or
raise: there is no fallback.  The gathered entry launches K0 first,
which interleaves ``rows`` and ``cols`` into ``(row, col)`` pairs where
``perm`` is scattered, so that K1 gathers one 8 B pair a position
instead of two words; then the pass (K1) and its tail (K2).  The
outputs, the descriptors and the ticket are allocated on the current
stream and nothing waits on the host, so a call captures into a CUDA
graph.  ``pattern_build.launches``
counts the calls that launched the kernels, through either entry.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import pattern_fields_ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}
_I32_MAX = 2**31 - 1


def _fns() -> dict:
    if not _FNS:
        lib = load_library("pattern_build")
        bind(lib, "pattern_tile", [])
        _FNS["tile"] = lib.pattern_tile()
        _FNS["perm"] = bind(lib, "pattern_from_perm_launch",
                            [_P] * 11 + [_LL, _I, _I, _LL, _I, _P])
        _FNS["sorted"] = bind(lib, "pattern_from_sorted_launch",
                              [_P] * 7 + [_LL, _I, _I, _LL, _P])
    return _FNS


def path(device) -> str:
    """``"plain"`` for a CPU tensor, ``"kernel"`` for any other."""
    return "plain" if torch.device(device).type == "cpu" else "kernel"


def _traced(*tensors) -> bool:
    """Fake or meta tensors, or a fake mode on: shapes without data."""
    mode = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    return mode is not None or any(
        isinstance(t, FakeTensor) or t.is_meta for t in tensors)


def _fields(slot, indices, indptr, nnz, srows, scols) -> dict:
    return {"slot": slot, "indices": indices, "indptr": indptr, "nnz": nnz,
            "srows": srows, "scols": scols}


def _shapes(like: torch.Tensor, N: int, nzmax: int) -> list:
    """Empty ``slot``, ``indices``, ``indptr`` and ``nnz``."""
    L = like.shape[0]
    return [like.new_empty(n) for n in ((L,), (nzmax,), (N + 1,), ())]


def pattern_build(rows: torch.Tensor, cols: torch.Tensor, perm: torch.Tensor,
                  *, M: int, N: int, nzmax: int) -> dict:
    """Parts 3-4 on the (col,row)-ordering permutation ``perm`` of the
    int32 triplet keys ``rows``/``cols``."""
    if rows.device.type == "cpu":
        return pattern_fields_ref(rows[perm], cols[perm], M=M, N=N,
                                  nzmax=nzmax)
    if _traced(rows, cols, perm):
        L = rows.shape[0]
        return _fields(*_shapes(rows, N, nzmax), rows.new_empty(L),
                       rows.new_empty(L))
    out = pattern_build_kernel(rows, cols, perm, M=M, N=N, nzmax=nzmax)
    del out["pairs"]
    return out


def pattern_build_sorted(r_s: torch.Tensor, c_s: torch.Tensor, *, M: int,
                         N: int, nzmax: int) -> dict:
    """Parts 3-4 on int32 keys already in (col,row) order."""
    if r_s.device.type == "cpu":
        return pattern_fields_ref(r_s, c_s, M=M, N=N, nzmax=nzmax)
    if _traced(r_s, c_s):
        return _fields(*_shapes(r_s, N, nzmax), r_s, c_s)
    return pattern_build_sorted_kernel(r_s, c_s, M=M, N=N, nzmax=nzmax)


def _check(keys, M: int, N: int, nzmax: int) -> int:
    """What both kernels need of their int32 key streams; returns L."""
    first = keys[0][1]
    L = first.shape[0]
    for name, t in keys:
        check_cuda_tensor(t, name, (torch.int32,))
        if t.ndim != 1 or t.shape[0] != L or t.device != first.device:
            raise ValueError(f"{name} must be 1-d of length {L} on "
                             f"{first.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if not 0 < L <= _I32_MAX:
        raise ValueError(f"need 0 < L < 2^31, got L={L}")
    if not (0 < M <= _I32_MAX and 0 < N < _I32_MAX
            and 0 <= nzmax <= _I32_MAX):
        raise ValueError(f"need 0 < M < 2^31, 0 < N < 2^31 - 1 and "
                         f"0 <= nzmax < 2^31, got M={M}, N={N}, "
                         f"nzmax={nzmax}")
    return L


def _scratch(L: int, device) -> torch.Tensor:
    """The zeroed scratch: the ticket, the total, K0's choice, then one
    descriptor a tile."""
    return torch.zeros(3 + cdiv(L, _fns()["tile"]), dtype=torch.int64,
                       device=device)


def pattern_build_kernel(rows, cols, perm, *, M: int, N: int, nzmax: int,
                         pairs: bool | None = None) -> dict:
    """K0, K1 and K2 on CUDA int32 ``rows``, ``cols`` and ``perm``.

    Besides the fields, ``"pairs"``: a 0-d device tensor, 1 where K1
    gathered K0's ``(row, col)`` pairs and 0 where it gathered the two
    key streams.  ``pairs=None`` lets K0 choose from its sample;
    ``True``/``False`` imposes the choice (the tests hold both gathers to
    the same outputs on every stream)."""
    L = _check((("rows", rows), ("cols", cols), ("perm", perm)), M, N, nzmax)
    force = -1 if pairs is None else int(pairs)
    srows, scols = torch.empty_like(rows), torch.empty_like(rows)
    work = torch.empty(2 * L, dtype=torch.int32, device=rows.device)
    out, scratch = _shapes(rows, N, nzmax), _scratch(L, rows.device)
    check_launch(_fns()["perm"](
        *(t.data_ptr() for t in (rows, cols, perm, work, srows, scols,
                                 *out, scratch)),
        L, M, N, nzmax, force, current_stream(rows.device)), "pattern_build")
    pattern_build.launches += 1
    return {**_fields(*out, srows, scols), "pairs": scratch[2]}


def pattern_build_sorted_kernel(r_s, c_s, *, M: int, N: int,
                                nzmax: int) -> dict:
    """K1 and K2 on CUDA int32 keys in (col,row) order."""
    L = _check((("r_s", r_s), ("c_s", c_s)), M, N, nzmax)
    out, scratch = _shapes(r_s, N, nzmax), _scratch(L, r_s.device)
    check_launch(_fns()["sorted"](
        *(t.data_ptr() for t in (r_s, c_s, *out, scratch)),
        L, M, N, nzmax, current_stream(r_s.device)), "pattern_build_sorted")
    pattern_build.launches += 1
    return _fields(*out, r_s, c_s)


pattern_build.launches = 0
