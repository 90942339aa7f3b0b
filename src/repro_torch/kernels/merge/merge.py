"""Wrapper of the merge positioning kernel B7 (``csrc/merge.cu``).

``merge_search_kernel`` computes what the Pallas ``merge_search_pallas``
of ``repro/kernels/merge/merge.py`` computes: each query's insertion
offset in a ``(col, row)``-sorted target stream, in the shape
:func:`.ref.merge_shape` names for ``Lq`` and ``n``.  Where the queries
are about as many as the targets (``"dense"``) a block of them narrows
the search together (its least and greatest key, splitters in shared
memory) before each query finishes on its own interval
(:func:`.ref.merge_search_narrowed_ref` is that route in plain
PyTorch).  Elsewhere one thread a query walks the ladder, reading the
row only on a column tie (``"sparse"``: few queries into targets past
the L2) or both arrays at every probe (``"ladder"``).
There is no residency budget: the targets are read from device memory,
so every ``n`` is served.  It takes its plain version (:mod:`.ref`) for a
CPU tensor and launches the kernel for a CUDA tensor; ``.launches``
counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from ...sparse import tuning
from ..common import (bind, cdiv, check_cuda_tensor, check_launch,
                      current_stream, load_library)
from .ref import (BLOCK_Q, SHAPES, _check_side, merge_search_ref,
                  merge_shape)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FNS: dict = {}


def _fn():
    if not _FNS:
        lib = load_library("merge")
        built = tuning.build_knobs("merge")
        for fn, want in (("merge_block_queries", built["block_q"]),
                         ("merge_splitters", built["splitters"])):
            bind(lib, fn, [])
            if getattr(lib, fn)() != want:
                raise RuntimeError(f"csrc/merge.cu: {fn}() differs from "
                                   "the merge tuning spec")
        # the C side's own choice (shape -1) follows the priors
        bind(lib, "merge_shape", [_LL, _I])
        prior = tuning.prior_policy("merge", "cuda")
        knobs = {k: prior[k] for k in ("dense_ratio", "sparse_ratio",
                                       "sparse_targets")}
        for Lq, n in ((1, 1), (2, 8), (2, 9), (10, 2**23 - 1), (10, 2**23),
                      (2**19, 2**23), (2**19 - 1, 2**23)):
            if SHAPES[lib.merge_shape(Lq, n)] != merge_shape(Lq, n, **knobs):
                raise RuntimeError("csrc/merge.cu: merge_shape() differs "
                                   "from the merge tuning priors")
        _FNS["search"] = bind(lib, "merge_search_launch",
                              [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P])
    return _FNS["search"]


def merge_search_kernel(q_rows: torch.Tensor, q_cols: torch.Tensor,
                        t_rows: torch.Tensor, t_cols: torch.Tensor, *,
                        side: str = "left", shape: str | None = None
                        ) -> torch.Tensor:
    """B7: int32 ``[Lq]`` offsets of the queries in the sorted targets.

    All four inputs are contiguous int32 vectors on one card, the
    queries of one length, the targets of another, at most ``2^31 - 1``
    long.  ``n == 0`` or ``Lq == 0`` returns zeros with no launch (a
    zero grid is a launch error).  ``shape`` (``"dense"``, ``"sparse"``
    or ``"ladder"``) defaults to :func:`.ref.merge_shape` under the
    resolved ``merge`` tuning policy; every shape gives the same offsets.
    """
    if q_rows.device.type == "cpu":
        return merge_search_ref(q_rows, q_cols, t_rows, t_cols, side=side)
    _check_side(side)
    for t, name in ((q_rows, "q_rows"), (q_cols, "q_cols"),
                    (t_rows, "t_rows"), (t_cols, "t_cols")):
        check_cuda_tensor(t, name, (torch.int32,))
        if t.ndim != 1 or t.device != q_rows.device:
            raise ValueError(f"{name} must be a 1-d vector on "
                             f"{q_rows.device}")
    Lq, n = q_rows.shape[0], t_rows.shape[0]
    if q_cols.shape[0] != Lq or t_cols.shape[0] != n:
        raise ValueError(
            f"query vectors ({Lq}, {q_cols.shape[0]}) or target vectors "
            f"({n}, {t_cols.shape[0]}) differ in length")
    if n == 0 or Lq == 0:
        return torch.zeros(Lq, dtype=torch.int32, device=q_rows.device)
    out = torch.empty(Lq, dtype=torch.int32, device=q_rows.device)
    if n >= 2**31 or cdiv(Lq, BLOCK_Q) >= 2**31:
        raise ValueError(f"streams too large for B7: Lq = {Lq}, n = {n}")
    shape = merge_shape(Lq, n, backend=q_rows.device) if shape is None \
        else shape
    check_launch(_fn()(
        q_rows.data_ptr(), q_cols.data_ptr(), t_rows.data_ptr(),
        t_cols.data_ptr(), out.data_ptr(), Lq, n, int(side == "right"),
        SHAPES.index(shape), current_stream(q_rows.device)),
        "merge_search")
    merge_search_kernel.launches += 1
    return out


merge_search_kernel.launches = 0
