"""Two-phase assembly: symbolic ``SparsePattern`` plans + numeric fills.

Counterpart of ``repro/sparse/pattern.py``.  ``plan(rows, cols, shape)``
runs the paper's Parts 1-4 once and keeps what the numeric phase needs:

  perm    : int32[L]      (col,row)-ordered traversal permutation
  slot    : int32[L]      output slot of the k-th element of the sorted
                          stream; padding entries point at ``nzmax``
  indices : int32[nzmax]  final CSC row indices (``M`` in the tail)
  indptr  : int32[N+1]    column pointer
  nnz     : int32 0-d     structural nonzero count
  srows   : int32[L]      sorted row keys (``rows[perm]``)
  scols   : int32[L]      sorted col keys (``cols[perm]``)

``SparsePattern.assemble(vals)`` is then only the O(L) fill: on the
card the fused gather + mask + segment-sum kernel (B3') for ``sum`` and
``mean`` and the fused segment min/max kernel (B4) for ``min`` and
``max``, on the CPU their plain versions.  The fill is a
``torch.autograd.Function`` whose backward is the reference's
gather-by-slot through the stored plan.

Not ported yet: ``update``, ``reduce_rows``, ``plan_symmetric`` and the
structure detectors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.coo import COO
from ..core.csc import CSC, scatter_add
from ..kernels.common import resolve_device
from .dispatch import sorted_permutation

#: duplicate-combination modes of the numeric phase (the reference's)
ACCUM_MODES = ("sum", "min", "max", "mean", "first", "last")


@dataclasses.dataclass(frozen=True)
class SparsePattern:
    """Symbolic assembly plan: the paper's intermediate format, cached.

    ``shape``, ``accum`` and ``epoch`` are plain python values; every
    other field is an int32 tensor on the plan's device.
    """

    perm: torch.Tensor     # int32[L]
    slot: torch.Tensor     # int32[L]; nzmax marks dropped (padding) inputs
    indices: torch.Tensor  # int32[nzmax]; M sentinel in the padded tail
    indptr: torch.Tensor   # int32[N+1]
    nnz: torch.Tensor      # int32 0-d
    srows: torch.Tensor    # int32[L]; sorted row keys (= rows[perm])
    scols: torch.Tensor    # int32[L]; sorted col keys (= cols[perm])
    shape: tuple[int, int]
    accum: str = "sum"
    epoch: int = 0

    @property
    def L(self) -> int:
        return int(self.perm.shape[-1])

    @property
    def nzmax(self) -> int:
        return int(self.indices.shape[-1])

    @property
    def M(self) -> int:
        return int(self.shape[0])

    @property
    def N(self) -> int:
        return int(self.shape[1])

    def assemble(self, vals: torch.Tensor, *,
                 accum: str | None = None) -> CSC:
        """Numeric fill: ``vals`` (length L, aligned with the planned
        triplets) combined per output slot.  Differentiable."""
        return self._csc(self.scatter(vals, accum=accum))

    def assemble_batch(self, vals_batch: torch.Tensor, *,
                       accum: str | None = None) -> CSC:
        """Fill of many value vectors ``[B, L]`` sharing this structure.

        The batch dimension is written out: one fill per row, stacked
        into ``data[B, nzmax]``; ``indices``/``indptr``/``nnz`` stay
        unbatched.
        """
        data = [self.scatter(v, accum=accum) for v in vals_batch]
        if not data:
            data = vals_batch.new_zeros((0, self.nzmax),
                                        dtype=fill_dtype(vals_batch))
        else:
            data = torch.stack(data)
        return self._csc(data)

    def scatter(self, vals: torch.Tensor, *,
                accum: str | None = None) -> torch.Tensor:
        """The raw O(L) numeric phase: ``data`` only (``prS``)."""
        accum = validate_accum(self.accum if accum is None else accum,
                               vals.dtype)
        self.check_vals(vals)
        return _Scatter.apply(vals.to(fill_dtype(vals)), self.perm,
                              self.slot, self.nzmax, accum)

    def check_vals(self, vals: torch.Tensor) -> None:
        """Raise unless ``vals`` is one length-L vector: the fill kernels
        read ``vals[perm[k]]`` with no bounds check."""
        if vals.ndim != 1 or vals.shape[0] != self.L:
            raise ValueError(
                f"vals has shape {tuple(vals.shape)} but this pattern was "
                f"planned for a length-L={self.L} vector; use "
                "assemble_batch for batched fills"
            )

    def _csc(self, data: torch.Tensor) -> CSC:
        return CSC(data=data, indices=self.indices, indptr=self.indptr,
                   nnz=self.nnz, shape=self.shape)


def fill_dtype(vals) -> torch.dtype:
    """Numeric-phase value dtype: float/complex dtypes pass through,
    integers promote once to float32.  Accepts a tensor or a dtype."""
    dtype = getattr(vals, "dtype", vals)
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float32


def accum_dtype(dtype) -> torch.dtype:
    """Duplicate-accumulator dtype: bf16/f16 sum in float32 (a 16-bit
    running sum saturates near 256), others in their own dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def first_flags(slot: torch.Tensor, nzmax: int) -> torch.Tensor:
    """First occurrence of every kept slot (``slot < nzmax``) in the
    sorted stream."""
    prev = torch.cat([slot.new_full((1,), -1), slot[:-1]])
    return (slot < nzmax) & (slot != prev)


def last_flags(slot: torch.Tensor, nzmax: int) -> torch.Tensor:
    """Last occurrence of every kept slot in the sorted stream."""
    nxt = torch.cat([slot[1:], slot.new_full((1,), -1)])
    return (slot < nzmax) & (slot != nxt)


def validate_accum(accum: str, dtype=None) -> str:
    """Check an ``accum`` mode name (and its dtype compatibility)."""
    if accum not in ACCUM_MODES:
        raise ValueError(
            f"unknown accum mode {accum!r}; expected one of {ACCUM_MODES}"
        )
    if dtype is not None and accum in ("min", "max") and dtype.is_complex:
        raise ValueError(
            f"accum={accum!r} is undefined for complex values "
            "(no total order); use 'sum'/'mean'/'first'/'last'"
        )
    return accum


def accum_identity(accum: str, dtype) -> torch.Tensor:
    """Neutral element of an ``accum`` mode for ``dtype`` (inexact)."""
    if accum == "min":
        return torch.tensor(float("inf"), dtype=dtype)
    if accum == "max":
        return torch.tensor(float("-inf"), dtype=dtype)
    return torch.zeros((), dtype=dtype)


def _slot_counts(nzmax: int, slot: torch.Tensor) -> torch.Tensor:
    """Valid duplicate count per output slot (padding dropped).

    Dropped entries count into one scratch slot past the end, here and
    in the first/last fill: no boolean-mask compaction, so no
    synchronisation with the device.
    """
    return scatter_add(nzmax, slot, torch.ones_like(slot), slot < nzmax,
                       scratch=1)


def _scatter_reduce(nzmax: int, accum: str, perm, slot, vals):
    """Forward of the fill under every ``accum`` mode: B3' (``sum``,
    ``mean``) or B4 (``min``, ``max``) on the card, their plain versions
    on the CPU, a scatter for ``first``/``last``
    (:func:`repro_torch.kernels.segment_sum.ops
    .gather_segment_reduce_sorted`)."""
    # lazy: the kernel family's ops module imports this one
    from ..kernels.segment_sum.ops import gather_segment_reduce_sorted

    return gather_segment_reduce_sorted(vals, perm, slot, accum=accum,
                                        num_segments=nzmax)


class _Scatter(torch.autograd.Function):
    """Differentiable numeric phase.

    Every mode's output is ``data[s] = sum_k w_k * v_k`` with per-element
    weights (1 for sum, 1/count for mean, a 0/1 selection for
    min/max/first/last), so one backward covers them all:
    ``g_vals[perm[k]] = w_k * g_data[slot[k]]``, a padding-masked
    gather-by-slot and a collision-free scatter through the permutation.
    min/max route the gradient to the *first* attaining element of each
    duplicate group (the reference's deterministic subgradient), which
    needs the values and the result kept from the forward.
    """

    @staticmethod
    def forward(ctx, vals, perm, slot, nzmax, accum):
        out = _scatter_reduce(nzmax, accum, perm, slot, vals)
        if accum in ("min", "max"):
            ctx.save_for_backward(perm, slot, vals, out)
        else:
            ctx.save_for_backward(perm, slot)
        ctx.nzmax, ctx.accum = nzmax, accum
        return out

    @staticmethod
    def backward(ctx, g):
        perm, slot = ctx.saved_tensors[:2]
        nzmax, accum = ctx.nzmax, ctx.accum
        valid = slot < nzmax
        if nzmax == 0:
            g_sorted = g.new_zeros(slot.shape)
        else:
            slot_c = slot.clamp(0, nzmax - 1)
            g_sorted = torch.where(valid, g[slot_c], 0)
            if accum == "mean":
                n = _slot_counts(nzmax, slot).clamp(min=1).to(g.dtype)
                g_sorted = g_sorted / n[slot_c]
            elif accum in ("first", "last"):
                keep = first_flags(slot, nzmax) if accum == "first" \
                    else last_flags(slot, nzmax)
                g_sorted = torch.where(keep, g_sorted, 0)
            elif accum in ("min", "max"):
                vals, out = ctx.saved_tensors[2:]
                L = perm.shape[0]
                attained = valid & (vals[perm] == out[slot_c])
                pos = torch.where(attained, torch.arange(L, device=g.device),
                                  L)
                first_pos = torch.full((nzmax + 1,), L, dtype=torch.int64,
                                       device=g.device)
                first_pos.scatter_reduce_(
                    0, torch.where(valid, slot, nzmax).long(), pos, "amin")
                winner = attained & (pos == first_pos[slot_c])
                g_sorted = torch.where(winner, g_sorted, 0)
        g_vals = torch.empty_like(g_sorted)
        g_vals[perm] = g_sorted  # perm is a permutation of [0, L)
        return g_vals, None, None, None, None


def pattern_from_perm(rows, cols, perm, *, M: int, N: int,
                      nzmax: int) -> SparsePattern:
    """Parts 3-4 on an already (col,row)-ordered permutation."""
    return pattern_from_sorted(rows[perm], cols[perm], perm, M=M, N=N,
                               nzmax=nzmax)


def pattern_from_sorted(r_s, c_s, perm, *, M: int, N: int,
                        nzmax: int) -> SparsePattern:
    """Parts 3-4 on an already-sorted key stream (``L >= 1``).

    ``r_s``/``c_s`` are the (col,row)-ordered int32 keys and ``perm``
    maps sorted position back to input position.  Phrased gather-side,
    as the reference: cumsum of the boundary flags, then two
    searchsorted lookups.
    """
    dev = r_s.device
    L = r_s.shape[0]
    r_s = r_s.to(torch.int32).contiguous()
    c_s = c_s.to(torch.int32).contiguous()
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
    return SparsePattern(
        perm=perm.to(torch.int32), slot=slot,
        indices=indices.to(torch.int32), indptr=indptr,
        nnz=indptr[-1].clone(), srows=r_s, scols=c_s, shape=(M, N),
    )


def trivial_pattern(L: int, shape: tuple[int, int], *,
                    nzmax: int | None = None, accum: str = "sum",
                    device=None) -> SparsePattern:
    """All-zero (Matlab empty-matrix) plan: every input is padding.

    The structure ``fsparse([], [], [], m, n)`` and the degenerate
    ``M == 0`` / ``N == 0`` shapes produce, built without any kernel: a
    kernel grid of size 0 is a launch error.
    """
    M, N = int(shape[0]), int(shape[1])
    nzmax = L if nzmax is None else nzmax
    device = resolve_device(device)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    return SparsePattern(
        perm=torch.arange(L, dtype=torch.int32, device=device),
        slot=full(L, nzmax), indices=full(nzmax, M), indptr=full(N + 1, 0),
        nnz=torch.zeros((), dtype=torch.int32, device=device),
        srows=full(L, 0), scols=full(L, 0), shape=(M, N), accum=accum,
    )


def plan(rows, cols, shape: tuple[int, int], *, nzmax: int | None = None,
         method: str | None = None, accum: str = "sum",
         nzmax_slack: int = 0) -> SparsePattern:
    """Symbolic phase: run the paper's Parts 1-4 once, keep the plan.

    ``rows``/``cols`` are zero-offset int tensors of equal length L
    (``row == shape[0]`` marks padding); the plan lives on their device.
    ``method`` selects the sort backend (``"jnp" | "fused" | "radix"``,
    see :mod:`repro_torch.sparse.dispatch`; ``None`` is ``"radix"`` on
    the card and ``"fused"`` on the CPU).  ``nzmax`` defaults to
    ``L + nzmax_slack``.
    """
    rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
    M, N = int(shape[0]), int(shape[1])
    L = rows.shape[0]
    nzmax = L + int(nzmax_slack) if nzmax is None else nzmax
    validate_accum(accum)
    if L == 0 or M == 0 or N == 0:
        return trivial_pattern(L, (M, N), nzmax=nzmax, accum=accum,
                               device=rows.device)
    rows = rows.to(torch.int32).contiguous()
    cols = cols.to(torch.int32).contiguous()
    perm = sorted_permutation(rows, cols, M=M, N=N, method=method)
    pat = pattern_from_perm(rows, cols, perm, M=M, N=N, nzmax=nzmax)
    return pat if accum == "sum" else dataclasses.replace(pat, accum=accum)


def plan_coo(coo: COO, *, nzmax: int | None = None,
             method: str | None = None, accum: str = "sum",
             nzmax_slack: int = 0) -> SparsePattern:
    """``plan`` over a :class:`repro_torch.core.coo.COO` container."""
    return plan(coo.rows, coo.cols, coo.shape, nzmax=nzmax, method=method,
                accum=accum, nzmax_slack=nzmax_slack)


_FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")


def pattern_from_arrays(fields: dict[str, np.ndarray], shape, accum="sum",
                        epoch=0, device=None) -> SparsePattern:
    """A reference ``SparsePattern``, given as numpy arrays, as the port's.

    ``fields`` maps each of ``perm``, ``slot``, ``indices``, ``indptr``,
    ``nnz``, ``srows`` and ``scols`` to an array (for example
    ``np.asarray(getattr(jax_pattern, k))``).  A plan made by the JAX
    package can then be filled by the port.  ``device`` is ``"cuda"``
    unless the caller passes another.
    """
    device = resolve_device(device)
    return SparsePattern(
        **{k: torch.from_numpy(np.array(fields[k], np.int32)).to(device)
           for k in _FIELDS},
        shape=(int(shape[0]), int(shape[1])), accum=validate_accum(accum),
        epoch=int(epoch),
    )
