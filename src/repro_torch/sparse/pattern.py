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

``SparsePattern.update`` merges a sorted delta into the plan's sorted
stream (the delta sorted by the planner backend, positioned by the
merge search B7, then the shared Parts 3-4), bit-identical to a fresh
``plan`` of the concatenated triplets.  ``plan_symmetric`` plans only
the strict upper half of a structurally symmetric stream
(:class:`SymPattern`); ``detect_symmetry``, ``detect_block`` and
``pattern_symmetric`` (two B7 probes over a plan) detect structure.

``SparsePattern.reduce_rows`` is the fill of row-valued triplets
(``[L, D] -> [nzmax, D]``, the embedding gradient's reduction), by
PyTorch's scatters on any device, with the same backward.

Under ``REPRO_VALIDATE=1`` every rewritten plan ``update`` returns is
validated (:mod:`repro_torch.sparse.analysis.invariants`).
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import torch

from .. import obs
from ..core.coo import COO
from ..core.csc import CSC, scatter_add
from ..kernels.common import resolve_device
from ..kernels.pattern_build.ops import (path, pattern_build,
                                         pattern_build_sorted)
from .dispatch import merge_search, resolve_method, sorted_permutation
from .errors import CapacityWarning

#: duplicate-combination modes of the numeric phase (the reference's)
ACCUM_MODES = ("sum", "min", "max", "mean", "first", "last")


@dataclasses.dataclass(frozen=True)
class SparsePattern:
    """Symbolic assembly plan: the paper's intermediate format, cached.

    ``shape``, ``accum`` and ``epoch`` are plain python values; every
    other field is an int32 tensor on the plan's device.  ``epoch``
    counts structure rewrites: :meth:`update` returns a plan with
    ``epoch + 1`` so dependent caches can tell a rewritten structure
    from the one they were built against.  It is a plain int; the
    capture audit (:class:`~repro_torch.sparse.analysis.RetraceAuditor`)
    captures a fill again when it changes, as a retrace would.
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

    @property
    def first(self) -> torch.Tensor:
        """Boundary flags of the sorted stream (Part 3 output)."""
        return first_flags(self.slot, self.nzmax)

    def irank(self) -> torch.Tensor:
        """Original-input-order output slots: the paper's eq. (2.2-2.3)."""
        out = torch.zeros(self.L, dtype=torch.int32, device=self.perm.device)
        out[self.perm.long()] = self.slot.clamp(max=self.nzmax - 1)
        return out

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
        with obs.span("fill") as span:
            accum = validate_accum(self.accum if accum is None else accum,
                                   vals.dtype)
            if span:
                span.set(accum=accum, dtype=vals.dtype)
            self.check_vals(vals)
            return _Scatter.apply(vals.to(fill_dtype(vals)), self.perm,
                                  self.slot, self.nzmax, accum)

    def reduce_rows(self, mat: torch.Tensor, *,
                    accum: str | None = None) -> torch.Tensor:
        """Segment-reduce a row-per-triplet matrix ``[L, D] -> [nzmax, D]``.

        The generalisation of :meth:`scatter` to vector-valued triplets
        (e.g. embedding-gradient rows): duplicates of one (i, j) pair
        combine row-wise (elementwise for min/max) into one slot under
        the plan's ``accum`` mode.  Differentiable with the same
        gather-by-slot backward as :meth:`scatter`; the dtype passes
        through unchanged, hence min/max need an inexact dtype.

        The reduction is PyTorch's ``index_add_`` (sum, mean),
        ``scatter_reduce_`` (min, max) and ``index_put_`` (first, last)
        on ``mat[perm]`` by slot, on the CPU and on the card.  min, max,
        first and last are exact.  A sum adds its terms in an order the
        card does not fix: it is bit for bit on integer-valued rows
        (every partial sum exact), and otherwise each slot lies within
        ``(n_s - 1) * eps * sum|terms|`` of the exact sum, ``n_s`` the
        slot's number of terms, ``eps`` that of the accumulator (float32
        for 16-bit rows); a mean adds one rounding.
        """
        accum = validate_accum(self.accum if accum is None else accum,
                               mat.dtype)
        if accum in ("min", "max") and not (mat.dtype.is_floating_point
                                            or mat.dtype.is_complex):
            raise ValueError(
                f"reduce_rows(accum={accum!r}) needs an inexact dtype "
                f"(got {str(mat.dtype).removeprefix('torch.')}); cast the "
                "rows first"
            )
        if mat.shape[0] != self.L:
            raise ValueError(
                f"mat has {mat.shape[0]} rows but this pattern was "
                f"planned for L={self.L} triplets"
            )
        return _Scatter.apply(mat, self.perm, self.slot, self.nzmax, accum,
                              True)

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

    # -- incremental symbolic phase ---------------------------------------
    def _input_keys(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Original input-order ``(rows, cols)``, on the plan's device.

        ``perm`` is a permutation of the input stream and ``srows``/
        ``scols`` are its sorted image, so one scatter inverts exactly:
        the full re-plan fallback of :meth:`update` rebuilds the
        concatenated triplet stream from this.
        """
        perm = self.perm.long()
        rows = torch.empty_like(self.srows)
        cols = torch.empty_like(self.scols)
        rows[perm] = self.srows
        cols[perm] = self.scols
        return rows, cols

    def update(self, add_rows, add_cols, drop_mask=None, *,
               nzmax: int | None = None, method: str | None = None,
               merge_method: str | None = None) -> "SparsePattern":
        """Incremental re-plan: merge a delta stream into this plan.

        ``add_rows``/``add_cols`` are zero-offset index vectors of new
        triplets (``row == M`` marks padding, exactly like :func:`plan`;
        numpy arrays or tensors); ``drop_mask`` is an optional boolean
        vector over the *original input order* (length L) marking
        triplets to remove.  The result is **bit-identical** to a fresh
        ``plan()`` over the concatenated (surviving + delta) stream, for
        every sort backend, but only the delta is sorted (``method=``,
        the radix planner on the card): the surviving sorted stream is
        kept and the delta is positioned by the merge search
        (``merge_method=``, B7 on the card; see
        :mod:`repro_torch.sparse.dispatch`), then ``perm``/``slot``/
        ``indices``/``indptr`` are rewritten in O(L + L_delta).  Every
        step runs on the plan's device.

        Capacity: an explicit ``nzmax=`` wins; otherwise the plan's own
        ``nzmax`` is kept while the merged stream fits, and once the
        headroom is exhausted the call degrades to a full re-plan with a
        one-time :class:`~repro_torch.sparse.errors.CapacityWarning`
        (pre-reserve headroom with ``plan(..., nzmax_slack=)``).  An
        empty update (no delta, no effective drops) returns ``self``
        unchanged: no kernel launch, no epoch bump.  Updating a trivial
        (empty/zero-dim) plan degrades to a plain ``plan()``.  The
        returned pattern's ``epoch`` is ``self.epoch + 1``.
        """
        M, N = self.M, self.N
        L = self.L
        dev = self.perm.device
        ar, ac = _index_tensor(add_rows), _index_tensor(add_cols)
        if ar.ndim != 1 or ar.shape != ac.shape:
            raise ValueError(
                f"add_rows/add_cols must be equal-length 1-d vectors; "
                f"got shapes {tuple(ar.shape)} and {tuple(ac.shape)}"
            )
        ar = ar.to(dev, torch.int32).contiguous()
        ac = ac.to(dev, torch.int32).contiguous()
        L_delta = int(ar.shape[0])
        dm = None
        n_drop = 0
        if drop_mask is not None:
            dm = _index_tensor(drop_mask)
            if tuple(dm.shape) != (L,):
                raise ValueError(
                    f"drop_mask has shape {tuple(dm.shape)} but this "
                    f"pattern was planned for L={L} input triplets"
                )
            dm = dm.to(dev, torch.bool)
            n_drop = int(dm.sum())
            if n_drop == 0:
                dm = None
        if L_delta == 0 and n_drop == 0:
            return self
        L_keep = L - n_drop
        L_new = L_keep + L_delta
        headroom = max(0, self.nzmax - L)
        if nzmax is not None:
            new_nzmax = int(nzmax)
            fallback = False
        elif L_new <= self.nzmax:
            new_nzmax = self.nzmax
            fallback = False
        else:
            new_nzmax = L_new + headroom
            fallback = True
        bump = dict(accum=self.accum, epoch=self.epoch + 1)
        if L_new == 0:
            return _maybe_validated(dataclasses.replace(
                trivial_pattern(0, (M, N), nzmax=new_nzmax, device=dev),
                **bump))
        if fallback:
            global _UPDATE_FALLBACK_WARNED
            if not _UPDATE_FALLBACK_WARNED and L and M and N:
                _UPDATE_FALLBACK_WARNED = True
                warnings.warn(
                    f"SparsePattern.update: the merged stream "
                    f"(L={L_new}) exceeds this plan's nzmax="
                    f"{self.nzmax} growth headroom — falling back to a "
                    "full re-plan over the concatenated triplets. "
                    "Pre-reserve capacity with plan(..., nzmax_slack=) "
                    "(or fsparse/sparse2 nzmax_slack=) to keep updates "
                    "on the O(L + L_delta) merge path.",
                    CapacityWarning,
                    stacklevel=2,
                )
        if fallback or L == 0 or M == 0 or N == 0:
            # a trivial base (an empty stream, or a zero-dim shape where
            # structure is key-independent) has nothing to merge against;
            # past the headroom the whole stream is planned again
            rows0, cols0 = self._input_keys()
            if dm is not None:
                rows0, cols0 = rows0[~dm], cols0[~dm]
            pat = plan(torch.cat([rows0, ar]), torch.cat([cols0, ac]),
                       (M, N), nzmax=new_nzmax, method=method)
            return _maybe_validated(dataclasses.replace(pat, **bump))
        # -- merge path: survivors stay sorted, only the delta sorts ----
        if dm is None:
            sr_a, sc_a, pa = self.srows, self.scols, self.perm
        else:
            # the new input position of survivor p is p minus the
            # dropped positions below it (the fresh concatenated stream
            # the merge must stay bit-identical to renumbers this way)
            perm = self.perm.long()
            d = dm.to(torch.int64)
            shift = torch.cumsum(d, 0) - d
            keep_sorted = ~dm[perm]
            pa = (perm - shift[perm])[keep_sorted].to(torch.int32)
            sr_a = self.srows[keep_sorted]
            sc_a = self.scols[keep_sorted]
        pat = _merge_sorted_streams(
            sr_a, sc_a, pa, ar, ac, L_keep, M=M, N=N, nzmax=new_nzmax,
            method=method, merge_method=merge_method)
        return _maybe_validated(dataclasses.replace(pat, **bump))


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


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-pad a 1-d tensor with singleton axes up to ``ndim`` dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 1))


def _reduce_rows(nzmax: int, accum: str, perm, slot, mat):
    """Forward of :meth:`SparsePattern.reduce_rows`: PyTorch's scatters
    on ``mat[perm]`` by slot, with a scratch row past the end for the
    padding (the reference's ``mode="drop"``)."""
    v = mat[perm.long()]
    valid = slot < nzmax
    if accum in ("sum", "mean"):
        acc = accum_dtype(v.dtype)
        s = scatter_add(nzmax, slot, v.to(acc), valid)
        if accum == "sum":
            return s.to(v.dtype)
        n = _slot_counts(nzmax, slot).clamp(min=1).to(acc)
        return (s / _bcast(n, s.ndim)).to(v.dtype)
    idx = torch.where(valid, slot, nzmax).long()
    if accum in ("min", "max"):
        red = torch.full((nzmax + 1,) + tuple(v.shape[1:]),
                         accum_identity(accum, v.dtype).item(),
                         dtype=v.dtype, device=v.device)
        red.scatter_reduce_(0, _bcast(idx, v.ndim).expand_as(v), v,
                            "amin" if accum == "min" else "amax")
        occupied = _bcast(_slot_counts(nzmax, slot) > 0, v.ndim)
        return torch.where(occupied, red[:nzmax], 0)
    keep = first_flags(slot, nzmax) if accum == "first" \
        else last_flags(slot, nzmax)
    out = v.new_zeros((nzmax + 1,) + tuple(v.shape[1:]))
    out[torch.where(keep, slot, nzmax).long()] = v
    return out[:nzmax]


def _scatter_grad(g, perm, slot, nzmax: int, accum: str, vals=None,
                  out=None):
    """``g_vals[perm[k]] = w_k * g[slot[k]]`` for a fill's output
    gradient ``g`` (``[nzmax, ...]``); see :class:`_Scatter`."""
    L = perm.shape[0]
    valid = slot < nzmax
    if nzmax == 0:
        g_sorted = g.new_zeros((L,) + tuple(g.shape[1:]))
    else:
        slot_c = slot.clamp(0, nzmax - 1)
        g_sorted = torch.where(_bcast(valid, g.ndim), g[slot_c], 0)
        if accum == "mean":
            n = _slot_counts(nzmax, slot).clamp(min=1).to(g.dtype)
            g_sorted = g_sorted / _bcast(n[slot_c], g.ndim)
        elif accum in ("first", "last"):
            keep = first_flags(slot, nzmax) if accum == "first" \
                else last_flags(slot, nzmax)
            g_sorted = torch.where(_bcast(keep, g.ndim), g_sorted, 0)
        elif accum in ("min", "max"):
            v = vals[perm]
            attained = _bcast(valid, v.ndim) & (v == out[slot_c])
            pos = torch.where(
                attained, _bcast(torch.arange(L, device=g.device), v.ndim), L)
            first_pos = torch.full((nzmax + 1,) + tuple(v.shape[1:]), L,
                                   dtype=torch.int64, device=g.device)
            first_pos.scatter_reduce_(
                0, _bcast(torch.where(valid, slot, nzmax).long(),
                          v.ndim).expand_as(pos), pos, "amin")
            winner = attained & (pos == first_pos[slot_c])
            g_sorted = torch.where(winner, g_sorted, 0)
    g_vals = torch.empty_like(g_sorted)
    g_vals[perm] = g_sorted  # perm is a permutation of [0, L)
    return g_vals


class _Scatter(torch.autograd.Function):
    """Differentiable numeric phase.

    Every mode's output is ``data[s] = sum_k w_k * v_k`` with per-element
    weights (1 for sum, 1/count for mean, a 0/1 selection for
    min/max/first/last), so one backward covers them all:
    ``g_vals[perm[k]] = w_k * g_data[slot[k]]``, a padding-masked
    gather-by-slot and a collision-free scatter through the permutation.
    min/max route the gradient to the *first* attaining element of each
    duplicate group (the reference's deterministic subgradient), which
    needs the values and the result kept from the forward.  ``rows``
    selects the row-valued fill of :meth:`SparsePattern.reduce_rows`
    over the kernels' one-value-a-triplet fill.
    """

    @staticmethod
    def forward(ctx, vals, perm, slot, nzmax, accum, rows=False):
        reduce = _reduce_rows if rows else _scatter_reduce
        out = reduce(nzmax, accum, perm, slot, vals)
        if accum in ("min", "max"):
            ctx.save_for_backward(perm, slot, vals, out)
        else:
            ctx.save_for_backward(perm, slot)
        ctx.nzmax, ctx.accum = nzmax, accum
        return out

    @staticmethod
    def backward(ctx, g):
        perm, slot = ctx.saved_tensors[:2]
        g_vals = _scatter_grad(g, perm, slot, ctx.nzmax, ctx.accum,
                               *ctx.saved_tensors[2:])
        return g_vals, None, None, None, None, None


def pattern_from_perm(rows, cols, perm, *, M: int, N: int,
                      nzmax: int) -> SparsePattern:
    """Parts 3-4 on an already (col,row)-ordered permutation.

    On the card one hand-written pass gathers the sorted keys through
    ``perm`` and builds the rest from them (``csrc/pattern_build.cu``);
    on the CPU the plain version gathers, then runs
    :func:`pattern_from_sorted`'s steps.
    """
    fields = pattern_build(_i32(rows), _i32(cols), _i32(perm), M=M, N=N,
                           nzmax=nzmax)
    return SparsePattern(perm=_i32(perm), shape=(M, N), **fields)


def pattern_from_sorted(r_s, c_s, perm, *, M: int, N: int,
                        nzmax: int) -> SparsePattern:
    """Parts 3-4 on an already-sorted key stream (``L >= 1``).

    ``r_s``/``c_s`` are the (col,row)-ordered int32 keys and ``perm``
    maps sorted position back to input position.  On the CPU phrased
    gather-side, as the reference: cumsum of the boundary flags, then
    two searchsorted lookups; on the card scatter-side, in the pass of
    ``csrc/pattern_build.cu`` (:mod:`repro_torch.kernels.pattern_build`).
    """
    fields = pattern_build_sorted(_i32(r_s), _i32(c_s), M=M, N=N,
                                  nzmax=nzmax)
    return SparsePattern(perm=_i32(perm), shape=(M, N), **fields)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _index_tensor(x) -> torch.Tensor:
    """A tensor as it is, anything else through numpy (on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x))


#: one-time nzmax-headroom fallback warning state of ``update``
_UPDATE_FALLBACK_WARNED = False


def _reset_update_fallback_warning() -> None:
    """Test hook: re-arm the one-time update-fallback warning."""
    global _UPDATE_FALLBACK_WARNED
    _UPDATE_FALLBACK_WARNED = False


def _maybe_validated(pat: "SparsePattern") -> "SparsePattern":
    """``REPRO_VALIDATE=1`` hook: check rewritten plans on the way out.

    A no-op by default; under the variable every non-trivial return of
    :meth:`SparsePattern.update` runs the structural validators
    (:mod:`repro_torch.sparse.analysis.invariants`), so a merge-path bug
    surfaces as a named ``InvariantViolation`` at the rewrite, not as a
    wrong fill three calls later.  Imported lazily: the analysis layer
    depends on this module.
    """
    from .analysis.invariants import maybe_validate_pattern

    return maybe_validate_pattern(pat, subject="SparsePattern.update")


def _merge_sorted_streams(sr_a, sc_a, pa, add_rows, add_cols, L_keep: int,
                          *, M: int, N: int, nzmax: int,
                          method: str | None,
                          merge_method: str | None) -> SparsePattern:
    """Sort the delta, stable-merge it into the survivors, run the tail.

    Stream A (the surviving base) wins ties: exactly the order a fresh
    stable sort over the concatenated input gives, since every survivor
    precedes every delta element in input order.  Only the small delta
    searches the large survivor stream (B7 with ``side="right"``).  The
    merged streams are then materialised **gather-side**, as in the
    reference: one O(L_delta) scatter marks the delta's landing
    positions, a cumsum turns the marks into per-position source
    indices, and three O(L) gathers build the merged keys and perm,
    which feed the shared Parts 3-4 tail.
    """
    if add_rows.shape[0] == 0:
        return pattern_from_sorted(sr_a, sc_a, pa, M=M, N=N, nzmax=nzmax)
    dperm = sorted_permutation(add_rows, add_cols, M=M, N=N, method=method)
    dp = dperm.long()
    sr_b, sc_b = add_rows[dp], add_cols[dp]
    # delta elements land after every survivor in the concatenated
    # input order: offset their perm values past the survivors
    pb = dperm.to(torch.int32) + int(L_keep)
    off_b = merge_search(sr_b, sc_b, sr_a, sc_a, side="right",
                         method=merge_method)
    r_m, c_m, p_m = _merge_gather(sr_a, sc_a, pa, sr_b, sc_b, pb, off_b)
    return pattern_from_sorted(r_m, c_m, p_m, M=M, N=N, nzmax=nzmax)


def _merge_gather(sr_a, sc_a, pa, sr_b, sc_b, pb, off_b):
    """The merged ``(rows, cols, perm)`` streams, gather-side: stream B
    lands at ``arange(nB) + off_b``; every other position takes the
    next element of stream A."""
    nA, nB = sr_a.shape[0], sr_b.shape[0]
    Lm = nA + nB
    dev = sr_b.device
    pos_b = torch.arange(nB, dtype=torch.int64, device=dev) + off_b
    # index_fill_ takes the 1 as a scalar argument: no host-to-device
    # copy, which would synchronise the stream
    occ = torch.zeros(Lm, dtype=torch.int32, device=dev).index_fill_(
        0, pos_b, 1)
    nb_upto = torch.cumsum(occ, 0)  # deltas at positions <= q
    q = torch.arange(Lm, dtype=torch.int64, device=dev)
    # source index into cat([A, B]) for every merged position
    g = torch.where(occ == 1, nA + nb_upto - 1, q - nb_upto)
    return (torch.cat([sr_a, sr_b])[g], torch.cat([sc_a, sc_b])[g],
            torch.cat([pa.to(torch.int32), pb])[g])


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
    ``method`` selects the sort backend (``"jnp" | "fused" | "pallas" |
    "radix"``, see :mod:`repro_torch.sparse.dispatch`; ``None`` resolves
    through the tuning table, whose priors are ``"radix"`` on the card
    and ``"fused"`` on the CPU).  ``nzmax`` defaults to
    ``L + nzmax_slack``.
    """
    with obs.span("plan") as span:
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
        method = resolve_method(method, rows.device, M=M, N=N, L=L)
        if span:
            span.set(method=method, L=L, M=M, N=N, nzmax=nzmax)
        with obs.span("plan.sort", device=rows.device) as sort:
            perm = sorted_permutation(rows, cols, M=M, N=N, method=method)
        if sort and method == "radix":
            # the sort backend's digit plan, looked up again outside the
            # span so that the span's events time the sort alone
            from ..kernels.radix_sort.ops import plan_digit_passes

            sort.set(passes=len(plan_digit_passes(
                M, N, L, backend=rows.device)))
        with obs.span("plan.parts34", device=rows.device) as parts34:
            before = pattern_build.launches
            pat = pattern_from_perm(rows, cols, perm, M=M, N=N,
                                    nzmax=nzmax)
            if parts34:
                parts34.set(path=path(rows.device),
                            launches=pattern_build.launches - before)
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


# ---------------------------------------------------------------------------
# Plan-time structure detection (symmetry / block alignment)
# ---------------------------------------------------------------------------
def _host_array(x) -> np.ndarray:
    """Indices on the host: a tensor is copied off its device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def detect_symmetry(rows, cols, shape) -> bool:
    """Pairwise structural symmetry of the (deduplicated) triplets.

    Host-side numpy, as the reference: one dedup of the valid
    ``col*M + row`` keys, then an O(L) mirrored-key membership check
    (structure is a *set*, so "every mirror present" is exactly
    symmetry).  ``row == M`` sentinels are ignored.
    """
    M, N = int(shape[0]), int(shape[1])
    if M != N:
        return False
    r = _host_array(rows).astype(np.int64).ravel()
    c = _host_array(cols).astype(np.int64).ravel()
    keep = (r >= 0) & (r < M) & (c >= 0) & (c < N)
    r, c = r[keep], c[keep]
    if r.size == 0:
        return True
    key = np.unique(c * M + r)
    mkey = (key % M) * M + key // M
    pos = np.searchsorted(key, mkey).clip(0, key.size - 1)
    return bool(np.all(key[pos] == mkey))


def pattern_symmetric(pat: SparsePattern) -> bool:
    """Symmetry of an existing plan through its resident sorted stream.

    The deduplicated structure is the ``first``-flagged subsequence of
    the already-sorted ``(scols, srows)`` stream, so each mirror
    resolves with two merge-search probes (B7 on the card, ``side=
    "left"`` and ``"right"``): the machinery of the delta merge, no
    re-sort.  Runs on the plan's device.
    """
    M, N = pat.shape
    if M != N:
        return False
    first = pat.first
    srows = pat.srows[first]
    scols = pat.scols[first]
    keep = srows < M
    srows, scols = srows[keep].contiguous(), scols[keep].contiguous()
    if srows.numel() == 0:
        return True
    # probe the mirrored pairs, (row, col) swapped: present iff the
    # right and left insertion offsets differ by exactly one
    lo = merge_search(scols, srows, srows, scols, side="left")
    hi = merge_search(scols, srows, srows, scols, side="right")
    return bool(torch.all(hi - lo == 1))


def detect_block(rows, cols, shape, *, candidates=(8, 4, 2)) -> int:
    """Largest aligned block size whose occupied blocks are fully dense.

    Returns the largest ``b`` in ``candidates`` dividing both matrix
    dimensions for which every occupied ``b x b`` block holds all
    ``b*b`` structural entries (so BSR stores no fill-in zeros), else 1.
    Host-side numpy, as the reference.
    """
    M, N = int(shape[0]), int(shape[1])
    r = _host_array(rows).astype(np.int64).ravel()
    c = _host_array(cols).astype(np.int64).ravel()
    keep = (r >= 0) & (r < M) & (c >= 0) & (c < N)
    key = np.unique(c[keep] * max(M, 1) + r[keep])
    if key.size == 0:
        return 1
    rr, cc = key % max(M, 1), key // max(M, 1)
    for b in sorted(set(int(x) for x in candidates), reverse=True):
        if b <= 1 or M % b or N % b:
            continue
        bkey = (cc // b) * (M // b) + rr // b
        _, counts = np.unique(bkey, return_counts=True)
        if np.all(counts == b * b):
            return b
    return 1


# ---------------------------------------------------------------------------
# SymPattern: the halved symmetric plan (strict-upper + diagonal slots)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SymPattern:
    """Halved assembly plan for a structurally symmetric matrix.

    Only the strict-upper triplets are planned (``upat``) and only the
    diagonal triplets get a dense scatter, so every ``assemble`` refill
    streams *half* the values a full-plan refill would, and the result
    is a :class:`~repro_torch.sparse.formats.SymCSC` for the
    both-triangles SpMV (B9).

    Contract: the input stream must be pairwise value-symmetric after
    duplicate summation (FEM element matrices are).
    :func:`plan_symmetric` verifies the *structure*; value symmetry is
    the caller's invariant, as in the reference.

    usel : int32[Lu]  input positions of strict-upper triplets
    dsel : int32[Ld]  input positions of diagonal triplets
    drow : int32[Ld]  their (equal) row == col indices
    """

    upat: SparsePattern
    usel: torch.Tensor
    dsel: torch.Tensor
    drow: torch.Tensor
    shape: tuple[int, int]
    L: int = 0

    @property
    def nzmax(self) -> int:
        """Strict-upper capacity (the halved resident plan)."""
        return self.upat.nzmax

    @property
    def epoch(self) -> int:
        return self.upat.epoch

    @property
    def nnz(self) -> torch.Tensor:
        return self.upat.nnz

    @functools.cached_property
    def longest(self) -> int:
        """The most strict-upper slots a column holds, read from the
        plan once (a synchronisation on the card) and kept with it."""
        from .formats import longest_column

        return longest_column(self.upat.indptr)

    def assemble(self, vals: torch.Tensor):
        """Half-stream numeric fill -> :class:`SymCSC`.

        Gathers the ``Lu`` upper values through the halved plan (B3' on
        the card) and adds the ``Ld`` diagonal values into the dense
        ``diag`` in the :func:`accum_dtype` of the values.
        Differentiable through both.
        """
        from .formats import SymCSC

        if vals.ndim != 1 or int(vals.shape[0]) != self.L:
            raise ValueError(
                f"expected a length-{self.L} value vector aligned with "
                f"the planned triplets, got shape {tuple(vals.shape)}"
            )
        dtype = fill_dtype(vals)
        v = vals.to(dtype)
        upper = self.upat.assemble(v[self.usel.long()])
        acc = accum_dtype(dtype)
        diag = torch.zeros(self.shape[0], dtype=acc, device=v.device) \
            .index_add(0, self.drow.long(), v[self.dsel.long()].to(acc)) \
            .to(dtype)
        return SymCSC(diag=diag, data=upper.data, indices=upper.indices,
                      indptr=upper.indptr, nnz=upper.nnz, shape=self.shape,
                      longest=self.longest)


def plan_symmetric(rows, cols, shape: tuple[int, int], *,
                   nzmax: int | None = None, method: str | None = None,
                   accum: str = "sum", device=None) -> SymPattern:
    """Symbolic phase for a structurally symmetric stream.

    Verifies pairwise symmetry (``ValueError`` naming the plain-CSC
    fallback otherwise), splits the stream into strict-upper and
    diagonal triplets on the host, and plans only the upper half: the
    resident plan and every refill move half the bytes.  The plan lives
    on the device of ``rows`` when it is a tensor, else on ``device``
    (``"cuda"`` unless the caller passes another).
    """
    M, N = int(shape[0]), int(shape[1])
    if M != N:
        raise ValueError(
            f"plan_symmetric requires a square matrix, got {shape}; "
            "use plan() for the plain-CSC fallback"
        )
    if accum != "sum":
        raise NotImplementedError(
            f"plan_symmetric supports accum='sum' only (got {accum!r}); "
            "use plan() for the plain-CSC fallback"
        )
    if device is None and isinstance(rows, torch.Tensor):
        device = rows.device
    device = resolve_device(device)
    r = _host_array(rows).astype(np.int32).ravel()
    c = _host_array(cols).astype(np.int32).ravel()
    if not detect_symmetry(r, c, shape):
        raise ValueError(
            "the (deduplicated) structure is not pairwise symmetric — "
            "some entry (i, j) lacks a mirror (j, i); use plan() for "
            "the plain-CSC fallback"
        )
    valid = (r >= 0) & (r < M) & (c >= 0) & (c < N)
    usel = np.nonzero(valid & (r < c))[0].astype(np.int32)
    dsel = np.nonzero(valid & (r == c))[0].astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    upat = plan(dev(r[usel]), dev(c[usel]), (M, N), nzmax=nzmax,
                method=method)
    return SymPattern(upat=upat, usel=dev(usel), dsel=dev(dsel),
                      drow=dev(r[dsel]), shape=(M, N), L=int(r.shape[0]))


def sym_pattern_from_arrays(fields: dict[str, np.ndarray], shape, L: int, *,
                            epoch: int = 0, device=None) -> SymPattern:
    """A reference ``SymPattern``, given as numpy arrays, as the port's.

    ``fields`` maps the seven :func:`pattern_from_arrays` fields of its
    ``upat`` and ``usel``, ``dsel`` and ``drow`` to arrays; ``L`` is
    the reference's ``SymPattern.L``.  ``device`` is ``"cuda"`` unless
    the caller passes another.
    """
    device = resolve_device(device)
    upat = pattern_from_arrays(fields, shape, epoch=epoch, device=device)
    sel = {k: torch.from_numpy(np.array(fields[k], np.int32)).to(device)
           for k in ("usel", "dsel", "drow")}
    return SymPattern(upat=upat, **sel, shape=(int(shape[0]), int(shape[1])),
                      L=int(L))
