"""Structural invariant validators for plans and format containers.

Counterpart of ``repro/sparse/analysis/invariants.py``: the same
invariant names and messages, over the port's torch tensors.  Every plan
and format container carries invariants the numeric phase assumes (the
sorted ``(col, row)`` stream, ``perm`` a permutation, monotone
``indptr`` bounded by ``nzmax``, sentinels in the tails, strict-upper
SymCSC storage, BSR block alignment); a violation raises a structured
:class:`~repro_torch.sparse.errors.InvariantViolation` naming it.

The checks run on the tensors' device as masked reductions (no boolean
compaction), and each validator synchronises with the device once: the
failed flags of all its invariants come back in one transfer, and only
on a failure are the values its message quotes read.  The first failed
invariant, in the reference's order, is the one raised.

Entry points:

* :func:`validate_pattern`: SparsePattern / SymPattern / ProductPattern
  / ShardedPattern.
* :func:`validate_matrix`: CSC / CSR / COO / SymCSC / BSR / ShardedCSC
  (dispatched per registered format class; see
  :func:`validator_for_format`).
* :func:`maybe_validate_pattern`: the ``REPRO_VALIDATE=1`` gate used by
  ``SparsePattern.update``.

A sharded structure's per-block checks name the block in their subject
(``...[block b]``), as the reference's do.
"""
from __future__ import annotations

import os
from typing import Callable

import torch

from ..errors import InvariantViolation

_PATTERN_VALIDATORS: dict[type, Callable] = {}
_MATRIX_VALIDATORS: dict[type, Callable] = {}


def register_pattern_validator(cls: type):
    """Decorator: register ``fn(p, subject=None)`` for a plan class."""

    def deco(fn):
        _PATTERN_VALIDATORS[cls] = fn
        return fn

    return deco


def register_matrix_validator(cls: type):
    """Decorator: register ``fn(A, subject=None)`` for a format class."""

    def deco(fn):
        _MATRIX_VALIDATORS[cls] = fn
        return fn

    return deco


def _lookup(registry: dict[type, Callable], obj) -> Callable:
    for base in type(obj).__mro__:
        fn = registry.get(base)
        if fn is not None:
            return fn
    raise TypeError(
        f"no invariant validator registered for {type(obj).__name__}; "
        f"known: {sorted(c.__name__ for c in registry)}",
    )


def validate_pattern(p, *, subject: str | None = None):
    """Check every structural invariant of a plan object.

    Accepts a :class:`~repro_torch.sparse.pattern.SparsePattern`,
    :class:`~repro_torch.sparse.pattern.SymPattern`,
    :class:`~repro_torch.sparse.spgemm.ProductPattern` or
    :class:`~repro_torch.sparse.sharded.ShardedPattern`.  Raises
    :class:`InvariantViolation` naming the first failed invariant;
    returns ``p`` unchanged when everything holds.
    """
    _ensure_registered()
    _lookup(_PATTERN_VALIDATORS, p)(p, subject=subject)
    return p


def validate_matrix(A, *, subject: str | None = None):
    """Check every structural invariant of a format container.

    Dispatched per registered format class (CSC/CSR/COO/SymCSC/BSR/
    ShardedCSC).
    Raises :class:`InvariantViolation` naming the first failed invariant;
    returns ``A`` unchanged when everything holds.
    """
    _ensure_registered()
    _lookup(_MATRIX_VALIDATORS, A)(A, subject=subject)
    return A


def validator_for_format(name: str) -> Callable:
    """The matrix validator behind a registered format *name*."""
    from ..formats import FORMATS

    _ensure_registered()
    cls = FORMATS[name]
    for base in cls.__mro__:
        fn = _MATRIX_VALIDATORS.get(base)
        if fn is not None:
            return fn
    raise TypeError(f"no validator registered for format {name!r}")


def validation_enabled() -> bool:
    """True when ``REPRO_VALIDATE`` requests validate-on-mutate."""
    flag = os.environ.get("REPRO_VALIDATE", "")
    return flag.strip().lower() not in ("", "0", "false", "off")


def maybe_validate_pattern(p, *, subject: str | None = None):
    """:func:`validate_pattern` under the ``REPRO_VALIDATE=1`` gate."""
    if validation_enabled():
        validate_pattern(p, subject=subject)
    return p


class _Checks:
    """One validator's invariants in order: host conditions (python
    bools) and device ones (0-d bool tensors), read back in one transfer.
    A message is a string, or a callable run only when its check fails.
    :meth:`part` adds checks under another subject (a sharded
    structure's blocks) to the same list, read in the same transfer."""

    def __init__(self, subject: str, items: list | None = None):
        self.subject = subject
        self.items: list = [] if items is None else items

    def part(self, subject: str) -> "_Checks":
        return _Checks(subject, self.items)

    def req(self, cond, invariant: str, message) -> "_Checks":
        self.items.append((cond, invariant, message, self.subject))
        return self

    def host(self, cond: bool, invariant: str, message) -> None:
        """A check later ones depend on (shapes): raised at once, after
        any failed check before it."""
        if not cond:
            self.req(cond, invariant, message).run()

    def run(self) -> None:
        items = list(self.items)
        self.items.clear()
        dev = [c for c, _, _, _ in items if isinstance(c, torch.Tensor)]
        flags = iter(torch.stack([c.reshape(()).to(dev[0].device)
                                  for c in dev]).tolist() if dev else ())
        for cond, invariant, message, subject in items:
            ok = next(flags) if isinstance(cond, torch.Tensor) else cond
            if not ok:
                raise InvariantViolation(
                    invariant, message() if callable(message) else message,
                    subject=subject)


def _all(x: torch.Tensor) -> torch.Tensor:
    return x.all() if x.numel() else torch.ones((), dtype=torch.bool,
                                                device=x.device)


def _diff(x: torch.Tensor) -> torch.Tensor:
    return x[1:] - x[:-1]


def _int(t) -> int:
    return int(t)  # a message's value: read only once a check failed


# ---------------------------------------------------------------------------
# Plan validators
# ---------------------------------------------------------------------------
def _validate_sparse_pattern(p, *, subject: str | None = None):
    from ..pattern import ACCUM_MODES

    chk = _Checks(subject or f"SparsePattern{tuple(p.shape)}")
    M, N = int(p.shape[0]), int(p.shape[1])
    perm, slot, indices = p.perm, p.slot, p.indices
    indptr, srows, scols = p.indptr, p.srows, p.scols
    chk.host(perm.ndim == 1, "field-shape",
             f"perm must be 1-d, got shape {tuple(perm.shape)}")
    L = int(perm.shape[0])
    for name, arr in (("slot", slot), ("srows", srows), ("scols", scols)):
        chk.req(tuple(arr.shape) == (L,), "field-shape",
                f"{name} must have shape (L={L},), got "
                f"{tuple(arr.shape)}")
    chk.req(indices.ndim == 1, "field-shape",
            f"indices must be 1-d, got shape {tuple(indices.shape)}")
    chk.host(tuple(indptr.shape) == (N + 1,), "field-shape",
             f"indptr must have shape (N+1={N + 1},), got "
             f"{tuple(indptr.shape)}")
    nzmax = int(indices.shape[-1])
    chk.req(isinstance(p.epoch, int) and p.epoch >= 0, "epoch-valid",
            f"epoch must be a non-negative int, got {p.epoch!r}")
    chk.req(p.accum in ACCUM_MODES, "accum-valid",
            f"unknown accum mode {p.accum!r}")
    nnz = p.nnz.reshape(()).long()
    chk.req((nnz >= 0) & (nnz <= nzmax), "nzmax-capacity",
            lambda: f"nnz={_int(nnz)} outside [0, nzmax={nzmax}] — the "
            "capacity lies")
    dev = perm.device
    chk.req(_all(torch.sort(perm.long()).values
                 == torch.arange(L, device=dev)), "perm-permutation",
            "perm is not a permutation of [0, L)")
    sl = slot.long()
    chk.req(_all((sl >= 0) & (sl <= nzmax)), "slot-bounds",
            f"slot entries must lie in [0, nzmax={nzmax}] "
            "(nzmax marks dropped inputs)")
    ip = indptr.long()
    chk.req((ip[0] == 0) & _all(_diff(ip) >= 0), "indptr-monotone",
            "indptr must start at 0 and be non-decreasing")
    chk.req(ip[-1] == nnz, "indptr-nnz",
            lambda: f"indptr[-1]={_int(ip[-1])} != nnz={_int(nnz)}")
    stored = torch.arange(nzmax, device=dev) < nnz
    ind = indices.long()
    chk.req(_all(~stored | ((ind >= 0) & (ind < M))), "indices-bounds",
            f"stored row indices must lie in [0, M={M})")
    chk.req(_all(stored | (ind == M)), "padding-sentinel",
            f"indices tail beyond nnz must hold the M={M} sentinel")
    sr, sc = srows.long(), scols.long()
    chk.req(_all((sr >= 0) & (sr <= M)), "stream-key-bounds",
            f"srows must lie in [0, M={M}] (M marks padding)")
    chk.req(_all((sc >= 0) & (sc < max(N, 1))), "stream-key-bounds",
            f"scols must lie in [0, N={N})")
    kept = sl < nzmax
    chk.req(_all((sr != M) | (sl == nzmax)), "padding-sentinel",
            "a row-sentinel (padding) entry holds a kept slot")
    key = sc * (M + 2) + sr
    chk.req(_all(_diff(key) >= 0), "stream-sorted",
            "the (scols, srows) key stream is not (col, row)-sorted")
    if L:
        # each kept slot against the kept slot before it (no compaction)
        pos = torch.arange(L, device=dev)
        last = torch.cummax(torch.where(kept, pos, -1), 0).values
        prev = torch.cat([last.new_full((1,), -1), last[:-1]])
        d = sl - sl[prev.clamp(min=0)]
        first_ok = ~kept | (prev >= 0) | (sl == 0)
        step_ok = ~kept | (prev < 0) | ((d >= 0) & (d <= 1))
        chk.req(_all(first_ok & step_ok), "stream-sorted",
                "kept slots must be the dedup ranks of the sorted stream "
                "(start at 0, step by 0 or 1)")
        ks = sl.clamp(0, max(nzmax - 1, 0))
        at = ind[ks] if nzmax else sr
        chk.req(_all(~kept | (at == sr)), "slot-row-consistent",
                "indices[slot] disagrees with the sorted row stream")
        jj = sc.clamp(0, N - 1) if N else sc
        lo, hi = (ip[jj], ip[jj + 1]) if N else (sl, sl)
        chk.req(_all(~kept | ((sl >= lo) & (sl < hi))),
                "slot-column-consistent",
                "kept slots fall outside their column's indptr range")
    chk.run()


def _validate_sym_pattern(p, *, subject: str | None = None):
    subject = subject or f"SymPattern{tuple(p.shape)}"
    chk = _Checks(subject)
    M, N = int(p.shape[0]), int(p.shape[1])
    chk.host(M == N, "symcsc-square",
             f"a symmetric plan requires a square shape, got {p.shape}")
    _validate_sparse_pattern(p.upat, subject=f"{subject}.upat")
    chk.req(tuple(p.upat.shape) == (M, N), "shape-consistent",
            f"upat shape {tuple(p.upat.shape)} != plan shape {(M, N)}")
    usel, dsel, drow = p.usel.long(), p.dsel.long(), p.drow.long()
    L = int(p.L)
    chk.req(usel.ndim == 1 and usel.shape[0] == p.upat.L, "field-shape",
            f"usel must align with the halved plan (Lu={p.upat.L}), got "
            f"shape {tuple(usel.shape)}")
    chk.host(dsel.ndim == 1 and drow.shape == dsel.shape, "field-shape",
             f"dsel/drow must be equal-length 1-d, got "
             f"{tuple(dsel.shape)} and {tuple(drow.shape)}")
    chk.req(_all((usel >= 0) & (usel < L)) & _all((dsel >= 0) & (dsel < L)),
            "selector-bounds",
            f"usel/dsel must index the input stream [0, L={L})")
    chk.req(_all((drow >= 0) & (drow < M)), "selector-bounds",
            f"drow must lie in [0, M={M})")
    kept = p.upat.slot < p.upat.nzmax
    chk.req(_all(~kept | (p.upat.srows < p.upat.scols)),
            "symcsc-strict-upper",
            "the halved plan holds a non-strict-upper entry (row >= col)")
    chk.run()


def _validate_product_pattern(p, *, subject: str | None = None):
    subject = subject or "ProductPattern"
    chk = _Checks(subject)
    sa, sb = p.sa.long(), p.sb.long()
    chk.host(sa.ndim == 1 and sa.shape == sb.shape, "field-shape",
             f"sa/sb must be equal-length 1-d, got {tuple(sa.shape)} and "
             f"{tuple(sb.shape)}")
    chk.host(isinstance(p.epoch, int) and p.epoch >= 0, "epoch-valid",
             f"epoch must be a non-negative int, got {p.epoch!r}")
    _validate_sparse_pattern(p.pattern, subject=f"{subject}.pattern")
    chk.req(p.pattern.L == int(sa.shape[0]), "field-shape",
            f"expansion maps (flops_max={sa.shape[0]}) must align with the "
            f"product stream (L={p.pattern.L})")
    chk.req(_all((sa >= 0) & (sa < max(int(p.a_capacity), 1))),
            "expansion-bounds",
            f"sa must index A's storage [0, {p.a_capacity})")
    chk.req(_all((sb >= 0) & (sb < max(int(p.b_capacity), 1))),
            "expansion-bounds",
            f"sb must index B's storage [0, {p.b_capacity})")
    chk.run()


def _validate_sharded_pattern(p, *, subject: str | None = None):
    chk = _Checks(subject or f"ShardedPattern{tuple(p.shape)}")
    send_slot, perm, slot = p.send_slot, p.perm, p.slot
    indices, indptr, nnz = p.indices, p.indptr, p.nnz
    send_base, block_load, overflow = p.send_base, p.block_load, p.overflow
    N = int(p.shape[1])
    chk.host(send_slot.ndim == 2, "field-shape",
             f"send_slot must be int32[p, L_loc], got shape "
             f"{tuple(send_slot.shape)}")
    pnum = int(send_slot.shape[0])
    for name, arr in (("perm", perm), ("slot", slot), ("indices", indices)):
        chk.host(arr.ndim == 2 and arr.shape[0] == pnum, "field-shape",
                 f"{name} must carry the device axis p={pnum} leading, got "
                 f"shape {tuple(arr.shape)}")
    chk.host(tuple(indptr.shape) == (pnum, N + 1), "field-shape",
             f"indptr must have shape (p, N+1)={(pnum, N + 1)}, got "
             f"{tuple(indptr.shape)}")
    chk.host(tuple(nnz.shape) == (pnum,)
             and tuple(overflow.shape) == (pnum,), "field-shape",
             "nnz/overflow must be per-block vectors")
    chk.host(tuple(send_base.shape) == (pnum, pnum)
             and tuple(block_load.shape) == (pnum, pnum), "field-shape",
             "send_base/block_load must be [p, p] routing tables")
    chk.host(0 <= int(p.L) <= send_slot.numel(), "field-shape",
             f"L={p.L} exceeds the padded stream length "
             f"{send_slot.numel()}")
    drop = pnum * int(p.capacity)
    ss = send_slot.long()
    chk.req(_all((ss >= 0) & (ss <= drop)), "slot-bounds",
            f"send_slot must lie in [0, p*capacity={drop}]")
    R = int(perm.shape[1])
    nzb = int(indices.shape[1])
    rpb = int(p.rpb)
    dev = perm.device
    is_perm = (torch.sort(perm.long(), dim=1).values
               == torch.arange(R, device=dev)).all(1)
    sl, ind, ip = slot.long(), indices.long(), indptr.long()
    stored = torch.arange(nzb, device=dev) < nnz.long()[:, None]
    for b in range(pnum):
        part = chk.part(f"{chk.subject}[block {b}]")
        nb = nnz[b].long()
        part.req(is_perm[b], "perm-permutation",
                 "block perm is not a permutation of the received stream")
        part.req(_all((sl[b] >= 0) & (sl[b] <= nzb)), "slot-bounds",
                 f"block slots must lie in [0, nzb={nzb}]")
        part.req((nb >= 0) & (nb <= nzb), "nzmax-capacity",
                 lambda nb=nb: f"block nnz={_int(nb)} outside [0, "
                 f"nzb={nzb}]")
        part.req((ip[b, 0] == 0) & _all(_diff(ip[b]) >= 0),
                 "indptr-monotone",
                 "block indptr must start at 0 and be non-decreasing")
        part.req(ip[b, -1] == nb, "indptr-nnz",
                 lambda b=b, nb=nb: f"block indptr[-1]={_int(ip[b, -1])} "
                 f"!= nnz={_int(nb)}")
        part.req(_all(~stored[b] | ((ind[b] >= 0) & (ind[b] < rpb))),
                 "indices-bounds",
                 f"block row indices must lie in [0, rpb={rpb})")
        part.req(_all(stored[b] | (ind[b] == rpb)), "padding-sentinel",
                 f"block indices tail must hold the rpb={rpb} sentinel")
    chk.req(_all(block_load == block_load[:1]),
            "sharded-block-consistency",
            "block_load rows must be identical across devices (psum'd)")
    chk.req(_all(send_base >= 0) & _all(_diff(send_base) >= 0),
            "sharded-block-consistency",
            "send_base must be a non-negative exclusive scan over the "
            "device axis")
    chk.run()


# ---------------------------------------------------------------------------
# Format validators
# ---------------------------------------------------------------------------
def _validate_compressed(chk: _Checks, *, data, indices, indptr, nnz,
                         n_ptr: int, idx_bound: int, sentinel: int,
                         axis_name: str):
    """Shared CSC/CSR/BSR-block core: monotone pointers, sorted
    deduplicated indices per segment, sentinel-padded tails.  Returns
    each stored position's segment (column of a CSC) for later checks."""
    chk.host(indices.ndim == 1, "field-shape",
             f"indices must be 1-d, got shape {tuple(indices.shape)}")
    nzmax = int(indices.shape[0])
    chk.req(int(data.shape[-1]) == nzmax, "field-shape",
            f"data capacity {data.shape[-1]} != nzmax={nzmax}")
    chk.host(tuple(indptr.shape) == (n_ptr,), "field-shape",
             f"indptr must have shape ({n_ptr},), got "
             f"{tuple(indptr.shape)}")
    nnz = nnz.reshape(()).long() if isinstance(nnz, torch.Tensor) \
        else torch.tensor(int(nnz))
    nnz = nnz.to(indptr.device)
    chk.req((nnz >= 0) & (nnz <= nzmax), "nzmax-capacity",
            lambda: f"nnz={_int(nnz)} outside [0, nzmax={nzmax}] — the "
            "capacity lies")
    ip = indptr.long()
    chk.req((ip[0] == 0) & _all(_diff(ip) >= 0), "indptr-monotone",
            "indptr must start at 0 and be non-decreasing")
    chk.req(ip[-1] == nnz, "indptr-nnz",
            lambda: f"indptr[-1]={_int(ip[-1])} != nnz={_int(nnz)}")
    pos = torch.arange(nzmax, device=indptr.device)
    stored = pos < nnz
    ind = indices.long()
    chk.req(_all(~stored | ((ind >= 0) & (ind < idx_bound))),
            "indices-bounds", f"stored indices must lie in [0, {idx_bound})")
    chk.req(_all(stored | (ind == sentinel)), "padding-sentinel",
            f"indices tail beyond nnz must hold the {sentinel} sentinel")
    seg = torch.searchsorted(ip[1:].contiguous(), pos, right=True)
    same = (seg[1:] == seg[:-1]) & stored[1:]
    chk.req(_all(~same | (ind[1:] > ind[:-1])), "stream-sorted",
            f"stored indices within a {axis_name} must be strictly "
            "increasing (sorted, deduplicated)")
    return seg, stored, ind


def _validate_csc(A, *, subject: str | None = None):
    chk = _Checks(subject or f"CSC{tuple(A.shape)}")
    M, N = int(A.shape[0]), int(A.shape[1])
    _validate_compressed(chk, data=A.data, indices=A.indices,
                         indptr=A.indptr, nnz=A.nnz, n_ptr=N + 1,
                         idx_bound=M, sentinel=M, axis_name="column")
    chk.run()


def _validate_csr(A, *, subject: str | None = None):
    chk = _Checks(subject or f"CSR{tuple(A.shape)}")
    M, N = int(A.shape[0]), int(A.shape[1])
    _validate_compressed(chk, data=A.data, indices=A.indices,
                         indptr=A.indptr, nnz=A.nnz, n_ptr=M + 1,
                         idx_bound=N, sentinel=N, axis_name="row")
    chk.run()


def _validate_coo(A, *, subject: str | None = None):
    chk = _Checks(subject or f"COO{tuple(A.shape)}")
    M, N = int(A.shape[0]), int(A.shape[1])
    rows, cols, vals = A.rows, A.cols, A.vals
    aligned = rows.ndim == 1 and rows.shape == cols.shape
    chk.host(aligned and tuple(vals.shape[-1:]) == tuple(rows.shape),
             "field-shape",
             f"rows/cols/vals must be aligned 1-d triplets, got "
             f"{tuple(rows.shape)}/{tuple(cols.shape)}/{tuple(vals.shape)}")
    chk.req(_all((rows >= 0) & (rows <= M)), "indices-bounds",
            f"rows must lie in [0, M={M}] (M marks padding)")
    chk.req(_all((cols >= 0) & (cols < max(N, 1))), "indices-bounds",
            f"cols must lie in [0, N={N})")
    chk.run()


def _validate_symcsc(A, *, subject: str | None = None):
    chk = _Checks(subject or f"SymCSC{tuple(A.shape)}")
    M, N = int(A.shape[0]), int(A.shape[1])
    chk.host(M == N, "symcsc-square",
             f"SymCSC requires a square shape, got {A.shape}")
    chk.req(A.diag.shape[-1] == M, "field-shape",
            f"diag must have length M={M}, got shape "
            f"{tuple(A.diag.shape)}")
    seg, stored, ind = _validate_compressed(
        chk, data=A.data, indices=A.indices, indptr=A.indptr, nnz=A.nnz,
        n_ptr=N + 1, idx_bound=M, sentinel=M, axis_name="column")
    chk.req(_all(~stored | (ind < seg)), "symcsc-strict-upper",
            "SymCSC stores the strict upper triangle only, but an entry "
            "has row >= col")
    chk.run()


def _validate_bsr(A, *, subject: str | None = None):
    chk = _Checks(subject or f"BSR{tuple(A.shape)}")
    M, N = int(A.shape[0]), int(A.shape[1])
    b = int(A.block)
    data = A.data
    chk.host(b >= 1 and M % b == 0 and N % b == 0, "bsr-alignment",
             f"shape {A.shape} is not divisible by block={b}")
    chk.host(data.ndim == 3 and tuple(data.shape[-2:]) == (b, b),
             "bsr-alignment",
             f"data must be [nbmax, {b}, {b}] dense blocks, got shape "
             f"{tuple(data.shape)}")
    Mb, Nb = M // b, N // b
    _validate_compressed(chk, data=data[..., 0, 0], indices=A.indices,
                         indptr=A.indptr, nnz=A.nnz, n_ptr=Nb + 1,
                         idx_bound=Mb, sentinel=Mb,
                         axis_name="block column")
    chk.run()


def _validate_sharded_csc(A, *, subject: str | None = None):
    chk = _Checks(subject or f"ShardedCSC{tuple(A.shape)}")
    N = int(A.shape[1])
    data, indices, indptr, nnz = A.data, A.indices, A.indptr, A.nnz
    chk.host(indices.ndim == 2, "field-shape",
             f"indices must be int32[p, nzb], got shape "
             f"{tuple(indices.shape)}")
    pnum = int(indices.shape[0])
    chk.host(data.shape[0] == pnum and data.shape[-1] == indices.shape[-1],
             "field-shape",
             f"data must be [p, (B,) nzb] aligned with indices, got "
             f"{tuple(data.shape)} vs {tuple(indices.shape)}")
    chk.host(tuple(indptr.shape) == (pnum, N + 1)
             and tuple(nnz.shape) == (pnum,), "field-shape",
             "indptr/nnz must be per-block [p, N+1] / [p]")
    rpb = int(A.rows_per_block)
    for b in range(pnum):
        _validate_compressed(chk.part(f"{chk.subject}[block {b}]"),
                             data=data[b], indices=indices[b],
                             indptr=indptr[b], nnz=nnz[b], n_ptr=N + 1,
                             idx_bound=rpb, sentinel=rpb,
                             axis_name="column")
    chk.run()


# ---------------------------------------------------------------------------
# Lazy registration (class imports deferred so this module stays cheap to
# import from low-level call sites)
# ---------------------------------------------------------------------------
_REGISTERED = False


def _ensure_registered() -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    from ...core.coo import COO
    from ...core.csc import CSC
    from ..formats import BSR, CSR, SymCSC
    from ..pattern import SparsePattern, SymPattern
    from ..sharded import ShardedCSC, ShardedPattern
    from ..spgemm import ProductPattern

    _PATTERN_VALIDATORS.setdefault(SparsePattern, _validate_sparse_pattern)
    _PATTERN_VALIDATORS.setdefault(SymPattern, _validate_sym_pattern)
    _PATTERN_VALIDATORS.setdefault(ProductPattern, _validate_product_pattern)
    _PATTERN_VALIDATORS.setdefault(ShardedPattern, _validate_sharded_pattern)
    _MATRIX_VALIDATORS.setdefault(CSC, _validate_csc)
    _MATRIX_VALIDATORS.setdefault(CSR, _validate_csr)
    _MATRIX_VALIDATORS.setdefault(COO, _validate_coo)
    _MATRIX_VALIDATORS.setdefault(SymCSC, _validate_symcsc)
    _MATRIX_VALIDATORS.setdefault(BSR, _validate_bsr)
    _MATRIX_VALIDATORS.setdefault(ShardedCSC, _validate_sharded_csc)
    _REGISTERED = True
