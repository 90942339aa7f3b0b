"""The format zoo and its registry (counterpart of
``repro/sparse/formats.py``).

COO triplets (:class:`~repro_torch.core.coo.COO`), the padded
:class:`~repro_torch.core.csc.CSC`, the row-compressed :class:`CSR` and
the bandwidth-oriented :class:`SymCSC` / :class:`BSR` sit behind one
conversion registry, so consumers write ``convert(A, "csr")`` instead of
format-specific glue.

Every format keeps the reference's fixed capacity and sentinels: ``row
== M`` (CSC/COO/SymCSC), ``col == N`` (CSR) and ``block row == Mb``
(BSR) in the padded tail, the true ``nnz`` as a 0-d int32 tensor.  The
conversions are plain PyTorch (the reference runs them in XLA outside
any Pallas kernel); ``coo_to_csc``/``coo_to_csr`` go through the port's
``plan`` and fill, so on the card they run the planner and fill kernels.
``csc_to_symcsc`` and ``csc_to_bsr`` validate on the host, as the
reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from ..core.coo import COO
from ..core.csc import CSC, csc_to_dense, slot_columns
from ..kernels.common import resolve_device


@runtime_checkable
class SparseMatrix(Protocol):
    """Structural protocol every sparse format satisfies."""

    shape: Tuple[int, int]

    def to_dense(self) -> torch.Tensor: ...


def _where0(valid, x):
    """``x`` where ``valid``, else 0 of ``x``'s dtype."""
    return torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


@dataclasses.dataclass(frozen=True)
class CSR:
    """Row-compressed sparse matrix with static capacity.

    data    : float[nzmax]  -- zeros in the padded tail
    indices : int32[nzmax]  -- zero-offset columns; ``N`` sentinel in tail
    indptr  : int32[M+1]    -- row pointer; indptr[M] == nnz
    nnz     : int32 0-d
    shape   : (M, N)
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, int]

    @property
    def nzmax(self) -> int:
        return int(self.data.shape[-1])

    @property
    def M(self) -> int:
        return int(self.shape[0])

    @property
    def N(self) -> int:
        return int(self.shape[1])

    def to_dense(self) -> torch.Tensor:
        rows = slot_columns(self.indptr, self.nzmax)  # row of each slot
        valid = self.indices < self.N
        r = torch.where(valid, rows.clamp(0, self.M - 1), 0).long()
        c = torch.where(valid, self.indices, 0).long()
        dense = torch.zeros(self.shape, dtype=self.data.dtype,
                            device=self.data.device)
        return dense.index_put_((r, c), _where0(valid, self.data),
                                accumulate=True)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
FORMATS: Dict[str, type] = {}
_CONVERTERS: Dict[Tuple[type, str], Callable] = {}


def register_format(name: str, cls: type) -> None:
    FORMATS[name] = cls


def register_converter(src: type, target: str, fn: Callable) -> None:
    """``fn(matrix, **kwargs) -> matrix`` converting ``src`` to ``target``."""
    _CONVERTERS[(src, target)] = fn


def format_of(A) -> str:
    for name, cls in FORMATS.items():
        if isinstance(A, cls):
            return name
    raise TypeError(f"{type(A).__name__} is not a registered sparse format")


def convert(A, target: str, **kwargs):
    """Convert any registered format to ``target`` (COO is the hub).

    Direct converters are preferred; otherwise the conversion routes
    through COO triplets (every format can produce and consume them).
    """
    if target not in FORMATS:
        raise ValueError(
            f"unknown format {target!r}; known: {sorted(FORMATS)}")
    if isinstance(A, FORMATS[target]):
        return A
    direct = _CONVERTERS.get((type(A), target))
    if direct is not None:
        return direct(A, **kwargs)
    if target != "coo":
        hub = convert(A, "coo")
        # the hub leg must be a *direct* converter: recursing again
        # would loop forever on a target with no from-COO conversion
        out = _CONVERTERS.get((type(hub), target))
        if out is not None:
            return out(hub, **kwargs)
    raise TypeError(f"no conversion path {type(A).__name__} -> {target!r}")


# ---------------------------------------------------------------------------
# Built-in conversions (COO is the hub format)
# ---------------------------------------------------------------------------
def csc_to_coo(A: CSC) -> COO:
    cols = slot_columns(A.indptr, A.nzmax)
    valid = A.indices < A.M
    return COO(
        rows=torch.where(valid, A.indices, A.M).to(torch.int32),
        cols=torch.where(valid, cols.clamp(0, A.N - 1), 0).to(torch.int32),
        vals=_where0(valid, A.data),
        shape=A.shape,
    )


def csr_to_coo(A: CSR) -> COO:
    rows = slot_columns(A.indptr, A.nzmax)
    valid = A.indices < A.N
    return COO(
        rows=torch.where(valid, rows.clamp(0, A.M - 1), A.M).to(torch.int32),
        cols=torch.where(valid, A.indices, 0).to(torch.int32),
        vals=_where0(valid, A.data),
        shape=A.shape,
    )


def coo_to_csc(A: COO, *, nzmax: int | None = None,
               method: str | None = None) -> CSC:
    """Plan and fill the triplets (``method=None``: the device's default
    planner, see :func:`repro_torch.sparse.dispatch.default_method`)."""
    from .pattern import plan

    pat = plan(A.rows, A.cols, A.shape, nzmax=nzmax, method=method)
    return pat.assemble(A.vals)


def coo_to_csr(A: COO, *, nzmax: int | None = None,
               method: str | None = None) -> CSR:
    """CSR of A == CSC of Aᵀ with the index arrays reinterpreted.

    The transpose's ``row == N`` padding sentinel is exactly CSR's
    ``col == N`` sentinel, so the COO padding (``row == M``) is first
    translated into the transposed frame.
    """
    from .pattern import plan

    M, N = A.shape
    valid = A.rows < M
    rows_t = torch.where(valid, A.cols, N)
    cols_t = torch.where(valid, A.rows, 0)
    t = plan(rows_t, cols_t, (N, M), nzmax=nzmax,
             method=method).assemble(A.vals)
    return CSR(data=t.data, indices=t.indices, indptr=t.indptr,
               nnz=t.nnz, shape=(M, N))


def _resort_compressed(A, *, bins: int, other: int):
    """Shared body of the direct CSC<->CSR converters.

    The stored stream of a compressed format is lexicographic in
    (compressed axis, stored index), so ONE stable sort by the stored
    index leaves equal-key runs ordered by the old compressed axis:
    exactly the other format's order; the new pointer is one bincount.
    ``bins`` is the output's compressed-axis length (== the input's
    stored-index sentinel, which sorts last on its own), ``other`` the
    output's stored-index sentinel.  Returns (data, indices, indptr).
    """
    src = slot_columns(A.indptr, A.nzmax)  # input's compressed axis
    valid = A.indices < bins
    order = torch.argsort(A.indices, stable=True)  # sentinels sink last
    counts = torch.bincount(torch.where(valid, A.indices, bins).long(),
                            minlength=bins + 1)[:bins]
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]) \
        .to(torch.int32)
    data = _where0(valid, A.data)[order]
    indices = torch.where(valid, src.clamp(0, other - 1), other)[order] \
        .to(torch.int32)
    return data, indices, indptr


def csc_to_csr(A: CSC) -> CSR:
    """Direct CSC -> CSR: ONE stable sort by row, no COO round trip."""
    data, indices, indptr = _resort_compressed(A, bins=A.M, other=A.N)
    return CSR(data=data, indices=indices, indptr=indptr, nnz=A.nnz,
               shape=A.shape)


def csr_to_csc(A: CSR) -> CSC:
    """Direct CSR -> CSC: the mirror single stable sort by column."""
    data, indices, indptr = _resort_compressed(A, bins=A.N, other=A.M)
    return CSC(data=data, indices=indices, indptr=indptr, nnz=A.nnz,
               shape=A.shape)


def _set_drop(size: int, fill, dtype, device, writes):
    """``full(size, fill).at[pos].set(val, mode="drop")`` for each
    ``(pos, val)`` in order: positions ``>= size`` land in one scratch
    slot past the end, which is cut off."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=device)
    for pos, val in writes:
        out[pos.clamp(0, size).long()] = val.to(dtype)
    return out[:size]


def _host_entries(A: CSC):
    """Stored (row, col, value) of a CSC on the host, padding dropped."""
    M, N = A.shape
    cols = slot_columns(A.indptr, A.nzmax).cpu().numpy()
    r = A.indices.cpu().numpy()
    v = A.data.detach().cpu()
    valid = r < M
    r = r[valid].astype(np.int64)
    c = cols[valid].clip(0, max(N - 1, 0)).astype(np.int64)
    return r, c, v[torch.from_numpy(valid)]


# ---------------------------------------------------------------------------
# SymCSC: upper-triangle-only storage for structurally symmetric matrices
# ---------------------------------------------------------------------------
def longest_column(indptr: torch.Tensor) -> int:
    """The most slots a column of a column pointer holds,
    ``max(diff(indptr))`` (0 for no column); a synchronisation on the
    card."""
    return int(torch.diff(indptr).max()) if indptr.numel() > 1 else 0


@dataclasses.dataclass(frozen=True)
class SymCSC:
    """Symmetric matrix stored as a dense diagonal + strict upper triangle.

    Semantics: ``A == diag(diag) + U + U.T`` where ``U`` is the strict
    upper triangle held in CSC layout; a symmetric SpMV reads the
    halved stream once for both triangles.

    diag    : float[M]       -- ALL diagonal entries, dense
    data    : float[nzmax]   -- strict-upper values, zeros in padded tail
    indices : int32[nzmax]   -- strict-upper rows; ``M`` sentinel in tail
    indptr  : int32[N+1]     -- column pointer over the strict upper part
    nnz     : int32 0-d      -- structural strict-upper count
    shape   : (M, M)         -- always square
    longest : int            -- the most strict-upper slots a column
                                holds (picks B9's shape); read from
                                ``indptr`` when not given
    """

    diag: torch.Tensor
    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, int]
    longest: int | None = None

    def __post_init__(self):
        if self.longest is None:
            object.__setattr__(self, "longest", longest_column(self.indptr))

    @property
    def nzmax(self) -> int:
        """Strict-upper capacity (half the full-format stream)."""
        return int(self.data.shape[-1])

    @property
    def M(self) -> int:
        return int(self.shape[0])

    @property
    def N(self) -> int:
        return int(self.shape[1])

    @property
    def nnz_total(self):
        """Matlab-visible stored-entry count of the expanded matrix."""
        return 2 * self.nnz + self.M

    def to_dense(self) -> torch.Tensor:
        upper = csc_to_dense(self.data, self.indices, self.indptr, M=self.M,
                             N=self.N)
        return upper + upper.T + torch.diag(self.diag.to(self.data.dtype))


def csc_to_symcsc(A: CSC) -> SymCSC:
    """Validate + compact a plain CSC into SymCSC (on the host, like find).

    Requires a square matrix whose deduplicated structure AND stored
    values are exactly symmetric; raises ``ValueError`` naming the
    plain-CSC fallback otherwise.  Missing diagonal entries become
    explicit zeros in the dense ``diag`` vector.
    """
    M, N = A.shape
    if M != N:
        raise ValueError(
            f"symcsc requires a square matrix, got shape {A.shape}; "
            "keep the plain 'csc' format for rectangular matrices"
        )
    r, c, v = _host_entries(A)
    # the stored stream is (col, row)-sorted and deduplicated, so the
    # keys are strictly increasing and mirrors resolve by binary search
    key = c * M + r
    mkey = r * M + c
    pos = np.searchsorted(key, mkey).clip(0, max(key.size - 1, 0))
    if key.size and not np.array_equal(key[pos], mkey):
        bad = int(np.nonzero(key[pos] != mkey)[0][0])
        raise ValueError(
            f"structure is not symmetric: entry ({int(r[bad]) + 1}, "
            f"{int(c[bad]) + 1}) has no mirror; keep the plain 'csc' "
            "format for unsymmetric matrices"
        )
    tpos = torch.from_numpy(pos)
    if key.size and not torch.equal(v[tpos], v):
        bad = int(torch.nonzero(v[tpos] != v)[0, 0])
        raise ValueError(
            f"values are not symmetric: A({int(r[bad]) + 1}, "
            f"{int(c[bad]) + 1}) != A({int(c[bad]) + 1}, "
            f"{int(r[bad]) + 1}); keep the plain 'csc' format"
        )
    diag = torch.zeros(M, dtype=v.dtype)
    dmask = r == c
    diag[torch.from_numpy(r[dmask])] = v[torch.from_numpy(dmask)]
    up = r < c
    counts = np.bincount(c[up], minlength=N)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dev = A.data.device
    return SymCSC(
        diag=diag.to(dev), data=v[torch.from_numpy(up)].to(dev),
        indices=torch.from_numpy(r[up].astype(np.int32)).to(dev),
        indptr=torch.from_numpy(indptr).to(dev),
        nnz=torch.tensor(int(up.sum()), dtype=torch.int32, device=dev),
        shape=(M, N), longest=int(counts.max(initial=0)),
    )


def symcsc_to_coo(A: SymCSC) -> COO:
    """Expand to triplets: dense diagonal + upper + mirrored lower."""
    M, N = A.shape
    cols = slot_columns(A.indptr, A.nzmax)
    valid = A.indices < M
    r = torch.where(valid, A.indices, M).to(torch.int32)
    c = torch.where(valid, cols.clamp(0, max(N - 1, 0)), 0).to(torch.int32)
    v = _where0(valid, A.data)
    ar = torch.arange(M, dtype=torch.int32, device=A.data.device)
    return COO(
        rows=torch.cat([ar, r, torch.where(valid, c, M).to(torch.int32)]),
        cols=torch.cat([ar, c, torch.where(valid, r, 0).to(torch.int32)]),
        vals=torch.cat([A.diag.to(A.data.dtype), v, v]),
        shape=A.shape,
    )


def symcsc_to_csc(A: SymCSC) -> CSC:
    """Direct demotion: one half-size stable sort, no re-planning.

    The upper block is already in CSC order; the mirrored lower block
    needs the upper triangle's CSR view, which is ONE stable argsort of
    the half-length stream.  Per output column the three groups (upper
    rows ``< j``, the diagonal, mirrored rows ``> j``) occupy disjoint
    sorted ranges, so placement is pointer arithmetic.
    """
    M, N = A.shape
    nu = A.nzmax
    dev = A.data.device
    cols = slot_columns(A.indptr, nu)
    valid = A.indices < M
    rU = torch.where(valid, A.indices, M)
    cU = torch.where(valid, cols.clamp(0, max(N - 1, 0)), 0)
    nzmax_out = 2 * nu + M
    cu = torch.diff(A.indptr)                                 # upper per col
    cl = torch.bincount(torch.where(valid, rU, N).long(),
                        minlength=N + 1)[:N]
    out_ptr = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.cumsum(cu.long() + cl + 1, 0)]).to(torch.int32)
    slots = torch.arange(nu, dtype=torch.int32, device=dev)
    data = _where0(valid, A.data)
    # upper entries keep their within-column position
    cUl = cU.long()
    pos_u = out_ptr[cUl] + (slots - A.indptr[cUl])
    pos_u = torch.where(valid, pos_u, nzmax_out)
    # the diagonal lands right after each column's upper block
    ar = torch.arange(M, dtype=torch.int32, device=dev)
    pos_d = out_ptr[:-1][:M] + cu[:M]
    # mirrored entries follow the upper triangle's CSR (row-major) order
    order = torch.argsort(rU, stable=True)                   # sentinels last
    rs = rU[order]
    q = slots - torch.searchsorted(rs, rs, side="left", out_int32=True)
    rsc = rs.clamp(0, max(N - 1, 0)).long()
    pos_l = out_ptr[rsc] + cu[rsc] + 1 + q
    pos_l = torch.where(rs < M, pos_l, nzmax_out)
    indices = _set_drop(nzmax_out, M, torch.int32, dev, (
        (pos_u, rU), (pos_d, ar), (pos_l, cU[order])))
    vals = _set_drop(nzmax_out, 0, A.data.dtype, dev, (
        (pos_u, data), (pos_d, A.diag), (pos_l, data[order])))
    return CSC(data=vals, indices=indices, indptr=out_ptr,
               nnz=(2 * A.nnz + M).to(torch.int32), shape=A.shape)


def coo_to_symcsc(A: COO, *, nzmax: int | None = None,
                  method: str | None = None) -> SymCSC:
    return csc_to_symcsc(coo_to_csc(A, nzmax=nzmax, method=method))


# ---------------------------------------------------------------------------
# BSR: small dense b x b blocks
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-compressed format with dense ``b x b`` tiles, column-major
    over blocks (a block-level CSC).

    data    : float[nbmax, b, b] -- dense blocks, zero-filled partials
    indices : int32[nbmax]       -- block rows; ``M//b`` sentinel in tail
    indptr  : int32[Nb+1]        -- block-column pointer
    nnz     : int32 0-d          -- structural block count
    shape   : (M, N)             -- both divisible by ``block``
    block   : int
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, int]
    block: int = 1

    @property
    def nbmax(self) -> int:
        return int(self.data.shape[0])

    @property
    def M(self) -> int:
        return int(self.shape[0])

    @property
    def N(self) -> int:
        return int(self.shape[1])

    @property
    def Mb(self) -> int:
        return self.M // self.block

    @property
    def Nb(self) -> int:
        return self.N // self.block

    @property
    def nnz_total(self):
        """Stored scalar entries (dense blocks include explicit zeros)."""
        return self.nnz * (self.block * self.block)

    def to_dense(self) -> torch.Tensor:
        b, Mb, Nb = self.block, self.Mb, self.Nb
        bcols = slot_columns(self.indptr, self.nbmax)
        valid = self.indices < Mb
        r = torch.where(valid, self.indices, 0).long()
        c = torch.where(valid, bcols.clamp(0, max(Nb - 1, 0)), 0).long()
        v = _where0(valid[:, None, None], self.data)
        dense = torch.zeros((Mb, Nb, b, b), dtype=self.data.dtype,
                            device=self.data.device)
        dense.index_put_((r, c), v, accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(self.M, self.N)


def csc_to_bsr(A: CSC, *, block: int = 1) -> BSR:
    """Group a plain CSC into dense blocks (on the host, like find).

    Every occupied ``b x b`` block is materialised densely; entries the
    CSC didn't store become explicit zeros (standard BSR fill-in).
    """
    b = int(block)
    M, N = A.shape
    if b < 1:
        raise ValueError(f"block must be >= 1, got {b}")
    if (b and M % b) or (b and N % b):
        raise ValueError(
            f"shape {A.shape} is not divisible by block={b}; "
            "keep the plain 'csc' format or pick an aligned block size"
        )
    Mb, Nb = M // b, N // b
    r, c, v = _host_entries(A)
    key = (c // b) * max(Mb, 1) + r // b
    ukey, inv = np.unique(key, return_inverse=True)
    nb = int(ukey.size)
    data = torch.zeros((nb, b, b), dtype=v.dtype)
    # CSC entries are unique per (i, j)
    data[torch.from_numpy(inv.reshape(-1)), torch.from_numpy(r % b),
         torch.from_numpy(c % b)] = v
    ubr = (ukey % max(Mb, 1)).astype(np.int32)
    ubc = (ukey // max(Mb, 1)).astype(np.int32)
    counts = np.bincount(ubc, minlength=Nb)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dev = A.data.device
    return BSR(data=data.to(dev), indices=torch.from_numpy(ubr).to(dev),
               indptr=torch.from_numpy(indptr).to(dev),
               nnz=torch.tensor(nb, dtype=torch.int32, device=dev),
               shape=(M, N), block=b)


def bsr_to_coo(A: BSR) -> COO:
    b, Mb, Nb = A.block, A.Mb, A.Nb
    dev = A.data.device
    bcols = slot_columns(A.indptr, A.nbmax)
    valid = A.indices < Mb
    br = torch.where(valid, A.indices, 0)
    bc = torch.where(valid, bcols.clamp(0, max(Nb - 1, 0)), 0)
    rl = torch.arange(b, dtype=torch.int32, device=dev)
    ok = valid[:, None, None]
    shape3 = (A.nbmax, b, b)
    rows = torch.where(
        ok, (br[:, None] * b + rl)[:, :, None].expand(shape3), A.M)
    cols = torch.where(
        ok, (bc[:, None] * b + rl)[:, None, :].expand(shape3), 0)
    return COO(rows=rows.reshape(-1).to(torch.int32),
               cols=cols.reshape(-1).to(torch.int32),
               vals=_where0(ok, A.data).reshape(-1), shape=A.shape)


def bsr_to_csc(A: BSR) -> CSC:
    """Direct demotion: sort-free scatter, pure pointer arithmetic.

    Within block-column ``bc`` the stored blocks are already ordered by
    block row, so scalar column ``j = bc*b + cl`` receives its entries
    in order by walking the blocks; every output slot is computable
    from (block position, local row, local col) without a sort.
    """
    b, M = A.block, A.M
    Nb = A.Nb
    nbmax = A.nbmax
    dev = A.data.device
    bcols = slot_columns(A.indptr, nbmax)
    valid = A.indices < A.Mb
    cnt = torch.diff(A.indptr)                       # blocks per block-col
    nzmax_out = nbmax * b * b
    bc = bcols.clamp(0, max(Nb - 1, 0)).long()
    q = torch.arange(nbmax, dtype=torch.int32, device=dev) - A.indptr[bc]
    rl = torch.arange(b, dtype=torch.int32, device=dev)
    # slot(s, rl, cl) = indptr[bc]*b^2 + cl*cnt[bc]*b + q*b + rl
    pos = ((A.indptr[bc] * (b * b) + q * b)[:, None, None]
           + rl[None, :, None]
           + (cnt[bc] * b)[:, None, None] * rl[None, None, :])
    ok = valid[:, None, None]
    pos = torch.where(ok, pos, nzmax_out).reshape(-1)
    rows = (A.indices[:, None] * b + rl[None, :])[:, :, None] \
        .expand(nbmax, b, b)
    indices = _set_drop(nzmax_out, M, torch.int32, dev, (
        (pos, torch.where(ok, rows, M).reshape(-1)),))
    data = _set_drop(nzmax_out, 0, A.data.dtype, dev, (
        (pos, _where0(ok, A.data).reshape(-1)),))
    # scalar column pointer: col j = bc*b + cl starts at
    # indptr[bc]*b^2 + cl*cnt[bc]*b
    jbc = torch.arange(Nb, device=dev).repeat_interleave(b)
    jcl = torch.arange(b, dtype=torch.int32, device=dev).repeat(Nb)
    starts = A.indptr[jbc] * (b * b) + jcl * cnt[jbc] * b
    indptr = torch.cat([starts.to(torch.int32),
                        (A.indptr[Nb] * (b * b)).reshape(1)
                        .to(torch.int32)])
    return CSC(data=data, indices=indices, indptr=indptr,
               nnz=(A.nnz * (b * b)).to(torch.int32), shape=A.shape)


def coo_to_bsr(A: COO, *, block: int = 1, nzmax: int | None = None,
               method: str | None = None) -> BSR:
    return csc_to_bsr(coo_to_csc(A, nzmax=nzmax, method=method), block=block)


# ---------------------------------------------------------------------------
# Reference matrices as the port's
# ---------------------------------------------------------------------------
_FIELDS = {
    "csr": ("data", "indices", "indptr", "nnz"),
    "symcsc": ("diag", "data", "indices", "indptr", "nnz"),
    "bsr": ("data", "indices", "indptr", "nnz"),
}
_VALUE_FIELDS = ("data", "diag")


def from_arrays(fmt: str, fields: dict, shape, *, block: int = 1,
                device=None):
    """A reference CSR, SymCSC or BSR matrix, given as numpy arrays, as
    the port's.

    ``fields`` maps each field of the format (``data``, ``indices``,
    ``indptr``, ``nnz``, and ``diag`` for SymCSC) to an array (for
    example ``np.asarray(getattr(A, k))`` of a ``repro.sparse`` matrix);
    values keep their dtype, the structure becomes int32.  ``block`` is
    BSR's tile size.  ``device`` is ``"cuda"`` unless the caller passes
    another.  ``CSC`` matrices go through
    :func:`repro_torch.core.csc.csc_from_arrays`.
    """
    if fmt not in _FIELDS:
        raise ValueError(f"from_arrays takes one of {sorted(_FIELDS)}, "
                         f"got {fmt!r}")
    device = resolve_device(device)
    kw = {}
    for k in _FIELDS[fmt]:
        a = np.array(fields[k]) if k in _VALUE_FIELDS \
            else np.array(fields[k], np.int32)
        kw[k] = torch.from_numpy(a).to(device)
    if fmt == "bsr":
        kw["block"] = int(block)
    return FORMATS[fmt](shape=(int(shape[0]), int(shape[1])), **kw)


register_format("coo", COO)
register_format("csc", CSC)
register_format("csr", CSR)
register_format("symcsc", SymCSC)
register_format("bsr", BSR)
register_converter(CSC, "coo", csc_to_coo)
register_converter(CSR, "coo", csr_to_coo)
register_converter(COO, "csc", coo_to_csc)
register_converter(COO, "csr", coo_to_csr)
register_converter(CSC, "csr", csc_to_csr)
register_converter(CSR, "csc", csr_to_csc)
register_converter(SymCSC, "coo", symcsc_to_coo)
register_converter(SymCSC, "csc", symcsc_to_csc)
register_converter(CSC, "symcsc", csc_to_symcsc)
register_converter(COO, "symcsc", coo_to_symcsc)
register_converter(BSR, "coo", bsr_to_coo)
register_converter(BSR, "csc", bsr_to_csc)
register_converter(CSC, "bsr", csc_to_bsr)
register_converter(COO, "bsr", coo_to_bsr)
