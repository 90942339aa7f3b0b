"""Sharded two-phase assembly: the paper's §3 with a plan/fill split.

Counterpart of ``repro/sparse/sharded.py``.  A mesh of ``p`` shards
(:func:`repro_torch.launch.mesh.make_data_mesh`) splits the triplet
stream into ``p`` equal chunks and the rows into ``p`` blocks of
``rpb = ceil(M / p)`` rows; shard ``d`` owns rows ``[d*rpb, (d+1)*rpb)``.
Every field of a plan carries the shards as its leading axis, as the
reference's sharded arrays do.  The port runs all ``p`` shards on one
device, so the reference's tiled ``all_to_all`` (received chunk ``s`` of
shard ``d`` is sent chunk ``d`` of shard ``s``) is a transpose of the
``[p, p, capacity]`` send buckets.

Plan time (:func:`plan_sharded`), once per structure:

  Phase A (paper Part 1 at shard granularity): each shard's histogram
      of row-block keys, all shards at once, read off the run bounds of
      Phase B's sort; ``send_base`` is its exclusive sum over the source
      shards, ``block_load`` its column sums (on every shard's row, as
      the reference's ``psum``), ``overflow`` a bucket over
      ``capacity``.
  Phase B (the row-block redistribution, symbolic): a stable sort of
      each shard's keys gives every input its send-bucket slot
      (``send_slot``); the indices are routed once through the buckets
      and the exchange.
  Phase C (Parts 1-4 per block): the port's :func:`plan` of each
      received block (the radix planner, B1 and B2, on the card),
      stacked into ``[p, ...]`` fields.

Fill time (:meth:`ShardedPattern.assemble`): the values go through the
same buckets and exchange (:func:`route_values`), then through B3'
(``gather_segment_sum_sorted``), as the reference's
``fill_sharded_pallas`` does, where its ``assemble`` scatter-adds.  The
p blocks' streams are one stream to B3': block ``d``'s positions are
offset by ``d * p * capacity`` and its slots by ``d * nzb``, and every
dropped entry keeps the one sentinel ``p * nzb``, past every block's
slots.  So a fill is one B3' launch (one per row of a batch).  The fill
is a ``torch.autograd.Function`` whose backward is the reference's
transposed routing.

The output :class:`ShardedCSC` is block-row partitioned, registered as
the ``"sharded"`` format (``convert(A, "csc")``, ``to_dense``, ``find``)
and carries its mesh; ``A.spmv(x)`` / ``A @ x`` run the port's
``core/csc.py`` SpMV on each block with ``x`` shared.

On a rank mesh (:func:`repro_torch.launch.mesh.make_data_mesh` on a
group of ranks: one process a shard) every field holds this rank's row
of the reference's sharded array, a leading axis of one: its slice of
``send_slot``, its block's ``perm``/``slot``/``indices``/``indptr``/
``nnz``, its row of ``send_base``, ``block_load`` and ``overflow``.
Each rank takes its ``L_pad / p`` slice of the triplets (every rank
passes the global vectors, or the local shard of a ``Shard(0)``
DTensor).  Phase A's counts are gathered over the ranks
(``all_gather_into_tensor`` to ``[p, p]``), the exchange is one
``all_to_all_single`` of the ``[p * capacity]`` bucket buffer (the row
and column indices in one at plan time), Phase C plans the rank's own
block.  Reductions over the shard axis (``nnz_total``,
``any_overflow``) are collectives, and so is every view that needs the
other blocks (``to_dense``, ``spmv``'s ``y``, the format conversions):
each gathers, so that every rank holds the reference's global answer.
Every rank must make the same calls in the same order.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.coo import COO
from ..core.csc import CSC, slot_columns
from ..core.csc import spmv as csc_spmv
from ..launch import ranks as _ranks
from ..launch.mesh import Mesh, axis_size, is_rank_mesh, mesh_device
from .dispatch import resolve_method
from .pattern import _index_tensor, fill_dtype, plan


def resolve_mesh(mesh: Mesh | None = None, *, axis: str = "data",
                 device=None) -> Mesh:
    """Default mesh for ``method="sharded"``: one axis, one shard per
    visible card, or one shard on ``device`` when the caller passes one."""
    if mesh is not None:
        return mesh
    from ..launch.mesh import make_data_mesh

    return make_data_mesh(axis=axis, device=device)


def mesh_fingerprint(mesh: Mesh, axis: str) -> tuple:
    """Hashable identity of a mesh for host-side plan caches (the
    reference's layout, with device indices for device ids; a rank
    mesh's ranks and its group's backend)."""
    if is_rank_mesh(mesh):
        import torch.distributed as dist

        return (
            tuple(mesh.mesh_dim_names),
            tuple(mesh.shape),
            tuple(mesh.mesh.flatten().tolist()),
            dist.get_backend(mesh.get_group(axis)),
            axis,
        )
    return (
        tuple(mesh.axis_names),
        tuple(mesh.shape[a] for a in mesh.axis_names),
        tuple(d.index for d in mesh.devices),
        axis,
    )


# ---------------------------------------------------------------------------
# ShardedCSC: the block-row partitioned output format
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedCSC:
    """Block-row partitioned CSC: leading axis = shards.

    data    : float[p, nzb] values (``[p, B, nzb]`` from assemble_batch:
              use :meth:`batch_select` to view one batch element)
    indices : int32[p, nzb] *local* row within the block; ``rpb`` = padding
    indptr  : int32[p, N+1]
    nnz     : int32[p] per-block nnz (blocks partition the rows, so the
              per-block counts sum to the global structural nnz)
    shape   : (M, N)
    mesh    : the :class:`~repro_torch.launch.mesh.Mesh` the sharded
              assembly ran on, and its axis name
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    nnz: torch.Tensor
    shape: tuple[int, int]
    mesh: Mesh | None = None
    axis: str = "data"

    @property
    def ranked(self) -> bool:
        """Whether this rank holds only its own block (a rank mesh)."""
        return is_rank_mesh(self.mesh)

    @property
    def n_blocks(self) -> int:
        if self.ranked:
            return axis_size(self.mesh, self.axis)
        return int(self.data.shape[0])

    @property
    def rows_per_block(self) -> int:
        return -(-self.shape[0] // self.n_blocks)

    @property
    def nzb(self) -> int:
        """Per-block slot capacity."""
        return int(self.data.shape[-1])

    def batch_select(self, b: int) -> "ShardedCSC":
        """View batch element ``b`` of an ``assemble_batch`` result."""
        if self.data.ndim != 3:
            raise ValueError("batch_select needs batched data [p, B, nzb]")
        return dataclasses.replace(self, data=self.data[:, b])

    def block(self, b: int) -> CSC:
        """Row block ``b`` as a standalone (rpb, N) padded CSC."""
        if self.data.ndim != 2:
            raise ValueError(
                "batched ShardedCSC ([p, B, nzb] data from assemble_batch); "
                "select one element with batch_select(b) first"
            )
        return CSC(
            data=self.data[b],
            indices=self.indices[b],
            indptr=self.indptr[b],
            nnz=self.nnz[b],
            shape=(self.rows_per_block, self.shape[1]),
        )

    def whole(self) -> "ShardedCSC":
        """Every block: on a rank mesh the ranks' fields gathered into
        the one-process layout (a collective: every rank calls it); on
        one device ``self``."""
        if not self.ranked:
            return self
        group = self.mesh.get_group(self.axis)
        dev = self.data.device
        p = self.n_blocks
        return dataclasses.replace(
            self, **{f: _ranks.gather(getattr(self, f)[0], group)
                     for f in ("data", "indices", "indptr", "nnz")},
            mesh=Mesh((self.axis,), (p,), (dev,) * p))

    def to_dense(self) -> torch.Tensor:
        if self.ranked:
            return self.whole().to_dense()
        M, _ = self.shape
        blocks = [self.block(b).to_dense() for b in range(self.n_blocks)]
        return torch.cat(blocks, dim=0)[:M]

    # -- linear algebra ----------------------------------------------------
    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: the shared CSC SpMV on every row block.

        ``x`` is shared (columns are global); each block computes its
        rows with the same :func:`repro_torch.core.csc.spmv` the
        single-device path uses.
        """
        if self.mesh is None:
            raise ValueError(
                "this ShardedCSC carries no mesh; rebuild it through "
                "plan_sharded(...).assemble(...) so spmv knows its "
                "device layout"
            )
        if self.data.ndim != 2:
            raise ValueError("spmv needs unbatched data; see batch_select")
        if self.ranked:
            y = csc_spmv(self.block(0), x)
            group = self.mesh.get_group(self.axis)
            return _GatherShards.apply(y, group).reshape(-1)[:self.shape[0]]
        return _sharded_spmv(self.data, self.indices, self.indptr, self.nnz,
                             x, shape=self.shape)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.spmv(x)


def _sharded_spmv(data, indices, indptr, nnz, x, *, shape):
    """The block-row SpMV: block ``b``'s rows from its own CSC, the
    results concatenated and cut to ``M`` rows."""
    M, N = shape
    p = data.shape[0]
    rpb = -(-M // p)
    ys = [csc_spmv(CSC(data=data[b], indices=indices[b], indptr=indptr[b],
                       nnz=nnz[b], shape=(rpb, N)), x) for b in range(p)]
    return torch.cat(ys)[:M]


# ---------------------------------------------------------------------------
# ShardedPattern: the sharded symbolic plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedPattern:
    """Sharded assembly plan: routing metadata + per-block patterns.

    All leading axes are the shard axis ``p``.  ``send_slot`` replays
    Phase B on values alone; ``perm``/``slot``/``indices``/``indptr``/
    ``nnz`` are each block's captured
    :class:`~repro_torch.sparse.pattern.SparsePattern` arrays (Phase C);
    ``send_base``/``block_load``/``overflow`` are the Phase A products
    (exclusive scan over the source shards, arrivals per block, capacity
    check).
    """

    send_slot: torch.Tensor   # int32[p, L_loc]; p*capacity marks dropped
    perm: torch.Tensor        # int32[p, R]   (R = p*capacity received)
    slot: torch.Tensor        # int32[p, R]; nzb marks dropped entries
    indices: torch.Tensor     # int32[p, nzb]; rpb sentinel in padded tail
    indptr: torch.Tensor      # int32[p, N+1]
    nnz: torch.Tensor         # int32[p] per-block structural nnz
    send_base: torch.Tensor   # int32[p, p] exclusive scan over sources
    block_load: torch.Tensor  # int32[p, p] arrivals per row block (the
                              # same row on every shard)
    overflow: torch.Tensor    # bool[p] any send bucket over capacity
    shape: tuple[int, int]
    L: int                    # input length
    capacity: int
    mesh: Mesh
    axis: str = "data"

    # -- static geometry ---------------------------------------------------
    @property
    def ranked(self) -> bool:
        """Whether this rank holds only its own shard (a rank mesh)."""
        return is_rank_mesh(self.mesh)

    @property
    def p(self) -> int:
        if self.ranked:
            return axis_size(self.mesh, self.axis)
        return int(self.send_slot.shape[0])

    @property
    def L_pad(self) -> int:
        """Padded input length (divisible by p)."""
        return self.p * int(self.send_slot.shape[1])

    @property
    def rpb(self) -> int:
        return -(-self.shape[0] // self.p)

    @property
    def nzb(self) -> int:
        return int(self.indices.shape[-1])

    def nnz_total(self) -> torch.Tensor:
        if self.ranked:
            return _ranks.reduce(self.nnz, self._group)[0]
        return torch.sum(self.nnz)

    def any_overflow(self) -> torch.Tensor:
        if self.ranked:
            return _ranks.reduce(self.overflow.to(torch.int32), self._group,
                                 "max")[0] > 0
        return torch.any(self.overflow)

    @property
    def _group(self):
        return self.mesh.get_group(self.axis)

    @functools.cached_property
    def _exchanger(self):
        """The exchange of the routed buffers: a transpose on one
        device, ``all_to_all_single`` over the ranks."""
        if self.ranked:
            return _RankExchange(self._group, self.p)
        return _exchange

    # -- numeric phase -----------------------------------------------------
    def assemble(self, vals: torch.Tensor) -> ShardedCSC:
        """O(L) fill: bucket scatter + the exchange + one B3' launch.

        Differentiable: the fill's backward replays the Phase-B routing
        *transposed* (gather by slot per block, the exchange, which is
        its own inverse, a gather from the send buckets).
        """
        vals = self._pad_vals(_values(vals, self.send_slot.device))
        return self._wrap(_fill_sharded(self, vals[None])[:, 0])

    def assemble_batch(self, vals_batch: torch.Tensor) -> ShardedCSC:
        """Batched fill sharing this structure: ``vals_batch`` is [B, L].

        The result's ``data`` is ``[p, B, nzb]`` (the block axis stays
        leading); everything else is unbatched.  Use
        :meth:`ShardedCSC.batch_select` per element.
        """
        vals_batch = _values(vals_batch, self.send_slot.device)
        if vals_batch.ndim != 2:
            raise ValueError("assemble_batch expects [B, L] values")
        return self._wrap(_fill_sharded(self, self._pad_vals(vals_batch)))

    def update(self, add_rows, add_cols, drop_mask=None, **kwargs):
        """Structural deltas are not routed per row block.

        An incremental merge would rewrite every block's local stream
        *and* the routing tables; re-plan with :func:`plan_sharded` over
        the concatenated triplets, or assemble unsharded and use
        :meth:`SparsePattern.update`.
        """
        raise NotImplementedError(
            "ShardedPattern.update: incremental deltas are not yet "
            "routed per row block — re-plan with plan_sharded(...) over "
            "the concatenated triplets, or assemble unsharded and use "
            "SparsePattern.update"
        )

    def _pad_vals(self, vals: torch.Tensor) -> torch.Tensor:
        """``vals`` padded to ``L_pad``; on a rank mesh this rank's
        ``L_pad / p`` slice of them (of a ``Shard(0)`` DTensor's, its
        local shard)."""
        if vals.shape[-1] != self.L:
            raise ValueError(
                f"vals has length {vals.shape[-1]} but this pattern was "
                f"planned for L={self.L} triplets"
            )
        if self.ranked:
            return _rank_slice(vals, self._group, self.p, 0)
        pad = self.L_pad - self.L
        if pad:
            vals = torch.nn.functional.pad(vals, (0, pad))
        return vals

    def _wrap(self, data: torch.Tensor) -> ShardedCSC:
        return ShardedCSC(
            data=data, indices=self.indices, indptr=self.indptr,
            nnz=self.nnz, shape=self.shape, mesh=self.mesh, axis=self.axis,
        )

    @functools.cached_property
    def _streams(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``perm`` and ``slot`` of the p blocks as one stream for B3':
        block ``d``'s positions offset by ``d * R``, its kept slots by
        ``d * nzb``, every dropped entry at the sentinel ``p * nzb``."""
        p, R, nzb = int(self.perm.shape[0]), int(self.perm.shape[1]), self.nzb
        if p == 1:
            return self.perm[0], self.slot[0]
        if p * max(R, nzb) >= 2**31:
            raise ValueError(
                f"the {p} blocks' streams ({p} x {R} positions, {p} x "
                f"{nzb} slots) do not fit int32 offsets")
        d = torch.arange(p, dtype=torch.int32,
                         device=self.perm.device)[:, None]
        perm = (self.perm + d * R).reshape(-1)
        slot = torch.where(self.slot < nzb, self.slot + d * nzb, p * nzb)
        return perm, slot.to(torch.int32).reshape(-1)


def _values(vals, device) -> torch.Tensor:
    if hasattr(vals, "device_mesh"):  # a DTensor: _pad_vals takes its shard
        return vals
    return torch.as_tensor(vals).to(device)


# ---------------------------------------------------------------------------
# Rank meshes: the slices, gathers and exchange between processes
# ---------------------------------------------------------------------------
class _TakeShard(torch.autograd.Function):
    """This rank's slice ``[index * n, (index + 1) * n)`` of the last
    axis of a value every rank holds alike.  Backward: the slices'
    cotangents gathered, so each rank holds the gradient of the global
    vector (of the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, group, p, index):
        ctx.group = group
        n = x.shape[-1] // p
        return x[..., index * n:(index + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        parts = _ranks.gather(g, ctx.group)           # [p, ..., n]
        return torch.movedim(parts, 0, -2).flatten(-2), None, None, None


class _GatherShards(torch.autograd.Function):
    """Every rank's ``x`` stacked on a leading axis (a value every rank
    then holds alike).  Backward: this rank's own row of the cotangent,
    the adjoint of :class:`_TakeShard`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.index = _rank_index(group)
        return _ranks.gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index].clone(), None


def _rank_index(group) -> int:
    import torch.distributed as dist

    return dist.get_rank(group)


def _rank_slice(x, group, p: int, pad_value) -> torch.Tensor:
    """This rank's ``ceil(L / p)`` slice of the last axis of ``x`` (the
    global vector, which every rank passes, padded with ``pad_value``),
    or the local shard of a ``Shard`` DTensor, padded to that length:
    ``torch.chunk``'s split, the reference's ``L_pad / p`` chunks."""
    L = x.shape[-1]
    n = -(-max(L, 1) // p)
    if hasattr(x, "to_local"):
        x = x.to_local()
    else:
        if n * p != L:
            x = torch.nn.functional.pad(x, (0, n * p - L), value=pad_value)
        return _TakeShard.apply(x, group, p, _rank_index(group))
    if x.shape[-1] != n:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]), value=pad_value)
    return x


class _RankExchange:
    """The tiled ``all_to_all`` over the ranks of ``group``: chunk ``d``
    of this rank's ``[..., 1, p * capacity]`` buffer goes to rank ``d``,
    chunk ``s`` of the result came from rank ``s``.  Its own adjoint."""

    def __init__(self, group, p: int):
        self.group, self.p = group, p

    def __call__(self, buf: torch.Tensor, capacity: int) -> torch.Tensor:
        shape = buf.shape
        x = buf.reshape(-1, self.p, capacity).transpose(0, 1)
        y = _ranks.exchange(x, self.group)
        return y.transpose(0, 1).reshape(shape)


# ---------------------------------------------------------------------------
# Plan time: Phases A, B (symbolic), C
# ---------------------------------------------------------------------------
def _exchange(buf: torch.Tensor, capacity: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all`` on one device: sent chunk
    ``d`` of shard ``s`` (``buf[..., s, d * capacity:]``) becomes
    received chunk ``s`` of shard ``d``.  A transpose: its own inverse."""
    *lead, p, drop = buf.shape
    return buf.unflatten(-1, (p, capacity)).transpose(-3, -2) \
        .reshape(*lead, p, drop)


def _buckets(x: torch.Tensor, send_slot: torch.Tensor, fill, *,
             drop: int) -> torch.Tensor:
    """Each shard's inputs ``x[..., n, L_loc]`` scattered into its send
    buckets ``[..., n, drop]`` (``fill`` where nothing lands, dropped
    inputs cut)."""
    buf = torch.full((*x.shape[:-1], drop + 1), fill, dtype=x.dtype,
                     device=x.device)
    buf.scatter_(-1, send_slot.long().expand_as(x), x)
    return buf[..., :drop]


def _route(x: torch.Tensor, send_slot: torch.Tensor, fill, *,
           capacity: int) -> torch.Tensor:
    """Phase B's routing of ``x[..., p, L_loc]``: the send buckets, then
    the exchange; ``[..., p, p * capacity]``."""
    return _exchange(_buckets(x, send_slot, fill,
                              drop=send_slot.shape[0] * capacity), capacity)


def _plan_phases(rows, cols, *, M: int, N: int, p: int, capacity: int,
                 nzb: int, method: str, group=None):
    """Phases A-C over all p shards, ``rows``/``cols`` int32[L_pad]; or,
    with the ``group`` of a rank mesh, over this rank's shard alone,
    ``rows``/``cols`` its int32[L_pad / p] slice."""
    dev = rows.device
    rpb = -(-M // p)
    drop = p * capacity
    n = p if group is None else 1        # the shards held here
    first = 0 if group is None else _rank_index(group)
    rows = rows.reshape(n, -1)
    cols = cols.reshape(n, -1)
    L_loc = rows.shape[1]
    shard = torch.arange(first, first + n, dtype=torch.int32,
                         device=dev)[:, None]
    dest = torch.clamp(torch.div(rows, max(rpb, 1), rounding_mode="floor"),
                       max=p - 1)
    key = torch.where(rows >= M, p, dest).to(torch.int32)

    # Phase B's stable sort by destination comes first: Phase A's
    # histogram is read off its run bounds (a scatter-add of L ones into
    # p (p + 1) counters serialises on their atomics)
    k_s, order = torch.sort(key, dim=1, stable=True)
    bounds = torch.searchsorted(
        k_s, torch.arange(p + 1, dtype=torch.int32, device=dev)
        .expand(n, p + 1).contiguous(), out_int32=True)

    # Phase A: each shard's histogram over row-block keys (padding keyed
    # p and dropped), gathered to [p, p] over the ranks; the exclusive
    # scan over the source shards gives each shard its base offset into
    # every block's arrival stream
    counts = bounds[:, 1:] - bounds[:, :-1]
    every = counts if group is None else _ranks.gather(counts[0], group)
    send_base = (torch.cumsum(every, 0) - every).to(torch.int32)
    send_base = send_base[first:first + n]
    block_load = every.sum(0, dtype=torch.int32).expand(n, p).contiguous()
    overflow = torch.any(counts > capacity, dim=1)

    # Phase B (symbolic): the position in the stable order, less its
    # destination's start, assigns each input its send-bucket slot, the
    # only thing the fill needs to replay the exchange
    offset = torch.arange(L_loc, dtype=torch.int32, device=dev) \
        - bounds.gather(1, k_s.clamp(max=p - 1).long())
    ok = (k_s < p) & (offset < capacity)
    flat = torch.where(ok, k_s * capacity + offset, drop).to(torch.int32)
    send_slot = torch.full((n, L_loc), drop, dtype=torch.int32,
                           device=dev).scatter_(1, order, flat)

    if group is None:
        r_recv = _route(rows, send_slot, M, capacity=capacity)
        c_recv = _route(cols, send_slot, 0, capacity=capacity)
    else:  # one exchange carries both index vectors
        r_recv, c_recv = _RankExchange(group, p)(torch.stack([
            _buckets(rows, send_slot, M, drop=drop),
            _buckets(cols, send_slot, 0, drop=drop)]), capacity)
    r_loc = torch.where(r_recv >= M, rpb, r_recv - shard * rpb)
    r_loc = r_loc.clamp(0, rpb).to(torch.int32)

    # Phase C: the serial symbolic analysis (Parts 1-4) on each owned
    # row block; the single-device plan's code path
    pats = [plan(r_loc[d], c_recv[d], (rpb, N), nzmax=nzb, method=method)
            for d in range(n)]
    return (send_slot,
            *(torch.stack([getattr(q, f) for q in pats])
              for f in ("perm", "slot", "indices", "indptr", "nnz")),
            send_base, block_load, overflow)


def plan_sharded(
    rows,
    cols,
    shape: tuple[int, int],
    *,
    mesh: Mesh | None = None,
    axis: str = "data",
    capacity: int | None = None,
    capacity_factor: float = 2.0,
    nzmax: int | None = None,
    method: str | None = None,
    symmetric: bool = False,
) -> ShardedPattern:
    """Run Phases A-C once; capture a reusable :class:`ShardedPattern`.

    ``rows``/``cols`` are zero-offset global index vectors of length L
    (``row == shape[0]`` marks padding; tensors or numpy arrays); they
    are padded to a multiple of the shard count internally.  The plan
    lives on the mesh's device.  ``mesh=None`` takes the default mesh
    (:func:`resolve_mesh`) of the rows' device when they are a tensor,
    else of the card.  ``capacity`` bounds each (source, destination)
    bucket (default ``capacity_factor * L_pad / p**2``, rounded up to a
    multiple of 8); ``nzmax`` is the per-block slot capacity (default:
    the per-block received length ``p * capacity``).  ``method`` selects
    the *local* sort backend of each block's Phase C (``None`` resolves
    as :func:`~repro_torch.sparse.dispatch.resolve_method` does: the
    radix planner, B1 and B2, on the card).

    On a rank mesh every rank calls it with the same arguments: the
    global vectors (each rank takes its slice) or a ``Shard(0)``
    DTensor's local shards; the plan holds this rank's shard of every
    field (see the module docstring).

    ``symmetric=True`` requests the halved strict-upper plan
    (``plan_symmetric``'s contract); the block-row partition would need
    a mirrored-entry router so each half-entry reaches both owning
    blocks, so the request is rejected as in the reference.
    """
    if symmetric:
        raise NotImplementedError(
            "plan_sharded(symmetric=True) is not supported: the "
            "block-row partition has no mirrored-entry router yet, so "
            "a symmetric plan would silently stream the full structure "
            "twice; fall back to the plain-CSC sharded plan "
            "(symmetric=False), or use plan_symmetric on one device"
        )
    mesh = resolve_mesh(mesh, axis=axis, device=rows.device if isinstance(
        rows, torch.Tensor) else None)
    dev = mesh_device(mesh)
    M, N = int(shape[0]), int(shape[1])
    p = axis_size(mesh, axis)
    group = mesh.get_group(axis) if is_rank_mesh(mesh) else None
    L = int(rows.shape[0])
    L_pad = -(-max(L, 1) // p) * p
    if group is not None:
        rows = _rank_slice(_rank_input(rows, dev), group, p, M)
        cols = _rank_slice(_rank_input(cols, dev), group, p, 0)
    else:
        rows = _index_tensor(rows).to(dev, torch.int32)
        cols = _index_tensor(cols).to(dev, torch.int32)
        if L_pad != L:
            rows = torch.nn.functional.pad(rows, (0, L_pad - L), value=M)
            cols = torch.nn.functional.pad(cols, (0, L_pad - L))
    if capacity is None:
        capacity = int(capacity_factor * L_pad / (p * p)) + 8
        capacity = -(-capacity // 8) * 8
    nzb = p * capacity if nzmax is None else int(nzmax)
    rpb = -(-M // p)
    method = resolve_method(method, dev, M=rpb, N=N, L=p * int(capacity))
    (send_slot, perm, slot, indices, indptr, nnz, send_base, block_load,
     overflow) = _plan_phases(rows, cols, M=M, N=N, p=p,
                              capacity=int(capacity), nzb=nzb, method=method,
                              group=group)
    return ShardedPattern(
        send_slot=send_slot, perm=perm, slot=slot, indices=indices,
        indptr=indptr, nnz=nnz, send_base=send_base,
        block_load=block_load, overflow=overflow, shape=(M, N), L=L,
        capacity=int(capacity), mesh=mesh, axis=axis,
    )


def _rank_input(x, device):
    """An index vector of a rank plan as int32 on ``device``: a DTensor
    keeps its layout (its local shard is taken)."""
    if hasattr(x, "to_local"):
        return x.to(torch.int32)
    return _index_tensor(x).to(device, torch.int32)


def plan_sharded_coo(coo: COO, **kwargs) -> ShardedPattern:
    """``plan_sharded`` over a :class:`repro_torch.core.COO` container."""
    return plan_sharded(coo.rows, coo.cols, coo.shape, **kwargs)


# ---------------------------------------------------------------------------
# Fill time: the O(L) numeric phase
# ---------------------------------------------------------------------------
def route_values(send_slot: torch.Tensor, v: torch.Tensor, *, p: int,
                 capacity: int, exchange=None) -> torch.Tensor:
    """Replay Phase B on values alone, for every shard at once.

    ``send_slot`` is the plan's bucket map ``int32[p, L_loc]``; ``v`` is
    ``[B, p * L_loc]``, cast once to its
    :func:`~repro_torch.sparse.pattern.fill_dtype`.  One bucket scatter
    and the exchange give the received value streams ``[B, p, p *
    capacity]`` (``[b, d]`` is block ``d``'s stream) that each block's
    pattern reduces.  On a rank mesh ``send_slot`` is this rank's
    ``int32[1, L_loc]``, ``v`` its ``[B, L_loc]`` and ``exchange`` the
    pattern's ``all_to_all`` (``ShardedPattern._exchanger``); the result
    is this rank's block's stream ``[B, 1, p * capacity]``.
    """
    dtype = fill_dtype(v)
    n = send_slot.shape[0]
    buf = _buckets(v.to(dtype).reshape(v.shape[0], n, -1), send_slot, 0,
                   drop=p * capacity)
    return (exchange or _exchange)(buf, capacity)


class _RouteFill(torch.autograd.Function):
    """The sharded numeric phase with the reference's explicit backward.

    Forward: the bucket scatter and the exchange (:func:`route_values`),
    then B3' over the p blocks' received streams as one stream
    (``ShardedPattern._streams``), once per batch row.  Backward, the
    exact transpose of that routing replayed on cotangents: a masked
    gather by slot through each block's pattern, a scatter through
    ``perm`` (a permutation of the received stream), the same exchange
    (the (source, chunk) transpose is its own inverse) and a masked
    gather out of the send buckets.
    """

    @staticmethod
    def forward(ctx, vals, send_slot, perm, slot, streams, capacity, nzb,
                p, exchange):
        # lazy: the kernel family's ops module imports sparse.pattern
        from ..kernels.segment_sum.ops import gather_segment_sum_sorted

        n = send_slot.shape[0]                   # the blocks held here
        recv = route_values(send_slot, vals, p=p, capacity=capacity,
                            exchange=exchange)
        ctx.save_for_backward(send_slot, perm, slot)
        ctx.capacity, ctx.nzb, ctx.p, ctx.exchange = capacity, nzb, p, \
            exchange
        perm_g, slot_g = streams
        out = [gather_segment_sum_sorted(r.reshape(-1), perm_g, slot_g,
                                         num_segments=n * nzb).view(n, nzb)
               for r in recv]
        if not out:
            return recv.new_zeros((n, 0, nzb))
        return torch.stack(out, dim=1)

    @staticmethod
    def backward(ctx, g):
        send_slot, perm, slot = ctx.saved_tensors
        capacity, nzb, p = ctx.capacity, ctx.nzb, ctx.p
        n, L_loc = send_slot.shape
        drop = p * capacity
        gb = g.transpose(0, 1)                       # [B, p, nzb]
        B = gb.shape[0]
        if nzb:
            g_recv = torch.where(slot < nzb, gb.gather(
                2, slot.clamp(0, nzb - 1).long().expand(B, -1, -1)), 0)
        else:
            g_recv = gb.new_zeros((B, n, drop))
        g_buf = ctx.exchange(torch.zeros_like(g_recv).scatter_(
            2, perm.long().expand(B, -1, -1), g_recv), capacity)
        sent = send_slot < drop
        g_vals = torch.where(
            sent, g_buf.gather(2, send_slot.clamp(0, drop - 1).long()
                               .expand(B, -1, -1)), 0)
        return (g_vals.reshape(B, n * L_loc), *(None,) * 8)


def _fill_sharded(pat: ShardedPattern, vals: torch.Tensor) -> torch.Tensor:
    """``[p, B, nzb]`` fills of the padded ``[B, L_pad]`` values."""
    vals = vals.to(fill_dtype(vals))
    return _RouteFill.apply(vals, pat.send_slot, pat.perm, pat.slot,
                            pat._streams, pat.capacity, pat.nzb, pat.p,
                            pat._exchanger)


# ---------------------------------------------------------------------------
# Format-registry integration (COO is the hub format)
# ---------------------------------------------------------------------------
def sharded_to_coo(A: ShardedCSC) -> COO:
    """Per-block triplets with rows rebased to global coordinates."""
    if A.data.ndim != 2:
        raise ValueError("convert() needs unbatched data; see batch_select")
    A = A.whole()
    M, N = A.shape
    rpb = A.rows_per_block
    rows, cols, vals = [], [], []
    for b in range(A.n_blocks):
        c = slot_columns(A.indptr[b], A.nzb)
        valid = A.indices[b] < rpb
        rows.append(torch.where(valid, A.indices[b] + b * rpb, M)
                    .to(torch.int32))
        cols.append(torch.where(valid, c.clamp(0, N - 1), 0)
                    .to(torch.int32))
        vals.append(torch.where(valid, A.data[b], 0))
    return COO(rows=torch.cat(rows), cols=torch.cat(cols),
               vals=torch.cat(vals), shape=A.shape)


def coo_to_sharded(A: COO, *, mesh: Mesh | None = None,
                   **plan_kwargs) -> ShardedCSC:
    """Hub conversion: plan + fill (kwargs forward to ``plan_sharded``)."""
    pat = plan_sharded(A.rows, A.cols, A.shape, mesh=mesh, **plan_kwargs)
    if bool(pat.any_overflow()):
        raise ValueError(
            "sharded routing bucket overflow during convert(); pass a "
            "larger capacity_factor/capacity (forwarded to plan_sharded)"
        )
    return pat.assemble(A.vals)


def _register() -> None:
    from .formats import register_converter, register_format

    register_format("sharded", ShardedCSC)
    register_converter(ShardedCSC, "coo", sharded_to_coo)
    register_converter(COO, "sharded", coo_to_sharded)


_register()
