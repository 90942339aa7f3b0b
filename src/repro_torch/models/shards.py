"""The model's functions on each rank's local shards of DTensors.

A model whose parameters and batch are DTensors on a
``torch.distributed`` ``DeviceMesh`` (the dry run, ``launch/dryrun.py``)
runs most ops through DTensor's own sharding rules.  A few functions
need the local shards instead, through ``local_map``:

* the B12/B11 custom ops of the MoE dispatch and of the embedding
  gradient, which have no sharding rule (the reference runs the MoE
  dispatch under ``shard_map``);
* attention and the SSD scan, whose einsums fold a batch dim sharded on
  one mesh axis and a head dim sharded on another into one, which DTensor
  cannot propagate;
* the lookups in a vocabulary-sharded table (the embedding's rows, the
  loss's gold logits): each rank reads its own rows and the result is a
  partial sum over the vocabulary's mesh dims.

Each helper here is the identity for plain tensors: the model's plain
path does not change.
"""
from __future__ import annotations

import contextlib

import torch


def mesh_of(*xs):
    """The ``DeviceMesh`` of the first DTensor among ``xs``, else None."""
    for x in xs:
        mesh = getattr(x, "device_mesh", None)
        if mesh is not None:
            return mesh
    return None


def placed_like(x, ref):
    """``x`` laid out as ``ref`` (a DTensor gradient reduced and
    scattered onto its parameter's shards); ``x`` itself otherwise."""
    if mesh_of(x) is None or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(placements=ref.placements)


def replicating(x):
    """A context in which plain tensors meeting DTensors are taken as
    replicated, when ``x`` is a DTensor (positions, masks and the like
    that the model makes itself); nothing otherwise."""
    if mesh_of(x) is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    # implicit_replication() switches the flag off on exit: entered once,
    # by the outermost entry point (a train step's loss, say)
    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


def on_shards(fn, mesh, in_placements, out_placements):
    """``fn`` applied to each rank's local shards, its inputs first
    redistributed to ``in_placements`` (None for a non-tensor argument),
    its outputs wrapped as DTensors with ``out_placements``.

    An input replicated over a mesh dim that shards another input (a
    weight beside a batch split over ``data``) meets different data on
    each rank of that dim: its gradient there is each rank's share of a
    sum, ``Partial()`` (:func:`_grad_placements`), where ``local_map``
    would take it as replicated."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    def each(pls):  # local_map reads a list as one tensor's placements
        return tuple(None if p is None else list(p) for p in pls)

    single = bool(out_placements) and isinstance(out_placements[0], Placement)
    return local_map(fn, out_placements=list(out_placements) if single
                     else each(out_placements),
                     in_placements=each(in_placements),
                     in_grad_placements=each(_grad_placements(in_placements)),
                     device_mesh=mesh, redistribute_inputs=True)


def _grad_placements(in_placements) -> tuple:
    """The gradients' placements of ``on_shards``' inputs: ``Partial()``
    on every mesh dim where the input is replicated and another input is
    sharded (the ranks of that dim compute on different data), else the
    input's own placement."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    split = {m for pls in in_placements if pls is not None
             for m, p in enumerate(pls) if isinstance(p, Shard)}
    return tuple(None if pls is None else tuple(
        Partial() if m in split and isinstance(p, Replicate) else p
        for m, p in enumerate(pls)) for pls in in_placements)


def replicate(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def keep_shards(x, dims, sizes=None) -> tuple:
    """``x``'s placements with only its shards of tensor dims ``dims``
    kept (``sizes[d]``, where given, must divide over the mesh dim), the
    rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for m, p in enumerate(x.placements):
        ok = isinstance(p, Shard) and type(p) is Shard and p.dim in dims
        if ok and sizes and p.dim in sizes:
            ok = sizes[p.dim] % x.device_mesh.size(m) == 0
        out.append(Shard(p.dim) if ok else Replicate())
    return tuple(out)


def split_work(x, dims, sizes=None) -> tuple:
    """Placements that split ``x``'s work over the mesh along tensor dims
    ``dims`` (batch rows, heads, ...): a mesh dim keeps ``x``'s shard of
    one of them; any other mesh dim (replicated, a partial sum, a shard
    of another dim) takes the first of ``dims`` that still divides
    evenly (``sizes[d]``, default ``x.shape[d]``), else is replicated.
    A partial sum is so reduced and scattered at once, where gathering
    it whole would repeat the work on every rank of that mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    size = {d: (sizes or {}).get(d, x.shape[d]) for d in dims}
    out = [None] * mesh.ndim
    for m, p in enumerate(x.placements):  # keep the shards that fit
        if type(p) is Shard and p.dim in dims and size[p.dim] % \
                mesh.size(m) == 0:
            out[m] = Shard(p.dim)
            size[p.dim] //= mesh.size(m)
    for m in range(mesh.ndim):
        if out[m] is None:
            d = next((d for d in dims if size[d] % mesh.size(m) == 0
                      and mesh.size(m) > 1), None)
            out[m] = Replicate() if d is None else Shard(d)
            if d is not None:
                size[d] //= mesh.size(m)
    return tuple(out)


def split_last(x, *shape):
    """``x.reshape(*x.shape[:-1], *shape)``.  A DTensor whose last dim is
    sharded where the first new dim does not divide (four heads over a
    16-way axis) is gathered on those mesh dims first: DTensor splits a
    sharded dim only at shard boundaries."""
    mesh = mesh_of(x)
    if mesh is not None:
        from torch.distributed.tensor import Replicate, Shard

        last, n = x.ndim - 1, shape[0]
        pl = []
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                ok = n % mesh.size(m) == 0
                n //= mesh.size(m) if ok else 1
                pl.append(p if ok else Replicate())
            else:
                pl.append(p)
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(placements=pl)
    return x.reshape(*x.shape[:-1], *shape)


def moved(placements, mapping: dict) -> tuple:
    """``placements`` with ``Shard(d)`` turned into ``Shard(mapping[d])``
    (``None``: replicated) for another tensor's layout."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in placements:
        if isinstance(p, Shard):
            d = mapping.get(p.dim)
            out.append(Replicate() if d is None else Shard(d))
        else:
            out.append(p)
    return tuple(out)


def partial_over(placements, dims=None) -> tuple:
    """``Partial()`` where ``placements`` shards (tensor dims ``dims``,
    or any), else ``Replicate()``: the layout of a sum whose terms are
    spread over those mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Partial() if isinstance(p, Shard)
                 and (dims is None or p.dim in dims) else Replicate()
                 for p in placements)


def _partial_else(partials, others) -> tuple:
    """Mesh dim by mesh dim: the ``Partial`` of ``partials``, else the
    placement of ``others``."""
    from torch.distributed.tensor import Partial

    return tuple(p if isinstance(p, Partial) else o
                 for p, o in zip(partials, others))


def shard_start(x_shape, mesh, placements, dim: int) -> int:
    """The global index of this rank's first row of ``dim`` (evenly
    split; mesh dims that shard ``dim`` split it major to minor)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    index, parts = 0, 1
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            index = index * mesh.size(m) + coord[m]
            parts *= mesh.size(m)
    if x_shape[dim] % parts:
        raise ValueError(f"dim {dim} of {tuple(x_shape)} does not split "
                         f"evenly into {parts}")
    return index * (x_shape[dim] // parts)


def vocab_lookup(table, ids):
    """``table[ids]``; for a DTensor ``table`` each rank reads the ids in
    its own rows (zeros elsewhere), and the partial sums over the mesh
    dims that shard the vocabulary are then reduced (the all-reduce of a
    vocabulary-parallel embedding): the rows come out sharded as ``ids``
    and replicated over the vocabulary's mesh dims."""
    mesh = mesh_of(table)
    if mesh is None:
        return table[ids]
    t_pl = keep_shards(table, (0,))
    i_pl = keep_shards(ids, (0,))
    start = shard_start(table.shape, mesh, t_pl, 0)
    nd = ids.ndim
    out_pl = _partial_else(partial_over(t_pl), i_pl)

    def local(t, i):
        rel = i.long() - start
        inside = (rel >= 0) & (rel < t.shape[0])
        rows = t[rel.clamp(0, t.shape[0] - 1)]
        return torch.where(inside.reshape(*inside.shape, *(1,) * (
            rows.ndim - nd)), rows, torch.zeros((), dtype=rows.dtype,
                                                device=rows.device))

    rows = on_shards(local, mesh, (t_pl, i_pl), out_pl)(table, ids)
    return rows.redistribute(placements=i_pl)


def gold_logits(lf, labels):
    """``lf[..., labels]`` (``lf`` ``[B, S, V]``, ``labels`` ``[B, S]``
    int64 in range); for a DTensor each rank reads the labels in its own
    vocabulary slice, a partial sum over those mesh dims."""
    mesh = mesh_of(lf)
    if mesh is None:
        return torch.gather(lf, -1, labels[..., None])[..., 0]
    l_pl = keep_shards(lf, (0, 2))
    b_pl = moved(l_pl, {0: 0})
    start = shard_start(lf.shape, mesh, l_pl, 2)
    out_pl = _partial_else(partial_over(l_pl, (2,)), b_pl)

    def local(x, lab):
        rel = lab - start
        inside = (rel >= 0) & (rel < x.shape[-1])
        g = torch.gather(x, -1, rel.clamp(0, x.shape[-1] - 1)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros(
            (), dtype=x.dtype, device=x.device))

    return on_shards(local, mesh, (l_pl, b_pl), out_pl)(lf, labels)


def greedy_tokens(logits, vocab: int):
    """The greedy next tokens ``[B, 1]`` (int64) of last-position logits
    ``[B, S, V]``: the argmax over the first ``vocab`` entries (the rest
    pad the vocabulary), the first of equal maxima.  For a DTensor whose
    vocabulary is sharded each rank takes the best of its own slice;
    the ranks of those mesh dims then swap one value and one index a row
    (not the logits) and keep the first best, so the result is the
    argmax over the whole vocabulary, its rows as the logits' rows and
    replicated over every other mesh dim."""
    mesh = mesh_of(logits)
    if mesh is None:
        return torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
    x = logits[:, -1]
    pl = keep_shards(x, (0, 1))
    start = shard_start(x.shape, mesh, pl, 1)

    def best(xl):
        cols = start + torch.arange(xl.shape[1], device=xl.device)
        xl = xl.masked_fill(cols >= vocab, float("-inf"))
        idx = torch.argmax(xl, dim=-1, keepdim=True)
        return torch.gather(xl, 1, idx), idx + start

    rows = keep_shards(x, (0,))
    vals, idx = on_shards(best, mesh, (pl,), (pl, pl))(x)

    def pick(v, i):
        return torch.gather(i, 1, torch.argmax(v, dim=1, keepdim=True))

    return on_shards(pick, mesh, (rows, rows), rows)(vals, idx)

