"""Path-based sharding rules: param/cache/batch trees -> PartitionSpecs
(counterpart of ``repro/launch/sharding.py``).

Every parameter name encodes its layout contract (see models/layers.py):
  *_in   [d_model, F]      -> P("data", "model")   (column parallel + FSDP)
  *_out  [F, d_model]      -> P("model", "data")   (row parallel + FSDP)
  *_ein  [E, D, F]         -> P("model", None, None)  (expert parallel)
  *_eout [E, F, D]         -> P("model", None, None)
  embedding [V, D]         -> P("model", "data")   (vocab parallel)
  norms / scalars          -> replicated

Divisibility is checked against the mesh: a rule that does not divide
falls back to replication on that dim (e.g. gemma3's single KV head).

The reference stacks a subtree's blocks on a leading layer axis and
pads that axis's entry with None; the port keeps a list of blocks
(``models/layers.py``).  :func:`param_specs` names each block's leaf by
the reference's path (``"layers/attn/q_in"``, no block index), asks the
rules for the stacked shape and drops the layer entry, so every block
gets the reference's spec less its first entry.  A :class:`P` holds
what the reference's ``PartitionSpec`` holds: per tensor dim ``None``,
an axis name, or a tuple of names that shard the dim major to minor.
:func:`param_shardings` turns specs into DTensor placements on a
``DeviceMesh``; :func:`place` puts a tree's tensors there as DTensors
(the dry run's templates on its fake group, a real state or batch on a
rank mesh), and :func:`place_on_mesh` does so by these rules.

Serving (the reference's dry run, ``build_lowered``): :func:`serving_mode`
chooses the weights' layout, ``"serve"`` (TP only) where a model shard
fits :data:`SERVE_PARAM_BUDGET`, else ``"train"``; :func:`node_placer`
places a model node by node as ``init_model`` draws it;
:func:`place_cache` and :func:`place_tokens` place a serving cache and a
token batch.
"""
from __future__ import annotations

import re

from ..models.layers import Params, _is_node, _is_stack
from .mesh import axis_names, axis_size, batch_axes


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis
    name, or a tuple of names), compared as a tuple, as the reference's
    ``PartitionSpec`` is built: ``P("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# (regex on "/"-joined path, spec for the *trailing* dims)
# NOTE (§Perf iteration 1): the embedding was originally ("model","data");
# the D-axis data-sharding forced the SPMD partitioner into "involuntary
# full rematerialization" of the token gather (replicate + re-partition),
# costing 5x HBM bytes and 21x collective bytes on qwen3 train_4k probes.
# ("model", None) removes the pathological reshard.
PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embedding$", ("model", None)),
    (r"router$", (None, None)),
    (r"(gate|up)_ein$", ("model", "data", None)),
    (r"down_eout$", ("model", None, "data")),
    (r"_in$", ("data", "model")),
    (r"_out$", ("model", "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(a_log|d_skip|dt_bias)$", ("model",)),
    (r"gnorm/scale$", ("model",)),
    (r"scale$", (None,)),
]


def _fits(mesh, axis, size: int) -> bool:
    if axis is None:
        return True
    return size % axis_size(mesh, axis) == 0


def spec_for_param(mesh, path: str, shape: tuple[int, ...],
                   *, mode: str = "train") -> P:
    """mode="train": FSDP("data") + TP("model").  mode="serve": TP only.

    §Perf iteration 4: FSDP weight sharding is wrong for decode — each
    step all-gathers every layer's weights over "data" to do a tiny
    [B,1,D] matmul (mamba2 decode_32k: 48 x 19.8 MB per token).  Serving
    replicates weights across "data" (they fit: params/TP per device)
    and keeps only TP sharding; the all-gather disappears.
    """
    for pattern, core in PARAM_RULES:
        if re.search(pattern, path):
            core = list(core)
            ndim = len(shape)
            if len(core) > ndim:          # e.g. scalar where rule has 1 dim
                core = core[-ndim:] if ndim else []
            spec = [None] * (ndim - len(core)) + core
            if mode == "serve":
                spec = [None if a == "data" else a for a in spec]
            # divisibility fallback -> replicate that dim
            spec = [
                a if _fits(mesh, a, shape[i]) else None
                for i, a in enumerate(spec)
            ]
            return P(*spec)
    return P()  # replicate


def map_with_path(fn, tree, prefix: str = "", blocks=None):
    """``fn(name, leaf, blocks)`` over the leaves of a port tree (the
    shape of :func:`~repro_torch.models.layers.tree_map`'s result:
    dicts for nodes, lists for stacks).  ``name`` is the reference's
    ``"/"``-joined path; ``blocks`` is the length of the stack a leaf
    lies in (the reference's leading layer axis), else None.  A
    :class:`P` is a leaf."""
    if isinstance(tree, P):
        return fn(prefix[:-1], tree, blocks)
    if _is_node(tree):
        return {k: map_with_path(fn, tree[k], f"{prefix}{k}/", blocks)
                for k in sorted(tree.keys())}
    if _is_stack(tree):
        return [map_with_path(fn, t, prefix, len(tree)) for t in tree]
    return fn(prefix[:-1], tree, blocks)


def _leaf_spec(mesh, name, leaf, blocks, mode) -> P:
    shape = tuple(leaf.shape)
    if blocks is None:
        return spec_for_param(mesh, name, shape, mode=mode)
    return P(*spec_for_param(mesh, name, (blocks, *shape), mode=mode)[1:])


def param_specs(mesh, params, *, mode: str = "train"):
    """PartitionSpec tree mirroring ``params`` (a model, or a whole train
    state: ``params/...``, ``opt/master/...``, ``opt/mu/...``,
    ``opt/nu/...``, ``ef/...``, ``step``).  A block's leaf gets the
    reference's spec of the stacked leaf with the layer entry dropped."""
    return map_with_path(
        lambda name, leaf, blocks: _leaf_spec(mesh, name, leaf, blocks, mode),
        params)


def placements(mesh, spec: P, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where entry ``d`` names that axis or holds it in a
    tuple, else ``Replicate()``.  A tuple shards its dim over several
    mesh dims, major to minor, which must be the mesh's own order (as
    DTensor splits).  With ``shape``, every placed dim must divide
    evenly: DTensor allows uneven shards, the reference does not."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims) or len(set(dims)) != len(dims):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are "
                             f"not in the mesh's order {names}")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {spec} names axis {names[m]} twice")
            out[m] = Shard(d)
        if shape is not None and shape[d] % axis_size(mesh, axes):
            raise ValueError(f"spec {spec}: dim {d} of {tuple(shape)} does "
                             f"not divide over {axes}")
    return tuple(out)


def param_shardings(mesh, params, *, mode: str = "train"):
    """DTensor placements (a tuple per leaf, one per mesh dim) mirroring
    ``params``, from :func:`param_specs`; every placed dim divides."""
    return map_with_path(
        lambda name, leaf, blocks: placements(
            mesh, _leaf_spec(mesh, name, leaf, blocks, mode), leaf.shape),
        params)


def place(mesh, tree, specs):
    """``tree`` with every tensor a DTensor placed on ``mesh`` by its
    spec in ``specs``; a :class:`Params` model stays a model (DTensor
    parameters).  Each rank keeps its own shards of the whole tensor it
    holds (``src_data_rank=None``: nothing is sent), so every rank must
    hold the same values: the same seed, the same checkpoint or batch.
    A shard is copied out of the whole tensor, so that the caller frees
    the whole by dropping it; a replicated tensor is the caller's own."""
    from torch import nn
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, Params):
        out = Params()
        for k in tree.keys():
            out[k] = place(mesh, tree[k], specs[k])
        return out
    if isinstance(tree, nn.ModuleList):
        return nn.ModuleList([place(mesh, t, s)
                              for t, s in zip(tree, specs)])
    if isinstance(tree, dict):
        return {k: place(mesh, tree[k], specs[k]) for k in tree}
    if isinstance(tree, list):
        return [place(mesh, t, s) for t, s in zip(tree, specs)]
    whole = tree.detach()
    out = distribute_tensor(whole, mesh, placements(mesh, specs, tree.shape),
                            src_data_rank=None)
    local = out.to_local()
    if local._is_view() and local.numel() < whole.numel():
        # a view into the whole would keep all of it alive on every rank
        out = DTensor.from_local(local.clone(), mesh, out.placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


#: the bytes of weights a device may hold in ``"serve"`` mode (TP only,
#: replicated over the data axes): above it the weights keep the
#: ``"train"`` layout, FSDP over data as well (the reference's dry run,
#: ``launch/dryrun.py`` ``build_lowered``: dbrx-132b's 16.5 GiB a device)
SERVE_PARAM_BUDGET = 8 * 2**30


def serving_mode(mesh, param_bytes: int) -> str:
    """The layout of served weights: ``"serve"`` when ``param_bytes`` over
    the mesh's ``model`` size is under :data:`SERVE_PARAM_BUDGET`, else
    ``"train"``.  The dry run's serving cells and the serving launcher
    both ask here, so the two never differ."""
    return "serve" if param_bytes / axis_size(mesh, "model") < \
        SERVE_PARAM_BUDGET else "train"


def param_bytes(params) -> int:
    """The bytes of every tensor of a model (fake or meta tensors too)."""
    out = []
    map_with_path(lambda name, leaf, blocks: out.append(leaf), params)
    return sum(t.numel() * t.element_size() for t in out)


def model_param_bytes(cfg) -> int:
    """The bytes of ``cfg``'s weights, from a template drawn on fake
    tensors (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import init_model

    with FakeTensorMode():
        return param_bytes(init_model(cfg, device="cpu"))


def node_placer(mesh, mode: str):
    """``place(name, node, blocks)`` for ``init_model(..., place=)``: a
    top-level node of a model (``"embed"``, ``"final_norm"``, ...) or one
    block of the stack ``name`` (``blocks`` long) placed on ``mesh`` by
    :func:`param_specs` in ``mode``, as the whole model would be.  Each
    rank then holds its shards and one whole block at a time, never the
    whole model."""
    def place_node(name, node, blocks=None):
        specs = map_with_path(
            lambda n, leaf, b: _leaf_spec(mesh, n, leaf, b, mode), node,
            f"{name}/", blocks)
        return place(mesh, node, specs)

    return place_node


def place_on_mesh(mesh, tree, *, batch: int | None = None,
                  mode: str = "train"):
    """A train state or a model (:func:`param_specs` in ``mode``) or,
    with ``batch`` (its row count), a batch of ``[B, ...]`` arrays
    (:func:`batch_specs_for`: rows over the data axes) placed on a rank
    mesh by :func:`place`."""
    specs = param_specs(mesh, tree, mode=mode) if batch is None else \
        batch_specs_for(mesh, tree, batch=batch)
    return place(mesh, tree, specs)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------
def batch_spec(mesh, *, batch: int) -> P:
    """Sharding for [B, S]-leading arrays; B=1 falls back to replication."""
    dp = batch_axes(mesh)
    if _fits(mesh, dp, batch):
        return P(dp, None)
    return P(None, None)


def batch_specs_for(mesh, batch_tree, *, batch: int):
    dp = batch_axes(mesh)
    dp_ok = _fits(mesh, dp, batch)

    def one(path, leaf, blocks):
        spec = [None] * leaf.ndim
        if leaf.ndim and dp_ok:
            spec[0] = dp
        return P(*spec)

    return map_with_path(one, batch_tree)


def cache_specs(mesh, cache, cfg, *, batch: int):
    """KV/state cache specs.  batch==1 (long-context) shards *sequence*."""
    dp = batch_axes(mesh)
    # singleton axis tuples are unwrapped so spec entries compare as
    # plain axis names ("data", not ("data",))
    dp = dp[0] if isinstance(dp, tuple) and len(dp) == 1 else dp
    dp_ok = _fits(mesh, dp, batch)
    tp_ok_kv = _fits(mesh, "model", cfg.n_kv_heads)
    H_ssm = cfg.ssm.n_heads(cfg.d_model) if cfg.family in ("ssm", "hybrid") else 0
    conv_ch = (
        cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        if H_ssm else 0
    )

    def one(name, leaf, blocks):
        nd = leaf.ndim
        if name == "pos":
            return P()
        if name in ("k", "v", "ck", "cv"):      # [L, B, S, Hkv, Dh]
            spec = [None] * nd
            seq_axes = []
            if dp_ok:
                spec[1] = dp
            elif leaf.shape[2] % _total(mesh, dp) == 0:
                seq_axes.extend(dp if isinstance(dp, tuple) else (dp,))
            if tp_ok_kv:
                spec[3] = "model"
            elif leaf.shape[2] % (_total(mesh, seq_axes or ()) *
                                  axis_size(mesh, "model")) == 0:
                # §Perf iteration 8: too few KV heads to TP-shard (gemma
                # kv=1, starcoder kv=4, qwen/dbrx/llama kv=8 on a 16-way
                # model axis) -> the cache was REPLICATED across "model".
                # Shard the SEQUENCE dim there instead: softmax max/sum
                # and the PV contraction reduce over it, so GSPMD inserts
                # small psums; cache memory and the decode all-gather
                # drop by the TP degree.
                seq_axes.append("model")
            if seq_axes:
                spec[2] = seq_axes[0] if len(seq_axes) == 1 \
                    else tuple(seq_axes)
            return P(*spec)
        if name == "state":                      # [L, B, H, N, P]
            spec = [None] * nd
            if dp_ok:
                spec[1] = dp
            if H_ssm and _fits(mesh, "model", H_ssm):
                spec[2] = "model"
            return P(*spec)
        if name == "conv":                       # [L, B, W-1, ch]
            spec = [None] * nd
            if dp_ok:
                spec[1] = dp
            if conv_ch and _fits(mesh, "model", conv_ch):
                spec[3] = "model"
            return P(*spec)
        return P()

    return map_with_path(one, cache)


def place_cache(mesh, cache, cfg, *, batch: int):
    """A serving cache (``init_cache``'s tree, ``batch`` rows) placed on a
    rank mesh by :func:`cache_specs`; every rank holds the same whole
    cache."""
    return place(mesh, cache, cache_specs(mesh, cache, cfg, batch=batch))


def place_tokens(mesh, tokens):
    """A ``[B, ...]`` token batch placed on a rank mesh: rows over the
    data axes where B divides, else replicated (:func:`batch_spec`)."""
    spec = batch_spec(mesh, batch=tokens.shape[0])
    return place(mesh, tokens, P(*spec[:1], *(None,) * (tokens.ndim - 1)))


def _total(mesh, axes) -> int:
    return axis_size(mesh, axes)  # == 1 for empty axes


def logits_spec(mesh, *, batch: int) -> P:
    dp = batch_axes(mesh)
    dp_ok = _fits(mesh, dp, batch)
    return P(dp if dp_ok else None, None, "model")
