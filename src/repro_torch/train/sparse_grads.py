"""Embedding-gradient sparse accumulation: the paper inside the LM.

Counterpart of ``repro/train/sparse_grads.py``.  The backward of the
lookup ``table[tokens]`` is the assembly problem: triplets ``(token_id,
0, grad_row)`` with many collisions (the paper's data set 3 regime).
Instead of a colliding scatter-add it runs the fsparse pipeline: a
stable counting sort of the token ids (Parts 1 and 2: B12 and B11 on the
card, their plain versions on the CPU), the shared Parts 3-4 over a
(V, 1) matrix, :meth:`~repro_torch.sparse.pattern.SparsePattern
.reduce_rows` into one slot per distinct token, then ONE collision-free
scatter of the unique rows.  The permutation is the reference's
``argsort(tokens, stable=True)``.
"""
from __future__ import annotations

import torch

from ..kernels.counting_sort.ops import counting_sort
from ..models.shards import (keep_shards, mesh_of, moved, on_shards,
                             partial_over, vocab_lookup)
from ..sparse.ops import scatter_rows
from ..sparse.pattern import pattern_from_perm


def embed_grad(tokens: torch.Tensor, g: torch.Tensor, *, vocab: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``d table`` of ``table[tokens]`` for the output gradient ``g``
    (``[..., D]``): ``[vocab, D]`` in ``dtype``, summed in float32 within
    the bound of ``reduce_rows``."""
    D = g.shape[-1]
    tok = tokens.reshape(-1).to(torch.int32)            # [T]
    gm = g.reshape(-1, D).to(torch.float32)             # [T, D]
    # a single column: the (col, row) order IS the row order, so one
    # stable sort feeds Parts 3-4 directly
    perm, _ = counting_sort(tok, nbins=vocab)
    pat = pattern_from_perm(tok, torch.zeros_like(tok), perm, M=vocab, N=1,
                            nzmax=tok.shape[0])
    summed = pat.reduce_rows(gm)                        # [T, D] slot sums
    # pat.indices holds each slot's token (the sentinel vocab in the
    # padded tail, dropped): one collision-free scatter of unique rows
    return scatter_rows(pat.indices, summed, num_slots=vocab).to(dtype)


def _sharded_embed_grad(tokens, g, *, vocab: int, dtype: torch.dtype):
    """:func:`embed_grad` of DTensors: each rank assembles the whole
    ``[vocab, D]`` gradient of its own tokens (B12/B11 on its local
    keys, under ``local_map``); the result is a partial sum over the mesh
    dims that shard the tokens, replicated over the others."""
    t_pl = keep_shards(tokens, (0,))
    g_pl = moved(t_pl, {0: 0})
    return on_shards(
        lambda t, x: embed_grad(t, x, vocab=vocab, dtype=dtype),
        mesh_of(tokens), (t_pl, g_pl), partial_over(t_pl))(tokens, g)


class _SparseGradEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        return vocab_lookup(table, tokens)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        grad = _sharded_embed_grad if mesh_of(tokens) is not None \
            else embed_grad
        return grad(tokens, g, vocab=ctx.vocab, dtype=ctx.dtype), None


def sparse_grad_embed(table: torch.Tensor, tokens: torch.Tensor
                      ) -> torch.Tensor:
    """Embedding lookup whose backward assembles the gradient
    fsparse-style (:func:`embed_grad`)."""
    return _SparseGradEmbed.apply(table, tokens)
