"""Shape stand-ins for every (arch x shape) dry-run cell (counterpart of
``repro/launch/specs.py``).

``input_specs`` never allocates: it returns tensors on the ``meta``
device, which carry a shape and a dtype and no storage, where the
reference returns ``jax.ShapeDtypeStruct``s (plus the cache template for
decode shapes: ``init_cache`` on the ``meta`` device, where the
reference runs it under ``jax.eval_shape``).  Modality frontends are
STUBS per the assignment: encoder/vision inputs are precomputed
embedding tensors of the documented size.

:func:`stub_embeddings` draws those tensors for a batch, as the serving
and training launchers feed them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.layers import torch_dtype
from ..models.model import init_cache


def sds(shape, dtype):
    """A tensor of ``shape`` and ``dtype`` on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    batch = {
        "tokens": sds((B, S), torch.int32),
        "labels": sds((B, S), torch.int32),
    }
    if cfg.family == "encdec":
        batch["src_embeds"] = sds((B, S, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        batch["vision_embeds"] = sds(
            (B, cfg.n_vision_tokens, cfg.d_model), cfg.dtype
        )
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    b = train_batch_specs(cfg, shape)
    del b["labels"]
    return b


def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(cache_template, tokens) for one-token decode with a full cache."""
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, batch=B, seq_len=S, device="meta")
    tokens = sds((B, 1), torch.int32)
    return cache, tokens


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "skipped: pure full-attention arch; 500k dense KV decode is "
            "outside the published operating envelope (DESIGN.md §6)"
        )
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str):
    """The dry-run contract: kwargs for the step function being lowered."""
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise ValueError(why)
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    cache, tokens = decode_specs(cfg, shape)
    return {"cache": cache, "tokens": tokens}


#: the stub frontends' inputs, in the order a batch draws them
STUB_KEYS = ("src_embeds", "vision_embeds")


def stub_embeddings(specs: dict, rng: np.random.Generator, device) -> dict:
    """The stub frontends' embeddings for a batch of ``specs`` (the
    entries of :data:`STUB_KEYS` it holds, in that order): standard
    normal float64 draws from ``rng``, rounded to each spec's dtype on
    the host (float64 to float32 to the dtype, as ``jnp.asarray(draw,
    dtype)`` rounds), then moved to ``device``."""
    return {k: torch.from_numpy(rng.normal(size=tuple(specs[k].shape)))
            .to(specs[k].dtype).to(device)
            for k in STUB_KEYS if k in specs}
