"""``repro_torch.launch.specs`` against ``repro.launch.specs``: for every
config of the registry and every shape of ``SHAPES``, the dry-run
contract's shapes and dtypes (the batch, or the cache template and the
decode tokens) equal the reference's ``ShapeDtypeStruct``s, and
``cell_applicable``'s skips and reasons equal the reference's.  Nothing
is allocated: every tensor lies on the ``meta`` device (Llama-3.2-
Vision's ``decode_32k`` cache alone would be 343 GB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import specs as jspecs
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as tspecs
from repro_torch.models.config import SHAPES

torch.set_num_threads(1)


def _leaves(tree) -> dict:
    """``{keystr: leaf}`` of a dict tree of tensors or structs."""
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}


def test_the_registries_agree():
    assert ARCHS == list(JARCHS)


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape_name):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = tspecs.cell_applicable(cfg, shape)
    assert (ok, why) == jspecs.cell_applicable(cfg, shape)
    if not ok:
        with pytest.raises(ValueError) as jerr:
            jspecs.input_specs(cfg, shape_name)
        with pytest.raises(ValueError) as terr:
            tspecs.input_specs(cfg, shape_name)
        assert str(terr.value) == str(jerr.value) == why
        return
    got, want = (_leaves(tspecs.input_specs(cfg, shape_name)),
                 _leaves(jspecs.input_specs(cfg, shape_name)))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta", k
        assert tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).split(".")[-1] == str(np.dtype(w.dtype)), k


@pytest.mark.parametrize("arch", ["seamless_m4t_medium",
                                  "llama_3_2_vision_11b"])
def test_batch_specs_carry_the_stub_embeddings(arch):
    cfg = get_config(arch)
    shape = SHAPES["train_4k"]
    train = tspecs.train_batch_specs(cfg, shape)
    prefill = tspecs.prefill_batch_specs(cfg, shape)
    key, n = {"encdec": ("src_embeds", shape.seq_len),
              "vlm": ("vision_embeds", cfg.n_vision_tokens)}[cfg.family]
    assert set(train) == {"tokens", "labels", key}
    assert set(prefill) == {"tokens", key}
    assert tuple(train[key].shape) == (shape.global_batch, n, cfg.d_model)
    assert train[key].dtype == torch.bfloat16
    assert train["tokens"].dtype == torch.int32


def test_decode_specs_allocate_nothing():
    """The largest cache template there is, on the meta device; its
    bytes as the reference's ``eval_shape`` gives them."""
    cfg = get_config("llama_3_2_vision_11b")
    cache, tokens = tspecs.decode_specs(cfg, SHAPES["decode_32k"])
    jcache, jtokens = jspecs.decode_specs(cfg, SHAPES["decode_32k"])
    assert all(v.device.type == "meta" for v in cache.values())
    assert tokens.device.type == "meta"
    assert tuple(tokens.shape) == jtokens.shape == (128, 1)
    nbytes = sum(v.numel() * v.element_size() for v in cache.values())
    want = sum(int(np.prod(v.shape)) * np.dtype(v.dtype).itemsize
               for v in jax.tree.leaves(jcache))
    assert nbytes == want and nbytes > 340e9


def test_sds_is_a_meta_tensor():
    t = tspecs.sds((3, 4), "bfloat16")
    j = jspecs.sds((3, 4), "bfloat16")
    assert t.device.type == "meta" and t.dtype == torch.bfloat16
    assert tuple(t.shape) == j.shape and j.dtype == jnp.bfloat16
    assert tspecs.sds([2], torch.int32).dtype == torch.int32
