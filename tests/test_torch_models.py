"""The port's LM serving path against the JAX package, on the CPU.

The same weights (the reference's init, carried across with
``params_from_numpy``) and the same seeded inputs go through both
packages at reduced sizes.  Tolerances, relative to the largest
magnitude of the reference's output:

* float32: ``F32_RTOL = 1e-5`` (the two packages' float32 matmuls and
  transcendental functions round differently in the last bits; measured
  about 1e-6);
* bfloat16: ``BF16_RTOL = 4e-2``, about five bf16 eps (2^-7 each): every
  product and sum rounds to bf16 in both packages, in another order.
  The whole-model bf16 case is a dense model: MoE routing is not
  continuous, and a one-ulp difference in a bf16 router input can flip
  a top-k choice (at the reduced top-2 of 8, half a token's output).

The MoE dispatch and layer are held in ``tests/test_torch_moe.py``.
"""
import contextlib
import dataclasses
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_ENV = dict(os.environ)  # the serving launchers tune it at import
import repro.models.runtime_flags as jflags  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.config import SHAPES as JAX_SHAPES
from repro_torch.configs import ARCHS, all_configs, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import runtime_flags as tflags
from repro_torch.models.config import SHAPES  # noqa: E402

os.environ.clear()
os.environ.update(_ENV)
torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _weights(cfg, seed=0):
    params = jmodel.init_model(jax.random.key(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    return params, tree, tmodel.params_from_numpy(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_config_fields_and_counts_match_reference(arch):
    want = jax_get_config(arch)
    got = get_config(arch.replace("_", "-"))  # the alias too
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_params, got.n_active_params, got.padded_vocab,
            got.resolved_head_dim) == (want.n_params, want.n_active_params,
                                       want.padded_vocab,
                                       want.resolved_head_dim)
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())


def test_registry_and_shapes_match_reference():
    assert ARCHS == JAX_ARCHS
    assert list(all_configs()) == list(jax_all_configs())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    # the slice's model: OLMoE-1B-7B fits one 80 GB card in bf16
    cfg = get_config("olmoe_1b_7b")
    assert cfg.padded_vocab == 50_432 and cfg.n_params == 6_813_908_992


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["rmsnorm", "rmsnorm_none", "layernorm",
                                "rope"])
def test_norms_and_rope_match_reference(fn, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    xj = jnp.asarray(x, dtype)
    xt = _t(x).to(getattr(torch, dtype))
    if fn == "rmsnorm":
        want = jlayers.rmsnorm({"scale": jnp.asarray(scale, dtype)}, xj)
        got = tlayers.rmsnorm({"scale": _t(scale).to(xt.dtype)}, xt)
    elif fn == "rmsnorm_none":
        want, got = jlayers.rmsnorm(None, xj), tlayers.rmsnorm(None, xt)
    elif fn == "layernorm":
        want = jlayers.nonparametric_layernorm(xj)
        got = tlayers.nonparametric_layernorm(xt)
    else:
        want = jlayers.apply_rope(xj, jnp.asarray(pos), 10_000.0)
        got = tlayers.apply_rope(xt, _t(pos), 10_000.0)
    assert got.dtype == xt.dtype
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert _rel_err(got, want) <= tol


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,Sq,Sk,kv_chunk,q_offset", [
    (True, 0, 16, 16, 8, 0),     # causal, two chunks
    (True, 5, 16, 16, 4, 0),     # sliding window
    (True, 0, 11, 13, 4, 2),     # Sk not a multiple of kv_chunk, offset
    (False, 0, 7, 13, 1024, 0),  # non-causal, one chunk wider than Sk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(causal, window, Sq, Sk,
                                             kv_chunk, q_offset, dtype):
    rng = np.random.default_rng(Sq * Sk + window)
    q = rng.normal(size=(2, Sq, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, Sk, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, Sk, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, kv_chunk=kv_chunk,
              q_offset=q_offset)
    want = jattn.chunked_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                   **kw)
    got = tattn.chunked_attention(*(_t(a).to(getattr(torch, dtype))
                                    for a in (q, k, v)), **kw)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype,cache_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
])
def test_decode_attention_matches_reference(dtype, cache_dtype):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 9, 2, 16)).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q, dtype),
                                  jnp.asarray(k, cache_dtype),
                                  jnp.asarray(v, cache_dtype))
    got = tattn.decode_attention(_t(q).to(getattr(torch, dtype)),
                                 _t(k).to(getattr(torch, cache_dtype)),
                                 _t(v).to(getattr(torch, cache_dtype)))
    tol = F32_RTOL if cache_dtype == "float32" else BF16_RTOL
    assert got.dtype == getattr(torch, dtype)
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize("entry", ["self_attention", "self_windowed",
                                   "cross_attention", "self_decode",
                                   "self_decode_windowed", "cross_decode",
                                   "rope_kv_for_cache", "mlp"])
def test_block_entry_points_match_reference(entry):
    cfg = get_config("qwen3_0_6b").reduced(dtype="float32")
    attn = jattn.init_attention(jax.random.key(1), cfg)
    cross = jattn.init_attention(jax.random.key(2), cfg, cross=True)
    mlp_p = jlayers.init_mlp(jax.random.key(3), cfg.d_model, cfg.d_ff,
                             jnp.float32)
    pt = {k: tmodel._node(jax.tree.map(np.asarray, v), "cpu")
          for k, v in (("attn", attn), ("cross", cross), ("mlp", mlp_p))}
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    shape = (2, 12, cfg.n_kv_heads, cfg.resolved_head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    J, T = jnp.asarray, _t
    if entry in ("self_attention", "self_windowed"):
        w = 5 if entry == "self_windowed" else 0
        want = jattn.self_attention(attn, J(x), cfg, positions=J(pos),
                                    window=w, kv_chunk=4)
        got = tattn.self_attention(pt["attn"], T(x), cfg, positions=T(pos),
                                   window=w, kv_chunk=4)
    elif entry == "cross_attention":
        want = jattn.cross_attention(cross, J(x), J(src), cfg, kv_chunk=4)
        got = tattn.cross_attention(pt["cross"], T(x), T(src), cfg,
                                    kv_chunk=4)
    elif entry in ("self_decode", "self_decode_windowed"):
        w = 6 if entry == "self_decode_windowed" else 0
        want = jattn.self_attention_decode(attn, J(x1), J(ck), J(cv), cfg,
                                           position=J(np.int32(14)),
                                           window=w)
        k0 = T(ck)
        got = tattn.self_attention_decode(pt["attn"], T(x1), k0, T(cv), cfg,
                                          position=torch.tensor(14),
                                          window=w)
        assert torch.equal(k0, T(ck))  # the caches passed in stay
        for a, b in zip(got[1:], want[1:]):
            assert _rel_err(a, b) <= F32_RTOL
        want, got = want[0], got[0]
    elif entry == "cross_decode":
        want = jattn.cross_attention_decode(cross, J(x1), J(ck), J(cv), cfg)
        got = tattn.cross_attention_decode(pt["cross"], T(x1), T(ck), T(cv),
                                           cfg)
    elif entry == "rope_kv_for_cache":
        want = jnp.stack(jattn.apply_rope_kv_for_cache(attn, J(x), cfg,
                                                       J(pos)))
        got = torch.stack(tattn.apply_rope_kv_for_cache(pt["attn"], T(x),
                                                        cfg, T(pos)))
    else:
        want, got = jlayers.mlp(mlp_p, J(x)), tlayers.mlp(pt["mlp"], T(x))
    assert got.shape == want.shape
    assert _rel_err(got, want) <= F32_RTOL


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype", [
    ("olmoe_1b_7b", "float32"), ("qwen3_0_6b", "float32"),
    ("olmo_1b", "float32"), ("gemma3_1b", "float32"),
    ("gemma3_1b", "bfloat16"),
])
def test_forward_prefill_decode_match_reference(arch, dtype):
    cfg = get_config(arch).reduced(dtype=dtype)
    params, _, tp = _weights(cfg)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    rng = np.random.default_rng(11)
    B, S = 2, 16
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    with torch.inference_mode():
        lt, auxt = tmodel.forward(tp, {"tokens": _t(toks)}, cfg, kv_chunk=8)
        pt, ct = tmodel.prefill(tp, {"tokens": _t(toks)}, cfg, kv_chunk=8,
                                extra_cache=4)
    lj, auxj = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                              kv_chunk=8)
    pj, cj = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, cfg,
                            kv_chunk=8, extra_cache=4)
    assert lt.shape == (B, S, cfg.padded_vocab)
    assert pt.shape == (B, 1, cfg.padded_vocab)
    assert _rel_err(lt, lj) <= tol and _rel_err(pt, pj) <= tol
    assert abs(float(auxt) - float(auxj)) <= 1e-5 + tol * abs(float(auxj))
    assert ct["k"].dtype == tmodel.kv_cache_dtype(cfg)
    assert ct["k"].shape == cj["k"].shape and int(ct["pos"]) == S
    assert _rel_err(ct["k"], cj["k"]) <= tol
    for _ in range(4):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        with torch.inference_mode():
            before = ct["k"].clone()
            lt, ct2 = tmodel.decode_step(tp, ct, _t(nt), cfg)
            assert torch.equal(ct["k"], before)  # the step copies the cache
            ct = ct2
        lj, cj = jmodel.decode_step(params, cj, jnp.asarray(nt), cfg)
        assert _rel_err(lt, lj) <= tol
        assert int(ct["pos"]) == int(cj["pos"])
    assert _rel_err(ct["v"], cj["v"]) <= tol


def test_decode_matches_forward_when_nothing_is_dropped():
    """decode_step after prefill(extra_cache=1) is forward's last
    position (capacity_factor = E/K: no token dropped on either path)."""
    cfg = get_config("olmoe_1b_7b").reduced(dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tp = tmodel.init_model(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 13)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tmodel.forward(tp, {"tokens": toks}, cfg, kv_chunk=4)
        _, cache = tmodel.prefill(tp, {"tokens": toks[:, :-1]}, cfg,
                                  kv_chunk=4, extra_cache=1)
        step, _ = tmodel.decode_step(tp, cache, toks[:, -1:], cfg)
    assert _rel_err(step[:, 0], full[:, -1].numpy()) <= F32_RTOL


def test_ring_write_and_block_inits_match_reference():
    rng = np.random.default_rng(12)
    cache = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    new = rng.normal(size=(2, 1, 3, 4)).astype(np.float32)
    for pos in (3, 7):  # 7 wraps to slot 2
        want = jmodel._ring_write(jnp.asarray(cache), jnp.asarray(new),
                                  jnp.int32(pos))
        got = tmodel._ring_write(_t(cache), _t(new), torch.tensor(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cfg = get_config("olmo_1b").reduced()
    gen = torch.Generator().manual_seed(0)
    for name in ("init_cross_block", "init_enc_block", "init_block"):
        ref = jax.eval_shape(lambda: getattr(jmodel, name)(
            jax.random.key(0), cfg))
        want = {jax.tree_util.keystr(k): v.shape for k, v in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
        got = {jax.tree_util.keystr(k): v.shape for k, v in
               jax.tree_util.tree_flatten_with_path(tmodel._tree(
                   getattr(tmodel, name)(gen, cfg)))[0]}
        assert got == want, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_to_the_reference_pytree(dtype):
    cfg = get_config("gemma3_1b").reduced(dtype=dtype)
    _, tree, tp = _weights(cfg, seed=1)
    assert isinstance(tp["layers"], torch.nn.ModuleList)
    assert len(tp["layers"]) == cfg.n_layers
    assert tp["layers"][0]["attn"]["q_in"].dtype == getattr(torch, dtype)
    back = tmodel.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_init_model_is_seeded_and_has_the_reference_structure():
    cfg = get_config("olmoe_1b_7b").reduced()
    a = tmodel.init_model(cfg, seed=3, device="cpu")
    b = tmodel.init_model(cfg, seed=3, device="cpu")
    c = tmodel.init_model(cfg, seed=4, device="cpu")
    ref = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0), cfg))
    want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype)) for k, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {jax.tree_util.keystr(k): (v.shape, str(v.dtype)) for k, v in
           jax.tree_util.tree_flatten_with_path(tmodel.params_to_numpy(a))[0]}
    assert set(got) == set(want)
    for k, (shape, _) in want.items():
        assert got[k][0] == shape, k
    assert a["layers"][0]["moe"]["router"].dtype == torch.float32
    assert a["layers"][0]["moe"]["gate_ein"].dtype == torch.bfloat16
    sa, sb, sc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.embedding"], sc["embed.embedding"])


@pytest.mark.parametrize("arch", ["seamless_m4t_medium",
                                  "llama_3_2_vision_11b"])
def test_encdec_and_vlm_build_with_the_reference_keys(arch):
    """The last two families are ported: ``init_model`` and
    ``init_cache`` build them with the reference's keys and shapes
    (``tests/test_torch_encdec_vlm.py`` holds them against it)."""
    cfg = get_config(arch).reduced()
    p = tmodel.init_model(cfg, device="cpu")
    ref = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0), cfg))
    assert sorted(p.keys()) == sorted(ref)
    got = {jax.tree_util.keystr(k): v.shape for k, v in
           jax.tree_util.tree_flatten_with_path(tmodel.params_to_numpy(p))[0]}
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert got == want
    cache = tmodel.init_cache(cfg, batch=1, seq_len=4, device="cpu")
    jcache = jax.eval_shape(lambda: jmodel.init_cache(cfg, batch=1,
                                                      seq_len=4))
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}


def test_host_mesh_helpers_match_reference():
    jm, tm = jmesh.make_host_mesh(), tmesh.make_host_mesh(device="cpu")
    assert tuple(tm.axis_names) == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    for fn in ("batch_axes", "tp_size", "dp_size"):
        assert getattr(tmesh, fn)(tm) == getattr(jmesh, fn)(jm)
    assert tmesh.dp_size(tmesh.make_host_mesh(data=4, device="cpu")) == 4


def test_runtime_flags_mirror_the_reference():
    for name in ("MOE_GROUPS", "MOE_MESH"):
        assert getattr(tflags, name) == getattr(jflags, name)
    mesh = tmesh.make_host_mesh(data=2, device="cpu")
    try:
        tflags.set_moe_groups(2)
        tflags.set_moe_mesh(mesh, ["data"])
        assert tflags.moe_groups() == 2
        assert tflags.moe_mesh() == (mesh, ("data",))
    finally:
        tflags.set_moe_groups(1)
        tflags.set_moe_mesh(None)
    assert (tflags.moe_groups(), tflags.moe_mesh()) == (1, None)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _lines(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _shape(line: str) -> str:
    """A printed line with its numbers blanked."""
    return re.sub(r"\d+(\.\d+)?", "#", line)


def test_serve_main_prints_the_reference_lines():
    argv = ["--arch", "olmoe_1b_7b", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "3", "--requests", "4"]
    got = _lines(tserve.main, argv + ["--device", "cpu"])
    want = _lines(jserve.main, argv)
    # the reference also pins XLA's flags in its tuned environment
    drop = re.compile(r"\[serve\] tuned runtime env")
    assert [_shape(x) for x in got if not drop.match(x)] == \
        [_shape(x) for x in want if not drop.match(x)]
    assert re.fullmatch(r"\[serve\] 12 tokens in [\d.]+s \([\d.]+ tok/s incl\. "
                        r"prefill\)", got[-1])
    for line in got:
        m = re.search(r"sample row0: \[(.*)\]", line)
        if m:
            toks = [int(t) for t in m.group(1).split(",")]
            assert len(toks) == 3 and all(0 <= t < 512 for t in toks)


def test_serve_main_with_a_plan_cache_dir(tmp_path):
    argv = ["--arch", "qwen3_0_6b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "2", "--requests", "2",
            "--device", "cpu", "--plan-cache-dir", str(tmp_path)]
    cold = _lines(tserve.main, argv)
    warm = _lines(tserve.main, argv)
    assert any("(cold)" in x for x in cold)
    assert any("(warm restart)" in x for x in warm)
    assert "plan service stats" in warm[-1]
