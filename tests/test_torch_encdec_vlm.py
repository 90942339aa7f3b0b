"""The port's ``encdec`` (Seamless-M4T-medium) and ``vlm``
(Llama-3.2-Vision-11B) families against the JAX package, on the CPU, at
reduced sizes: ``forward``, ``prefill``, ``decode_step`` and every cache,
``init_cache``, the parameters carried across, the stub batches and the
serving launcher.

The same weights (the reference's init, carried across with
``params_from_numpy``), the same seeded tokens and the same embeddings
go through both.  Tolerances, relative to the largest magnitude of the
reference's output: ``F32_RTOL = 1e-5`` in float32 (measured about
1e-6) and ``BF16_RTOL = 4e-2`` in bfloat16 (measured about 1e-2), as in
``test_torch_models``.

The source is 9 positions against 12 tokens, so ``ck``/``cv`` (the
source's length) cannot pass for ``k``/``v`` (the tokens'); ``kv_chunk
= 8`` leaves a ragged last chunk of the source and of the 13 vision
tokens; the vlm has 4 or 6 layers with a cross block after every
second (2 or 3 cross blocks).

The reference's ``decode_step`` applies a layer's cross-attention before
its MLP, where its ``forward`` and ``prefill`` apply it after: its decode
departs from its own forward (ROADMAP queue C, C5).  The port's decode
follows the forward, and is held against a decode composed of the
reference's own attention and layer functions in the forward's order.
"""
import contextlib
import dataclasses
import functools
import io
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_ENV = dict(os.environ)  # the serving launchers tune it at import
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its phase 4l/4m helpers, run here)

os.environ.clear()
os.environ.update(_ENV)
torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2
ARCHS = ("seamless_m4t_medium", "llama_3_2_vision_11b")
B, S, S_SRC, V_TOK = 2, 12, 9, 13


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfg(arch, dtype="float32", **kw):
    if arch == "llama_3_2_vision_11b":
        kw = {"n_layers": 4, "n_vision_tokens": V_TOK, **kw}
    return get_config(arch).reduced(dtype=dtype, **kw)


def _weights(cfg, seed=0):
    params = jmodel.init_model(jax.random.key(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    return params, tree, tmodel.params_from_numpy(tree, cfg, device="cpu")


def _batches(cfg, tokens, rng, src_len=S_SRC):
    """The same batch for both: tokens and the family's embeddings, drawn
    as the launchers draw them (float64, cast to the model's dtype)."""
    bj = {"tokens": jnp.asarray(tokens)}
    bt = {"tokens": torch.from_numpy(tokens)}
    key, shape = {"encdec": ("src_embeds", (tokens.shape[0], src_len)),
                  "vlm": ("vision_embeds", (tokens.shape[0],
                                            cfg.n_vision_tokens))
                  }[cfg.family]
    draw = rng.normal(size=(*shape, cfg.d_model))
    bj[key] = jnp.asarray(draw, jnp.dtype(cfg.dtype))
    bt[key] = torch.from_numpy(draw).to(getattr(torch, cfg.dtype))
    return bj, bt


def _check_cache(ct, cj, tol):
    assert set(ct) == set(cj)
    assert int(ct["pos"]) == int(cj["pos"])
    for k in ct:
        if k == "pos":
            continue
        assert tuple(ct[k].shape) == cj[k].shape, k
        assert str(ct[k].dtype).split(".")[-1] == str(cj[k].dtype), k
        assert _rel_err(ct[k], cj[k]) <= tol, k


@functools.partial(jax.jit, static_argnames=("cfg",))
def _ref_decode_in_forward_order(params, cache, tokens, cfg):
    """The reference's ``decode_step`` for ``encdec`` and ``vlm`` with a
    layer's cross-attention after its MLP, as its ``forward`` and
    ``prefill`` apply it, composed of the reference's own functions."""
    pos = cache["pos"]
    x = jlayers.embed(params["embed"], tokens)
    ks, vs = [], []
    every = cfg.cross_attn_every if cfg.family == "vlm" else 0
    for idx in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[idx], params["layers"])
        hn = jmodel._apply_norm(cfg, lp.get("norm1"), x)
        a, k2, v2 = jattn.self_attention_decode(
            lp["attn"], hn, cache["k"][idx], cache["v"][idx], cfg,
            position=pos)
        x = x + a
        x = x + jlayers.mlp(lp["mlp"],
                            jmodel._apply_norm(cfg, lp.get("norm2"), x))
        ci = idx if cfg.family == "encdec" else (
            (idx + 1) // every - 1 if (idx + 1) % every == 0 else None)
        if ci is not None:
            cp = jax.tree.map(lambda a: a[ci], params[
                "dec_cross" if cfg.family == "encdec" else "cross"])
            x = x + jattn.cross_attention_decode(
                cp["attn"], jmodel._apply_norm(cfg, cp.get("norm"), x),
                cache["ck"][ci], cache["cv"][ci], cfg)
        ks.append(k2)
        vs.append(v2)
    x = jmodel._apply_norm(cfg, params.get("final_norm"), x)
    logits = jlayers.unembed(params["embed"], x)
    return logits, dict(cache, k=jnp.stack(ks), v=jnp.stack(vs),
                        pos=pos + 1)


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------
CASES = [
    ("seamless_m4t_medium", "float32", {}, 4),
    ("seamless_m4t_medium", "float32", {}, 0),
    ("seamless_m4t_medium", "bfloat16", {}, 4),
    ("llama_3_2_vision_11b", "float32", {}, 4),
    ("llama_3_2_vision_11b", "float32", {}, 0),
    ("llama_3_2_vision_11b", "bfloat16", {}, 4),
    ("llama_3_2_vision_11b", "float32", {"n_layers": 6}, 4),
]


@pytest.mark.parametrize(
    "arch,dtype,kw,extra_cache", CASES,
    ids=[f"{a}-{d}" + ("-L6" if kw else "") + f"-extra{e}"
         for a, d, kw, e in CASES])
def test_forward_prefill_decode_match_reference(arch, dtype, kw,
                                                extra_cache):
    cfg = _cfg(arch, dtype, **kw)
    params, _, tp = _weights(cfg)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    bj, bt = _batches(cfg, toks, rng)
    with torch.inference_mode():
        lt, auxt = tmodel.forward(tp, bt, cfg, kv_chunk=8)
        pt, ct = tmodel.prefill(tp, bt, cfg, kv_chunk=8,
                                extra_cache=extra_cache)
    lj, auxj = jmodel.forward(params, bj, cfg, kv_chunk=8)
    pj, cj = jmodel.prefill(params, bj, cfg, kv_chunk=8,
                            extra_cache=extra_cache)
    assert lt.shape == (B, S, cfg.padded_vocab)
    assert pt.shape == (B, 1, cfg.padded_vocab)
    assert _rel_err(lt, lj) <= tol and _rel_err(pt, pj) <= tol
    assert float(auxt) == float(auxj) == 0.0
    _check_cache(ct, cj, tol)
    src = S_SRC if cfg.family == "encdec" else cfg.n_vision_tokens
    assert ct["ck"].shape[2] == src and ct["k"].shape[2] == S + extra_cache
    for _ in range(4):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        with torch.inference_mode():
            before = {k: v.clone() for k, v in ct.items()}
            lt, ct2 = tmodel.decode_step(tp, ct, torch.from_numpy(nt), cfg)
            # the step leaves the caches it was given as they were, and
            # passes the cross K/V through without a copy
            assert all(torch.equal(ct[k], before[k]) for k in ct)
            assert ct2["ck"] is ct["ck"] and ct2["cv"] is ct["cv"]
            ct = ct2
        lj, cj = _ref_decode_in_forward_order(params, cj, jnp.asarray(nt),
                                              cfg)
        assert _rel_err(lt, lj) <= tol
        _check_cache(ct, cj, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_decode_departs_from_its_forward(arch):
    """Queue C, C5: after ``prefill(tokens[:, :-1], extra_cache=1)`` the
    reference's ``decode_step`` is far from its own ``forward``'s last
    position (its cross-attention runs before the layer's MLP); the
    port's decode and the forward-order reference decode are not."""
    cfg = _cfg(arch)
    params, _, tp = _weights(cfg, seed=2)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    bj, bt = _batches(cfg, toks, rng)
    head_j = dict(bj, tokens=bj["tokens"][:, :S])
    want = jmodel.forward(params, bj, cfg, kv_chunk=8)[0][:, -1]
    _, cj = jmodel.prefill(params, head_j, cfg, kv_chunk=8, extra_cache=1)
    nt = bj["tokens"][:, S:]
    ref_decode = jmodel.decode_step(params, cj, nt, cfg)[0][:, 0]
    fixed = _ref_decode_in_forward_order(params, cj, nt, cfg)[0][:, 0]
    with torch.inference_mode():
        _, ct = tmodel.prefill(tp, dict(bt, tokens=bt["tokens"][:, :S]),
                               cfg, kv_chunk=8, extra_cache=1)
        port = tmodel.decode_step(tp, ct, bt["tokens"][:, S:], cfg)[0][:, 0]
    assert _rel_err(ref_decode, want) > 0.1
    assert _rel_err(fixed, want) <= F32_RTOL
    assert _rel_err(port, want) <= F32_RTOL


@pytest.mark.parametrize("arch,kw", [("seamless_m4t_medium", {}),
                                     ("llama_3_2_vision_11b", {}),
                                     ("llama_3_2_vision_11b",
                                      {"n_layers": 1,
                                       "cross_attn_every": 1})],
                         ids=["seamless", "llama-L4", "llama-L1"])
def test_decode_matches_forward_after_prefill_extra_cache_1(arch, kw):
    """decode_step after prefill(extra_cache=1) is forward's last
    position, through phase 4l's check (``chip_smoke.cross_decode_errs``,
    with ``chip_smoke.cross_batch``'s draws); its planted faults (the
    cross K/V zeroed, each cross block reading the next one's, an
    encoder run causal) read far above the limit.  The one-layer vlm
    is 4l's float32 copy: one cross block, so no block to confuse."""
    cfg = _cfg(arch, **kw)
    tp = tmodel.init_model(cfg, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)).astype(
        np.int32))
    errs = chip_smoke.cross_decode_errs(
        tp, cfg, chip_smoke.cross_batch(cfg, toks, rng, S_SRC))
    faults = {"seamless_m4t_medium": {"encoder_causal"},
              "llama_3_2_vision_11b": {"other_cross_block"}
              if cfg.n_layers >= 4 else set()}[arch]
    assert set(errs) == {"sound", "cross_zeroed"} | faults
    assert errs["sound"]["rel_err"] <= F32_RTOL
    assert errs["sound"]["argmax_equal"]
    bad = {k: v["rel_err"] for k, v in errs.items() if k != "sound"}
    assert min(bad.values()) > 1000 * F32_RTOL, bad


def test_cross_blocks_follow_every_fifth_layer_at_full_depth():
    """At full depth Llama-3.2-Vision's cross blocks follow layers 4, 9,
    ..., 39: 8 of them, indexed in order."""
    cfg = get_config("llama_3_2_vision_11b")
    fired = [(i, tmodel._cross_index(cfg, i)) for i in range(cfg.n_layers)
             if tmodel._cross_index(cfg, i) is not None]
    assert fired == [(i, j) for j, i in enumerate(range(4, 40, 5))]
    assert tmodel._n_cross(cfg) == 8
    # Seamless: every decoder layer its own; a dense model none
    assert [tmodel._cross_index(get_config("seamless_m4t_medium"), i)
            for i in range(12)] == list(range(12))
    assert tmodel._cross_index(get_config("olmo_1b"), 4) is None


# ---------------------------------------------------------------------------
# caches and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_init_cache_shapes_and_dtypes_match_reference(arch, dtype, full):
    cfg = dataclasses.replace(get_config(arch), dtype=dtype) if full \
        else _cfg(arch, dtype)
    want = jax.eval_shape(lambda: jmodel.init_cache(cfg, batch=3,
                                                    seq_len=7))
    # the full caches on the meta device: shapes and dtypes only
    got = tmodel.init_cache(cfg, batch=3, seq_len=7,
                            device="meta" if full else "cpu")
    assert set(got) == set(want) == {"pos", "k", "v", "ck", "cv"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert full or not bool(got[k].any()), k
    if full and arch == "llama_3_2_vision_11b":
        assert want["ck"].shape == (8, 3, 1601, 8, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", [("seamless_m4t_medium", {}),
                                     ("seamless_m4t_medium",
                                      {"n_enc_layers": 3}),
                                     ("llama_3_2_vision_11b", {}),
                                     ("llama_3_2_vision_11b",
                                      {"n_layers": 6})])
def test_params_round_trip_to_the_reference_pytree(arch, kw, dtype):
    """Each stacked subtree's block count is read off its arrays: 3
    encoder against 2 decoder layers, 2 or 3 cross blocks."""
    cfg = _cfg(arch, dtype, **kw)
    _, tree, tp = _weights(cfg, seed=1)
    counts = {k: len(tp[k]) for k in tmodel._STACKED if k in tp}
    if cfg.family == "encdec":
        assert counts == {"layers": cfg.n_layers, "dec_cross": cfg.n_layers,
                          "enc_layers": cfg.n_enc_layers}
        assert "enc_final_norm" in tp
    else:
        assert counts == {"layers": cfg.n_layers,
                          "cross": cfg.n_layers // cfg.cross_attn_every}
    cross = tp["dec_cross" if cfg.family == "encdec" else "cross"][0]
    assert set(cross.keys()) == {"norm", "attn"}
    assert cross["attn"]["q_in"].dtype == getattr(torch, dtype)
    back = tmodel.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def _layout(tree) -> dict:
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kw", [{}, {"n_layers": 6}])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_is_seeded_and_has_the_reference_structure(arch, kw):
    cfg = _cfg(arch, "bfloat16", **kw)
    a = tmodel.init_model(cfg, seed=3, device="cpu")
    b = tmodel.init_model(cfg, seed=3, device="cpu")
    c = tmodel.init_model(cfg, seed=4, device="cpu")
    ref = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0), cfg))
    got = {k: (shape, "bfloat16" if dt == "float32" else dt)
           for k, (shape, dt) in _layout(tmodel.params_to_numpy(a)).items()}
    assert got == _layout(ref)
    sa, sb, sc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.embedding"], sc["embed.embedding"])
    stack = "dec_cross" if cfg.family == "encdec" else "cross"
    assert not torch.equal(sa[f"{stack}.0.attn.q_in"],
                           sa[f"{stack}.1.attn.q_in"])
    assert "attn.q_norm" not in "".join(k for k in sa if k.startswith(stack))


@pytest.mark.parametrize("arch,layers", [("seamless_m4t_medium", None),
                                         ("llama_3_2_vision_11b", None),
                                         ("llama_3_2_vision_11b", 10),
                                         ("llama_3_2_vision_11b", 5)])
def test_chip_smokes_parameter_counts_are_the_references(arch, layers):
    """The full-width counts phases 4l and 4m hold the card's models to:
    the reference's init under ``jax.eval_shape``."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ref = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0), cfg))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(ref))
    assert chip_smoke.CROSS_PARAMS[(arch, cfg.n_layers)] == n


def test_chip_smokes_decode_bytes_and_flops():
    """Phase 4l's decode byte count on a reduced Seamless, counted here
    by hand (the encoder and the cross blocks' K/V projections are not
    read), and the FLOP reckonings of 4l's prefill and 4m's step at
    full width against the hand counts of the bounds they report."""
    cfg = _cfg("seamless_m4t_medium", "bfloat16")
    tp = tmodel.init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.zeros((2, 9), dtype=torch.int32)
    with torch.inference_mode():
        _, cache = tmodel.prefill(
            tp, chip_smoke.cross_batch(cfg, toks, rng, 5), cfg, kv_chunk=9)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    weights = nbytes(tp.parameters()) - nbytes(tp["enc_layers"].parameters())
    weights -= nbytes(tp["enc_final_norm"].parameters())
    weights -= nbytes([b["attn"][w] for b in tp["dec_cross"]
                       for w in ("k_in", "v_in")])
    caches = nbytes([cache[k] for k in ("k", "v", "ck", "cv")])
    assert cache["ck"].shape[2] == 5
    assert chip_smoke.cross_decode_bytes(tp, cache, cfg) == weights + caches
    # Llama-3.2-Vision at 4 x 512: 40 layers of 218.1M parameters and 8
    # cross blocks' Q/O a token, their K/V over 4 x 1,601 vision tokens
    fl = chip_smoke.cross_flops(get_config("llama_3_2_vision_11b"), 4, 512,
                                512, 512)
    D, F_, qo, kv = 4096, 14336, 2 * 4096 * 4096, 2 * 4096 * 1024
    assert fl["blocks_bf16_flop"] == 2048 * 2 * (40 * (qo + kv + 3 * D * F_)
                                                 + 8 * qo) \
        + 4 * 1601 * 8 * 2 * kv
    # the products over 512 keys a layer and 2,048 (1,601 padded) a block
    assert fl["attention_f32_flop"] == 4 * 32 * 128 * 4 * 512 * (
        40 * 512 + 8 * 2048)
    # Seamless's step: 4 x the blocks (remat) + 3 x the head, 21.3 TFLOP
    fs = chip_smoke.cross_flops(get_config("seamless_m4t_medium"), 8, 512,
                                512, 512)
    step = 4 * fs["blocks_bf16_flop"] + 3 * fs["head_bf16_flop"]
    assert 21.2e12 < step < 21.4e12


# ---------------------------------------------------------------------------
# the stub batches and the launcher
# ---------------------------------------------------------------------------
def test_stub_draws_round_as_the_reference_casts():
    """The stub embeddings' float64 draws rounded to bf16 on the host
    hold the bits ``jnp.asarray(draw, bfloat16)`` gives, on a million
    normal draws and on values just above and at a tie between two bf16
    neighbours (where rounding through float32 and directly differ)."""
    rng = np.random.default_rng(0)
    draws = rng.normal(size=1_000_000)
    # bf16 values (8 significant bits) and half their spacing
    k = np.arange(512)
    base = (128 + k % 128) / 128.0 * np.exp2(k % 7 - 3)
    half = np.exp2(k % 7 - 3 - 8)
    ties = np.concatenate([base + half * (1 + s)
                           for s in (0.0, 2.0**-30, -2.0**-30)])
    for x in (draws, ties, -ties):
        want = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
        spec = {"src_embeds": tspecs.sds(x.shape, "bfloat16")}
        got = tspecs.stub_embeddings(
            spec, _FixedDraw(x), "cpu")["src_embeds"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


class _FixedDraw:
    """An ``rng`` whose ``normal`` returns the given values."""

    def __init__(self, x):
        self.x = x

    def normal(self, size):
        assert tuple(size) == self.x.shape
        return self.x


def _lines(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def _shape(line: str) -> str:
    """A printed line with its numbers blanked."""
    return re.sub(r"\d+(\.\d+)?", "#", line)


ARGV = ["--reduced", "--batch", "2", "--prompt-len", "20", "--gen", "3",
        "--requests", "4", "--seed", "3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_prints_the_reference_lines(arch):
    got = _lines(tserve.main, ["--arch", arch, *ARGV, "--device", "cpu"])
    want = _lines(jserve.main, ["--arch", arch, *ARGV])
    drop = re.compile(r"\[serve\] tuned runtime env")
    assert [_shape(x) for x in got if not drop.match(x)] == \
        [_shape(x) for x in want if not drop.match(x)]
    for line in got:
        m = re.search(r"sample row0: \[(.*)\]", line)
        if m:
            toks = [int(t) for t in m.group(1).split(",")]
            assert len(toks) == 3 and all(0 <= t < 512 for t in toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_feeds_the_reference_batches(arch, monkeypatch):
    """Every prefill batch of ``serve.main`` (the tokens, then the stub
    embeddings from the same ``rng``) holds the reference's bits."""
    seen = {"port": [], "ref": []}

    def host(v):
        if isinstance(v, torch.Tensor):
            return v.float().numpy() if v.is_floating_point() else v.numpy()
        v = np.asarray(v)
        return v.astype(np.float32) if v.dtype.name == "bfloat16" else v

    def recorder(side, fn):
        def run(params, batch, cfg, **kw):
            seen[side].append({k: host(v) for k, v in batch.items()})
            return fn(params, batch, cfg, **kw)
        return run

    monkeypatch.setattr(tserve, "prefill", recorder("port", tserve.prefill))
    monkeypatch.setattr(jserve, "prefill", recorder("ref", jserve.prefill))
    _lines(tserve.main, ["--arch", arch, *ARGV, "--device", "cpu"])
    _lines(jserve.main, ["--arch", arch, *ARGV])
    assert len(seen["port"]) == len(seen["ref"]) == 2
    key = "src_embeds" if arch == "seamless_m4t_medium" else "vision_embeds"
    for got, want in zip(seen["port"], seen["ref"]):
        assert set(got) == set(want) == {"tokens", key}
        assert got[key].shape == want[key].shape
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got[key], want[key])
