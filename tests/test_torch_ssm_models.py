"""The port's ``ssm`` (Mamba2-780M) and ``hybrid`` (Zamba2-7B) families
against the JAX package, on the CPU, at reduced sizes: ``forward``,
``prefill``, ``decode_step`` and every cache, ``init_cache``, the
parameters carried across, and the serving launcher.

The same weights (the reference's init, carried across with
``params_from_numpy``) and the same seeded tokens go through both.
Tolerances, relative to the largest magnitude of the reference's output:
``F32_RTOL = 1e-5`` in float32 (measured about 2e-6) and ``BF16_RTOL =
4e-2`` in bfloat16 (measured up to about 3e-2 on the float32 SSM state
of the hybrid: its inputs are bf16 projections that round in another
order), as in ``test_torch_models``.

The reduced configs have a chunk of 16, so ``S = 21`` pads the last
chunk; the reduced hybrid fires its shared block after every second
Mamba block, and a 5-layer cut applies it twice (two K/V caches) with a
last layer that does not fire.
"""
import contextlib
import dataclasses
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
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its phase 4j/4k checks, run here)

os.environ.clear()
os.environ.update(_ENV)
torch.set_num_threads(1)

F32_RTOL = 1e-5
BF16_RTOL = 4e-2
#: the state a prefill leaves against S decode steps from a zero cache,
#: float32 (the chunked scan and the recurrence add in other orders)
STEPWISE_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfg(arch, dtype="float32", groups=1, **kw):
    cfg = get_config(arch).reduced(dtype=dtype, **kw)
    if groups != 1:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=groups))
    return cfg


def _weights(cfg, seed=0):
    params = jmodel.init_model(jax.random.key(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    return params, tree, tmodel.params_from_numpy(tree, cfg, device="cpu")


def _check_cache(ct, cj, tol):
    assert set(ct) == set(cj)
    assert int(ct["pos"]) == int(cj["pos"])
    for k in ct:
        if k == "pos":
            continue
        assert tuple(ct[k].shape) == cj[k].shape, k
        assert str(ct[k].dtype).split(".")[-1] == str(cj[k].dtype), k
        assert _rel_err(ct[k], cj[k]) <= tol, k


# ---------------------------------------------------------------------------
# forward, prefill, decode against the reference
# ---------------------------------------------------------------------------
CASES = [
    ("mamba2_780m", "float32", 1, {}, 4),
    ("mamba2_780m", "float32", 1, {}, 0),
    ("mamba2_780m", "bfloat16", 1, {}, 4),
    ("mamba2_780m", "float32", 2, {}, 4),
    ("zamba2_7b", "float32", 1, {}, 4),
    ("zamba2_7b", "bfloat16", 1, {}, 4),
    ("zamba2_7b", "float32", 2, {}, 4),
    ("zamba2_7b", "float32", 1, {"n_layers": 5}, 4),
    ("zamba2_7b", "float32", 1, {"n_layers": 5}, 0),
]


@pytest.mark.parametrize(
    "arch,dtype,groups,kw,extra_cache", CASES,
    ids=[f"{a}-{d}-g{g}" + ("-L5" if kw else "") + f"-extra{e}"
         for a, d, g, kw, e in CASES])
def test_forward_prefill_decode_match_reference(arch, dtype, groups, kw,
                                                extra_cache):
    cfg = _cfg(arch, dtype, groups, **kw)
    params, _, tp = _weights(cfg)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    rng = np.random.default_rng(11)
    B, S = 2, 21
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    with torch.inference_mode():
        lt, auxt = tmodel.forward(tp, {"tokens": _t(toks)}, cfg, kv_chunk=8)
        pt, ct = tmodel.prefill(tp, {"tokens": _t(toks)}, cfg, kv_chunk=8,
                                extra_cache=extra_cache)
    lj, auxj = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                              kv_chunk=8)
    pj, cj = jmodel.prefill(params, {"tokens": jnp.asarray(toks)}, cfg,
                            kv_chunk=8, extra_cache=extra_cache)
    assert lt.shape == (B, S, cfg.padded_vocab)
    assert pt.shape == (B, 1, cfg.padded_vocab)
    assert _rel_err(lt, lj) <= tol and _rel_err(pt, pj) <= tol
    assert float(auxt) == float(auxj) == 0.0
    _check_cache(ct, cj, tol)
    for _ in range(4):
        nt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        with torch.inference_mode():
            before = {k: v.clone() for k, v in ct.items()}
            lt, ct2 = tmodel.decode_step(tp, ct, _t(nt), cfg)
            # the step leaves the caches it was given as they were
            assert all(torch.equal(ct[k], before[k]) for k in ct)
            ct = ct2
        lj, cj = jmodel.decode_step(params, cj, jnp.asarray(nt), cfg)
        assert _rel_err(lt, lj) <= tol
        _check_cache(ct, cj, tol)


@pytest.mark.parametrize("arch,kw", [("mamba2_780m", {}),
                                     ("zamba2_7b", {"n_layers": 5})])
@pytest.mark.parametrize("S", [21, 16])
def test_decode_matches_forward_after_prefill_extra_cache_1(arch, kw, S):
    """decode_step after prefill(extra_cache=1) is forward's last
    position (nothing evicted from the shared block's ring buffers),
    through phase 4j's check (``chip_smoke.ssm_decode_errs``); its
    planted faults (a restarted state, a stale conv window, a shared
    attention step one position on) read far above the limit."""
    cfg = _cfg(arch, **kw)
    tp = tmodel.init_model(cfg, seed=5, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, S + 1)).astype(np.int32))
    errs = chip_smoke.ssm_decode_errs(tp, cfg, toks)
    assert set(errs) == {"sound", "state_zeroed", "conv_stale"} | (
        {"pos_plus_1"} if arch == "zamba2_7b" else set())
    assert errs["sound"]["rel_err"] <= F32_RTOL
    assert errs["sound"]["argmax_equal"]
    faults = {k: v["rel_err"] for k, v in errs.items() if k != "sound"}
    assert min(faults.values()) > 100 * F32_RTOL, faults


@pytest.mark.parametrize("arch,kw", [("mamba2_780m", {"n_layers": 1}),
                                     ("zamba2_7b", {"n_layers": 4})])
def test_prefill_state_equals_stepwise_decode(arch, kw):
    """The reference's ``test_ssm_prefill_state_equals_stepwise`` on the
    port: S = 20 tokens cross a chunk edge and pad the last chunk; S
    decode steps from a zero cache reach the state and the conv window
    that prefill builds.  In the hybrid, decode attends over the whole
    ring buffer, its unwritten zero slots included (the reference's
    contract, ``decode_attention``), so only the layers up to the first
    shared application and that application's K/V are held."""
    cfg = _cfg(arch, **kw)
    B, S = 2, 20
    tp = tmodel.init_model(cfg, seed=4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.inference_mode():
        _, cache = tmodel.prefill(tp, {"tokens": toks}, cfg, kv_chunk=8)
        c = tmodel.init_cache(cfg, batch=B, seq_len=S, device="cpu")
        for t in range(S):
            _, c = tmodel.decode_step(tp, c, toks[:, t:t + 1], cfg)
    assert int(c["pos"]) == int(cache["pos"]) == S
    if arch == "mamba2_780m":  # phase 4j's check is the same
        errs = chip_smoke.ssm_stepwise_errs(tp, cfg, toks)
        assert max(errs.values()) <= STEPWISE_RTOL, errs
    n = cfg.hybrid_attn_every or cfg.n_layers
    for k in ("state", "conv", "k", "v"):
        if k in cache:
            got, want = (c[k][:n], cache[k][:n]) if k in ("state", "conv") \
                else (c[k][0], cache[k][0])
            assert _rel_err(got, want) <= STEPWISE_RTOL, k


# ---------------------------------------------------------------------------
# caches and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_init_cache_shapes_and_dtypes_match_reference(arch, dtype, full):
    cfg = dataclasses.replace(get_config(arch), dtype=dtype) if full \
        else _cfg(arch, dtype)
    B, S = 3, 7
    want = jax.eval_shape(lambda: jmodel.init_cache(cfg, batch=B,
                                                    seq_len=S))
    # the full caches on the meta device: shapes and dtypes only
    got = tmodel.init_cache(cfg, batch=B, seq_len=S,
                            device="meta" if full else "cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert full or not bool(got[k].any()), k
    if full and arch == "zamba2_7b":
        # 81 layers, the shared block after every sixth: 13 applications
        assert want["k"].shape[0] == 13
        assert [i for i in range(cfg.n_layers) if tmodel._fires(cfg, i)] == \
            list(range(5, 81, 6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_params_round_trip_to_the_reference_pytree(arch, dtype):
    cfg = _cfg(arch, dtype)
    _, tree, tp = _weights(cfg, seed=1)
    assert len(tp["layers"]) == cfg.n_layers
    mamba = tp["layers"][0]["mamba"]
    assert mamba["in_proj_in"].dtype == getattr(torch, dtype)
    assert mamba["a_log"].dtype == torch.float32  # inside a bf16 model too
    shared = {k for k in tp.keys() if k.startswith("shared_")}
    assert shared == ({"shared_norm1", "shared_attn", "shared_norm2",
                       "shared_mlp"} if arch == "zamba2_7b" else set())
    back = tmodel.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_init_model_is_seeded_and_has_the_reference_structure(arch):
    cfg = _cfg(arch, "bfloat16")
    a = tmodel.init_model(cfg, seed=3, device="cpu")
    b = tmodel.init_model(cfg, seed=3, device="cpu")
    c = tmodel.init_model(cfg, seed=4, device="cpu")
    ref = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0), cfg))
    want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype)) for k, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert _layout(a) == want
    sa, sb, sc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.embedding"], sc["embed.embedding"])
    assert not torch.equal(sa["layers.0.mamba.in_proj_in"],
                           sa["layers.1.mamba.in_proj_in"])


def _layout(params) -> dict:
    """``{keystr: (shape, dtype)}`` of a port model in the reference's
    spelling, the blocks' leaves stacked on a leading layer axis."""
    out = {}
    for name, p in params.named_parameters():
        parts, shape = name.split("."), tuple(p.shape)
        if parts[0] == "layers":
            if parts[1] != "0":
                continue
            parts, shape = parts[:1] + parts[2:], (len(params["layers"]),
                                                   *shape)
        out["".join(f"['{x}']" for x in parts)] = (
            shape, str(p.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch,layers", [("mamba2_780m", None),
                                         ("zamba2_7b", None),
                                         ("zamba2_7b", 12)])
def test_chip_smokes_parameter_counts_are_the_references(arch, layers):
    """The full-width counts phases 4j and 4k hold the card's models to:
    the reference's init under ``jax.eval_shape``."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ref = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0), cfg))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(ref))
    assert chip_smoke.SSM_PARAMS[(arch, cfg.n_layers)] == n


def test_chip_smokes_decode_bytes_and_step_flops():
    """Phase 4j's decode byte count on a reduced hybrid, counted here by
    hand, and phase 4k's FLOP reckoning of the SSD scan at Mamba2's
    width: ``2 Q H (N + P) + 4 H N P`` = 6,291,456 a token and layer."""
    cfg = _cfg("zamba2_7b", "bfloat16", n_layers=5)
    tp = tmodel.init_model(cfg, seed=0, device="cpu")
    with torch.inference_mode():
        _, cache = tmodel.prefill(tp, {"tokens": torch.zeros(
            (2, 9), dtype=torch.int32)}, cfg, kv_chunk=9)
    nbytes = {k: sum(p.numel() * p.element_size()
                     for p in (tp[k].parameters() if k != "layers" else
                               tp["layers"].parameters()))
              for k in tp.keys()}
    shared = sum(v for k, v in nbytes.items() if k.startswith("shared_"))
    state = 2 * (cache["state"].numel() * 4 + cache["conv"].numel() * 2)
    kv = (cache["k"].numel() + cache["v"].numel()) * 2
    assert chip_smoke.ssm_decode_bytes(tp, cache, cfg) == \
        sum(nbytes.values()) + shared + state + kv  # two applications
    fl = chip_smoke.ssm_step_flops(get_config("mamba2_780m"), 4096, 512)
    assert fl["scan_flop_per_token_layer"] == 6_291_456
    assert fl["step_f32_flop"] == 4096 * 4 * 48 * 6_291_456


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


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_7b"])
def test_serve_main_prints_the_reference_lines(arch):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "20", "--gen", "3", "--requests", "4"]
    got = _lines(tserve.main, argv + ["--device", "cpu"])
    want = _lines(jserve.main, argv)
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
