"""Serving across ranks: a real ``(data, model)`` mesh of ``gloo`` ranks.

The serving half of the reference's dry run places its ``prefill`` and
``decode_step`` cells on a mesh (``repro/launch/dryrun.py``
``build_lowered``): weights in ``"serve"`` mode (TP only) where they fit,
batch rows over ``data``, caches by ``cache_specs`` (the batch over
``data``, or the sequence where the batch is 1 or the KV heads do not
split over ``model``), logits by ``logits_spec``, the MoE dispatch on
each data shard's tokens.  Here four CPU ranks, started once for the
module (:func:`repro_torch.launch.ranks.spawn_ranks`), serve one reduced
float32 config of each family on ``(data 2, model 2)`` with the
reference's weights (``params_from_numpy``): ``prefill`` and decode
steps on fixed tokens, every gathered logit and cache leaf against the
one-process port and the reference, the greedy tokens against the
argmax over the whole vocabulary, the outputs' placements against the
reference's, and the collectives of a decode step (the cache is never
gathered).  Three cases shard the cache's sequence (batch 1; one KV
head; both) and run past the ring buffer's wrap.  The same ranks serve
``PlanService(method="sharded")`` on Table 4.1's sets at small L
against the oracle and the one-process blocks, save, and restart warm.
Then the launcher under ``python -m torch.distributed.run``, twice on
one plan cache directory.
"""
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as jmodel
from repro.models import runtime_flags as jflags
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import model as tmodel
from repro_torch.models import runtime_flags as tflags

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANKS_TIMEOUT_S = 300
#: float32 on both sides: the ranks' partial sums add in other orders
#: (measured about 1e-6 of max|logit|), the two packages' matmuls round
#: differently in the last bits
F32_RTOL = 1e-5

#: (name, arch, batch, prompt, extra_cache, decode steps).  The six
#: families with the batch over "data" and the KV heads (or the SSM
#: heads and channels) over "model"; then caches whose sequence is
#: sharded: over "data" (batch 1), over "model" (gemma3's one KV head),
#: over both (batch 1 and one KV head).  Those have 16 + 4 slots and run
#: six steps: the fifth writes slot 0 again.
CASES = [
    ("dense", "olmo_1b", 4, 16, 0, 3),
    ("moe", "olmoe_1b_7b", 4, 16, 0, 3),
    ("ssm", "mamba2_780m", 4, 16, 0, 3),
    ("hybrid", "zamba2_7b", 4, 16, 0, 3),
    ("encdec", "seamless_m4t_medium", 4, 16, 0, 3),
    ("vlm", "llama_3_2_vision_11b", 4, 16, 0, 3),
    ("seq_data", "olmo_1b", 1, 16, 4, 6),
    ("seq_model", "gemma3_1b", 4, 16, 4, 6),
    ("seq_both", "gemma3_1b", 1, 16, 4, 6),
]
#: where decode is held to the reference's decode_step; the encdec and
#: vlm decode puts cross-attention after the MLP, as forward does, where
#: the reference's does not (ROADMAP queue C, C5): those are held to the
#: one-process port
REF_DECODE = {"dense", "moe", "ssm", "hybrid", "seq_data", "seq_model",
              "seq_both"}
#: the sparse sets: Table 4.1's rows per column and repeats at 200 x 200
SETS = {"1": (200, 50, 5), "2": (200, 50, 1), "3": (200, 10, 5)}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cfg(arch):
    return get_config(arch).reduced(dtype="float32")


def _inputs(name, arch, B, S, steps, seed):
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    decode = rng.integers(0, cfg.vocab, (steps, B, 1)).astype(np.int32)
    return cfg, batch, decode


_CHILD = """
    import json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import placement_mismatches
    from repro_torch.launch.mesh import Mesh, init_ranks, make_host_mesh
    from repro_torch.launch.sharding import (cache_specs, logits_spec,
                                             node_placer, param_bytes,
                                             place_on_mesh, place_tokens,
                                             serving_mode)
    from repro_torch.models import model as lm
    from repro_torch.models import runtime_flags
    from repro_torch.models.shards import greedy_tokens

    def tree(path):
        out = {}
        with np.load(path) as z:
            for k in z.files:
                *nodes, leaf = k.split("/")
                d = out
                for n in nodes:
                    d = d.setdefault(n, {})
                d[leaf] = z[k]
        return out

    class Gathers(TorchDispatchMode):
        # the bytes the all-gathers of a step return on this rank
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional" and \\
                    func.__name__.startswith("all_gather"):
                self.bytes += out.numel() * out.element_size()
            return out

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    info = init_ranks(device="cpu")
    d = sys.argv[1]
    r = info.rank
    mesh = make_host_mesh(data=2, model=2)
    out = {}
    for name, arch, B, S, extra, steps in json.loads(sys.argv[2]):
        cfg = get_config(arch).reduced(dtype="float32")
        inp = dict(np.load(f"{d}/{name}_in.npz"))
        out[f"{name}/groups"] = np.array(
            runtime_flags.set_moe_dispatch(cfg, mesh, B))
        # under no_grad, as the launcher serves on ranks
        with torch.no_grad():
            host = lm.params_from_numpy(tree(f"{d}/{name}_w.npz"), cfg,
                                        device="cpu")
            mode = serving_mode(mesh, param_bytes(host))
            out[f"{name}/mode"] = np.array(mode)
            params = place_on_mesh(mesh, host, mode=mode)
            del host
            batch = place_on_mesh(mesh, {k: torch.from_numpy(v) for k, v in
                                         inp.items() if k != "decode"},
                                  batch=B)
            lm.LAYOUT_FIXES.clear()
            logits, cache = lm.prefill(params, batch, cfg, kv_chunk=8,
                                       extra_cache=extra)
            fixes = [list(lm.LAYOUT_FIXES)]
            specs = (logits_spec(mesh, batch=B),
                     cache_specs(mesh, cache, cfg, batch=B))
            mism = placement_mismatches(mesh, (logits, cache), specs)
            out[f"{name}/prefill"] = whole(logits).numpy()
            out[f"{name}/prefill_tok"] = whole(
                greedy_tokens(logits, cfg.vocab)).numpy()
            for k, v in cache.items():
                out[f"{name}/prefill_cache/{k}"] = whole(v).numpy()
            for k in ("k", "state"):
                if k in cache:
                    out[f"{name}/local_{k}"] = np.array(
                        cache[k].to_local().shape)
            gathered = []
            for i in range(steps):
                tok = place_tokens(mesh, torch.from_numpy(inp["decode"][i]))
                g = Gathers()
                lm.LAYOUT_FIXES.clear()
                with g:
                    logits, cache = lm.decode_step(params, cache, tok, cfg)
                gathered.append(g.bytes)
                fixes.append(list(lm.LAYOUT_FIXES))
                out[f"{name}/decode{i}"] = whole(logits).numpy()
                out[f"{name}/decode{i}_tok"] = whole(
                    greedy_tokens(logits, cfg.vocab)).numpy()
            mism += placement_mismatches(mesh, (logits, cache), specs)
            for k, v in cache.items():
                out[f"{name}/cache/{k}"] = whole(v).numpy()
        out[f"{name}/gathered"] = np.array(gathered)
        out[f"{name}/mismatches"] = np.array(json.dumps(mism))
        out[f"{name}/fixes"] = np.array(json.dumps(fixes))
        runtime_flags.set_moe_dispatch(cfg, None, B)

    # the greedy token over a vocabulary sharded on "model": equal maxima
    # on both vocabulary shards give the first; the padded slots (from
    # 500 on) never win, however large
    from repro_torch.launch.sharding import place
    x = torch.zeros(4, 1, 512)
    x[:, 0, 10] = x[:, 0, 300] = 1.0
    x[1, 0, 10] = 0.5
    x[:, 0, 505] = 9.0
    tok = greedy_tokens(place(mesh, x, logits_spec(mesh, batch=4)), 500)
    out["greedy/ties"] = tok.full_tensor().numpy()
    out["greedy/placements"] = np.array(str(tok.placements))

    # init_model placing block by block: the same shards as placing the
    # whole model drawn from the same seed
    cfg = get_config("olmoe_1b_7b").reduced(dtype="float32")
    a = lm.init_model(cfg, seed=3, device="cpu",
                      place=node_placer(mesh, "serve"))
    b = place_on_mesh(mesh, lm.init_model(cfg, seed=3, device="cpu"),
                      mode="serve")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    out["init/same"] = np.array(sorted(pa) == sorted(pb) and all(
        pa[k].placements == pb[k].placements
        and torch.equal(pa[k].to_local(), pb[k].to_local()) for k in pa))
    del a, b, pa, pb

    # PlanService(method="sharded") on the rank group
    from repro_torch.core.ransparse import ransparse
    from repro_torch.serve import PlanService
    from repro_torch.sparse import fsparse, plan_cache_clear

    cache_dir = f"{d}/plans"
    svc = PlanService(device="cpu", method="sharded", cache_dir=cache_dir)
    one = Mesh(("data",), (4,), (torch.device("cpu"),) * 4)
    for name, (siz, nnz_row, nrep) in json.loads(sys.argv[3]).items():
        ii, jj, _, _ = ransparse(siz, nnz_row, nrep, seed=7)
        v = np.load(f"{d}/set{name}.npz")["v"]
        x = torch.from_numpy(np.load(f"{d}/set{name}.npz")["x"])
        shape = (siz, siz)
        A = svc.assemble(ii, jj, v, shape)
        ref = fsparse(ii, jj, v, shape, method="sharded", mesh=one)
        many = svc.assemble_many([(ii, jj, v, shape),
                                  (ii, jj, 2 * v, shape)])
        out[f"set{name}/type"] = np.array(type(A).__name__)
        out[f"set{name}/block_equal"] = np.array(
            torch.equal(A.data[0], ref.data[r])
            and torch.equal(A.indices[0], ref.indices[r]))
        out[f"set{name}/many_equal"] = np.array(
            torch.equal(many[0].data[0], ref.data[r])
            and torch.equal(many[1].data[0], 2 * ref.data[r]))
        out[f"set{name}/dense"] = A.to_dense().numpy()
        out[f"set{name}/spmv"] = svc.spmv(A, x).numpy()
        out[f"set{name}/spmv_one"] = ref.spmv(x).numpy()
    # set 1 planned whole as well: a plan the service persists
    siz, nnz_row, nrep = json.loads(sys.argv[3])["1"]
    ii, jj, _, _ = ransparse(siz, nnz_row, nrep, seed=7)
    v = np.load(f"{d}/set1.npz")["v"]
    plain = svc.assemble(ii, jj, v, (siz, siz), method="radix")
    out["plain/data"] = plain.data.numpy()
    st = svc.stats()
    out["stats/plan"] = np.array(json.dumps(st["plan"]))
    out["stats/persisted"] = np.array(st["persisted"])
    out["saved"] = np.array(svc.save())
    dist.barrier()
    # a restart on the same directory: the persisted plan loads on every
    # rank and its request is a hit; the sharded ones are planned anew
    plan_cache_clear()
    svc = PlanService(device="cpu", method="sharded", cache_dir=cache_dir)
    out["restart/loaded"] = np.array(svc.loaded_plans)
    before = svc.stats()["plan"]
    again = svc.assemble(ii, jj, v, (siz, siz), method="radix")
    mid = svc.stats()["plan"]
    svc.assemble(ii, jj, v, (siz, siz))
    after = svc.stats()["plan"]
    out["restart/plain_hit"] = np.array(
        mid["hits"] - before["hits"] == 1
        and mid["misses"] == before["misses"])
    out["restart/sharded_miss"] = np.array(
        after["misses"] - mid["misses"] == 1)
    out["restart/equal"] = np.array(torch.equal(again.data, plain.data))
    np.savez(f"{d}/out{r}.npz", **out)
    dist.barrier()
    print(info.describe())
"""


def _reference(name, cfg, tree, batch, decode, extra, groups):
    """The reference's prefill and (where it is held to it) decode, with
    ``groups`` MoE token groups (a jitted function reads the flag when
    it traces: its cache is cleared around the change)."""
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for f in (jmodel.prefill, jmodel.decode_step):
        f.clear_cache()
    jflags.set_moe_groups(groups)
    try:
        logits, cache = jmodel.prefill(params, jb, cfg, kv_chunk=8,
                                       extra_cache=extra)
        out["prefill"] = np.asarray(logits)
        if name in REF_DECODE:
            for i, tok in enumerate(decode):
                logits, cache = jmodel.decode_step(params, cache,
                                                   jnp.asarray(tok), cfg)
                out[f"decode{i}"] = np.asarray(logits)
    finally:
        jflags.set_moe_groups(1)
        for f in (jmodel.prefill, jmodel.decode_step):
            f.clear_cache()
    return out


def _one_process(cfg, tree, batch, decode, extra, groups):
    """The one-process port on the same weights and inputs."""
    params = tmodel.params_from_numpy(tree, cfg, device="cpu")
    tflags.set_moe_groups(groups)
    out = {}
    try:
        with torch.inference_mode():
            logits, cache = tmodel.prefill(
                params, {k: torch.from_numpy(v) for k, v in batch.items()},
                cfg, kv_chunk=8, extra_cache=extra)
            out["prefill"] = logits.numpy()
            out.update({f"prefill_cache/{k}": v.numpy()
                        for k, v in cache.items()})
            for i, tok in enumerate(decode):
                logits, cache = tmodel.decode_step(
                    params, cache, torch.from_numpy(tok), cfg)
                out[f"decode{i}"] = logits.numpy()
            out.update({f"cache/{k}": v.numpy() for k, v in cache.items()})
    finally:
        tflags.set_moe_groups(1)
    return out


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``(cases, ranks)``: each case's inputs, the reference's and the
    one-process port's answers, and the four ranks' arrays."""
    d = tmp_path_factory.mktemp("ranks_serve")
    cases = {}
    for seed, (name, arch, B, S, extra, steps) in enumerate(CASES):
        cfg, batch, decode = _inputs(name, arch, B, S, steps, seed)
        tree = jax.tree.map(np.asarray, jmodel.init_model(
            jax.random.key(seed), cfg))
        np.savez(d / f"{name}_w.npz", **_flat(tree))
        np.savez(d / f"{name}_in.npz", decode=decode, **batch)
        cases[name] = dict(cfg=cfg, tree=tree, batch=batch, decode=decode,
                           extra=extra, B=B)
    rng = np.random.default_rng(40)
    for name, (siz, nnz_row, nrep) in SETS.items():
        L = siz * nnz_row * nrep
        np.savez(d / f"set{name}.npz",
                 v=rng.integers(-8, 9, L).astype(np.float32),
                 x=rng.standard_normal(siz).astype(np.float32))
    # the ranks run while this process computes the reference's answers
    res = {}

    def ranks():
        try:
            res["ranks"] = spawn_ranks(
                [sys.executable, "-c", textwrap.dedent(_CHILD), str(d),
                 json.dumps(CASES), json.dumps(SETS)], 4,
                timeout_s=RANKS_TIMEOUT_S, env=_env(),
                rendezvous=str(d / "rendezvous"))
        except Exception as e:  # noqa: BLE001 - raised below
            res["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        for name, c in cases.items():
            groups = 2 if c["cfg"].is_moe else 1  # one a data shard
            c["ref"] = _reference(name, c["cfg"], c["tree"], c["batch"],
                                  c["decode"], c["extra"], groups)
            c["one"] = _one_process(c["cfg"], c["tree"], c["batch"],
                                    c["decode"], c["extra"], groups)
    finally:
        thread.join()
    if "error" in res:
        raise res["error"]
    for r, (_, so, _) in enumerate(res["ranks"]):
        assert so.strip().endswith(f"rank {r} of 4 on cpu (gloo)"), so
    outs = {r: dict(np.load(d / f"out{r}.npz")) for r in range(4)}
    return cases, outs, d


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_prefill_and_decode_on_a_data_model_rank_mesh(served, name):
    """Every rank's gathered logits and cache leaves are the one-process
    port's within float32 rounding, prefill (and decode, where it is held
    to it) the reference's; the greedy tokens are the argmax over the
    whole vocabulary; the outputs lie where the reference's
    ``out_shardings`` put them, and every rank redistributed the same
    outputs to get there (``model.LAYOUT_FIXES``), the same at every
    decode step."""
    cases, outs, _ = served
    c = cases[name]
    cfg, one, ref = c["cfg"], c["one"], c["ref"]
    steps = len(c["decode"])
    for r in range(4):
        o = {k.split("/", 1)[1]: v for k, v in outs[r].items()
             if k.startswith(name + "/")}
        assert str(o["mode"]) == "serve"
        assert int(o["groups"]) == (2 if cfg.is_moe else 1)
        assert json.loads(str(o["mismatches"])) == []
        fixes = json.loads(str(o["fixes"]))
        assert fixes == json.loads(str(outs[0][f"{name}/fixes"]))
        assert all(f == fixes[1] for f in fixes[1:]), fixes
        for k in ["prefill", *(f"decode{i}" for i in range(steps))]:
            assert o[k].shape == one[k].shape
            assert _rel_err(o[k], one[k]) <= F32_RTOL, (r, k)
            if k in ref:
                assert _rel_err(o[k], ref[k]) <= F32_RTOL, (r, k)
            want = np.argmax(o[k][:, -1, :cfg.vocab], axis=-1)[:, None]
            np.testing.assert_array_equal(o[f"{k}_tok"], want)
            np.testing.assert_array_equal(o[f"{k}_tok"],
                                          outs[0][f"{name}/{k}_tok"])
        for stage in ("prefill_cache", "cache"):
            keys = sorted(k.split("/")[1] for k in o
                          if k.startswith(stage + "/"))
            assert keys == sorted(k.split("/")[1] for k in one
                                  if k.startswith(stage + "/"))
            for k in keys:
                got, want = o[f"{stage}/{k}"], one[f"{stage}/{k}"]
                assert got.shape == want.shape and got.dtype == want.dtype
                if k == "pos":
                    assert int(got) == int(want)
                else:
                    assert _rel_err(got, want) <= F32_RTOL, (r, stage, k)


@pytest.mark.parametrize("name,local", [
    ("dense", (2, 2, 16, 2, 32)), ("ssm", (2, 2, 4, 16, 32)),
    ("seq_data", (2, 1, 10, 2, 32)), ("seq_model", (2, 2, 10, 1, 32)),
    ("seq_both", (2, 1, 5, 1, 32))])
def test_each_rank_holds_its_cache_shards_and_never_gathers_them(
        served, name, local):
    """The cache a rank holds is its shard by ``cache_specs`` (the batch,
    the KV heads or the sequence; for the SSM, the state's batch and
    heads), and a decode step gathers less than one layer's K cache:
    the cache is read where it lies."""
    cases, outs, _ = served
    one = cases[name]["one"]
    key = "k" if "cache/k" in one else "state"
    layer_bytes = one[f"cache/{key}"][0].nbytes
    for r in range(4):
        assert tuple(outs[r][f"{name}/local_{key}"]) == local
        assert max(outs[r][f"{name}/gathered"]) < layer_bytes


def test_greedy_tokens_over_a_sharded_vocabulary(served):
    """The first of equal maxima across the vocabulary's shards, never a
    padded slot; rows over ``data``, replicated over ``model``."""
    _, outs, _ = served
    for r in range(4):
        np.testing.assert_array_equal(outs[r]["greedy/ties"],
                                      [[10], [300], [10], [10]])
        assert str(outs[r]["greedy/placements"]) == \
            "(Shard(dim=0), Replicate())"


def test_init_model_places_block_by_block_as_the_whole_model(served):
    _, outs, _ = served
    assert all(bool(outs[r]["init/same"]) for r in range(4))


@pytest.mark.parametrize("name", sorted(SETS))
def test_plan_service_sharded_requests_on_ranks(served, name):
    """``PlanService(method="sharded")`` on the rank group: each rank's
    block is block r of the one-process plan (bit for bit on integer
    data, for ``assemble`` and ``assemble_many``), the gathered matrix
    is the oracle's, and the SpMV is the one-process SpMV's."""
    from repro_torch.core.ransparse import ransparse

    _, outs, d = served
    siz, nnz_row, nrep = SETS[name]
    ii, jj, _, _ = ransparse(siz, nnz_row, nrep, seed=7)
    z = np.load(d / f"set{name}.npz")
    dense = np.zeros((siz, siz))
    np.add.at(dense, (ii - 1, jj - 1), z["v"].astype(np.float64))
    bound = np.abs(dense) @ np.abs(z["x"].astype(np.float64))
    for r in range(4):
        o = outs[r]
        assert str(o[f"set{name}/type"]) == "ShardedCSC"
        assert bool(o[f"set{name}/block_equal"])
        assert bool(o[f"set{name}/many_equal"])
        np.testing.assert_array_equal(o[f"set{name}/dense"], dense)
        y = o[f"set{name}/spmv"].astype(np.float64)
        assert np.all(np.abs(y - dense @ z["x"]) <= 8 * np.finfo(
            np.float32).eps * bound + 1e-30)
        np.testing.assert_allclose(o[f"set{name}/spmv"],
                                   o[f"set{name}/spmv_one"], rtol=0,
                                   atol=8 * np.finfo(np.float32).eps
                                   * bound.max())


def test_plan_service_restarts_warm_on_every_rank(served):
    """The plan the four services share (written by each through the
    atomic replace) is the only entry on disk, no sharded plan; after a
    restart it loads on every rank and its request is a hit, while the
    sharded request is planned anew."""
    from repro_torch.sparse.pattern import SparsePattern

    _, outs, d = served
    files = sorted((d / "plans").glob("*.pkl"))
    assert len(files) == 1
    with open(files[0], "rb") as f:
        assert isinstance(pickle.load(f)["value"], SparsePattern)
    assert not list((d / "plans").glob("*.tmp.*"))
    for r in range(4):
        o = outs[r]
        plan = json.loads(str(o["stats/plan"]))
        assert plan["misses"] == len(SETS) + 1 and plan["hits"] == \
            2 * len(SETS)
        assert int(o["stats/persisted"]) == 1 and int(o["saved"]) == 1
        assert int(o["restart/loaded"]) == 1
        assert bool(o["restart/plain_hit"])
        assert bool(o["restart/sharded_miss"])
        assert bool(o["restart/equal"])


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------
SERVE_ARGS = ("-m", "repro_torch.launch.serve", "--arch", "olmo_1b",
              "--reduced", "--device", "cpu")
ROW = re.compile(r"^\[serve\] (\d+)/(\d+) done; sample row0: (\[.*\])$")


def _serve(*argv):
    out = subprocess.run([sys.executable, *argv], env=_env(),
                         capture_output=True, text=True,
                         timeout=RANKS_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]


def test_launcher_serves_on_ranks_and_restarts_warm(tmp_path):
    """``launch/serve.py`` under ``torch.distributed.run`` on four ranks
    (a ``(4, 1)`` mesh over the ranks, as the reference serves over
    every device): only rank 0 prints, its sample rows are the
    one-process launcher's (no ``model`` axis: each rank computes its
    rows of the bf16 model as one process computes them), and the
    second start on the same plan cache is warm on every rank.  Without
    a rank environment the launcher prints no rank line."""
    run = ("-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", *SERVE_ARGS, "--plan-cache-dir",
           str(tmp_path / "plans"))
    cold, warm = _serve(*run), _serve(*run)
    whole = _serve(*SERVE_ARGS)
    assert not any("ranks=" in ln for ln in whole)
    for lines, state, loaded in ((cold, "(cold)", 0),
                                 (warm, "(warm restart)", 1)):
        service = [ln for ln in lines if "plan service:" in ln]
        assert len(service) == 1  # rank 0 only
        assert service[0].endswith(f"{state}; plans loaded a rank "
                                   f"{[loaded] * 4}")
        assert "[serve] ranks=4 backend=gloo device=cpu mesh={'data': 4, " \
            "'model': 1} weights=serve moe_groups=1" in lines
        rows = [ROW.match(ln).groups() for ln in lines if ROW.match(ln)]
        assert rows == [ROW.match(ln).groups() for ln in whole
                        if ROW.match(ln)]
        assert len(rows) == 2
        assert re.fullmatch(r"\[serve\] 128 tokens in [\d.]+s \([\d.]+ "
                            r"tok/s incl\. prefill\)", lines[-2])
        assert lines[-1].startswith("[serve] plan service stats: ")


def test_serving_mode_is_the_dry_runs_choice():
    """One function chooses the served weights' layout for the dry run
    and the launcher: ``"serve"`` below 8 GiB a model shard."""
    from repro_torch.launch.sharding import (SERVE_PARAM_BUDGET,
                                             model_param_bytes,
                                             serving_mode)

    class Mesh:
        axis_names = ("data", "model")

        def __init__(self, tp):
            self.shape = {"data": 16, "model": tp}

    assert SERVE_PARAM_BUDGET == 8 * 2**30
    olmoe = get_config("olmoe_1b_7b")
    nbytes = model_param_bytes(olmoe)
    shapes = jax.eval_shape(lambda: jmodel.init_model(jax.random.key(0),
                                                      olmoe))
    assert nbytes == sum(x.size * x.dtype.itemsize
                         for x in jax.tree.leaves(shapes))
    assert serving_mode(Mesh(1), nbytes) == "train"  # 13.8 GB whole
    assert serving_mode(Mesh(2), nbytes) == "serve"
    # the reference's own case: dbrx-132b keeps FSDP at TP 16
    dbrx = model_param_bytes(get_config("dbrx_132b"))
    assert serving_mode(Mesh(16), dbrx) == "train"
    assert serving_mode(Mesh(16), nbytes) == "serve"
