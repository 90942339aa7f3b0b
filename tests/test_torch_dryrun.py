"""The port's dry run (``repro_torch.launch.dryrun``) and the custom ops
it traces through.

``torch.library.opcheck`` on B12 and B11 as custom ops.  Then, in child
processes (a process group per process, each with its own timeout),
reduced configs of the six families, each step (train, prefill, decode)
with shapes cut through a monkeypatched ``SHAPES``, traced on fake
tensors over a fake ``"cpu"`` 2 x 2 mesh: every cell runs, its
``argument_bytes`` are the bytes of its arguments' local shards, and on
a 1 x 1 mesh its per-rank FLOPs equal ``FlopCounterMode``'s count of
the plain CPU step; the FLOPs are the rank's own (a 4-way product
counts a quarter); a train step's extrapolation from two and three
microbatches equals the whole step; a DTensor train and decode step on
a real one-rank ``gloo`` mesh are bit for bit the plain ones; the
``long_500k`` skip reason is the reference's; the CLI writes the
reference's file names and keys; ``collective_census`` over a hand-made
record.
"""
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from repro.launch.dryrun import collective_census as ref_census
from repro.launch.specs import cell_applicable as ref_cell_applicable
from repro.configs import get_config as ref_get_config
from repro.models.config import SHAPES as REF_SHAPES
from repro_torch.kernels.counting_sort.counting_sort import placement
from repro_torch.kernels.hist.hist import block_histogram
from repro_torch.kernels.hist.ops import block_offsets
from repro_torch.launch.dryrun import collective_census

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")

#: one architecture of each family
FAMILIES = {"dense": "olmo_1b", "moe": "olmoe_1b_7b", "ssm": "mamba2_780m",
            "hybrid": "zamba2_7b", "encdec": "seamless_m4t_medium",
            "vlm": "llama_3_2_vision_11b"}
STEPS = ("train_4k", "prefill_32k", "decode_32k")


# ---------------------------------------------------------------------------
# B12 and B11 as custom ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L,nbins,block_b", [(1000, 10, 256), (4096, 300, 1024),
                                             (37, 5, 8)])
def test_custom_ops_pass_opcheck(L, nbins, block_b):
    g = torch.Generator().manual_seed(L)
    keys = torch.randint(-1, nbins + 1, (L,), dtype=torch.int32, generator=g)
    torch.library.opcheck(torch.ops.repro_torch.block_histogram.default,
                          (keys, nbins, block_b))
    offsets, _ = block_offsets(keys, nbins=nbins, block_b=block_b)
    for consume in (False, True):
        torch.library.opcheck(torch.ops.repro_torch.placement.default,
                              (keys, offsets.clone(), nbins, block_b,
                               consume))
    # the wrappers are the ops; on the CPU no kernel launches
    launches = (block_histogram.launches, placement.launches)
    assert torch.equal(block_histogram(keys, nbins=nbins, block_b=block_b),
                       torch.ops.repro_torch.block_histogram(keys, nbins,
                                                             block_b))
    placement(keys, offsets, nbins=nbins, block_b=block_b)
    assert (block_histogram.launches, placement.launches) == launches


def test_collective_census_over_a_record():
    rec = [("all_reduce", 1024 * 512 * 4), ("all-gather", 8 * 128 * 2),
           ("all_to_all_single", 2 * 16 * 8 * 4),
           ("collective-permute", 64 * 4),
           ("reduce_scatter_tensor", 12)]
    c = collective_census(rec)
    assert c["all-reduce"] == {"count": 1, "bytes": 1024 * 512 * 4}
    assert c["all-gather"]["bytes"] == 8 * 128 * 2
    assert c["all-to-all"] == {"count": 1, "bytes": 2 * 16 * 8 * 4}
    assert c["collective-permute"]["bytes"] == 64 * 4
    assert c["reduce-scatter"]["count"] == 1
    assert c["total_bytes"] == sum(
        c[k]["bytes"] for k in ("all-reduce", "all-gather", "all-to-all",
                                "collective-permute", "reduce-scatter"))
    # the reference's schema, as it parses it from HLO
    want = ref_census("%all-reduce.1 = f32[4]{0} all-reduce(%x)")
    assert set(c) == set(want)
    assert all(set(c[k]) == set(want[k]) for k in want if k != "total_bytes")


# ---------------------------------------------------------------------------
# Children: traces of reduced cells on fake meshes
# ---------------------------------------------------------------------------
_PRELUDE = textwrap.dedent("""
    import json, math, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.models.config import ShapeConfig

    SHAPES = {"train_4k": ShapeConfig("train_4k", 16, 4, "train"),
              "prefill_32k": ShapeConfig("prefill_32k", 16, 4, "prefill"),
              "decode_32k": ShapeConfig("decode_32k", 16, 4, "decode"),
              "long_500k": ShapeConfig("long_500k", 64, 1, "decode")}
    D.SHAPES = S.SHAPES = SHAPES
    D.get_config = lambda a: get_config(a).reduced()

    def mesh(*shape):
        D.init_fake_group(math.prod(shape))
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))

    def shard_bytes(tree):
        from torch.distributed.tensor import DTensor, Shard
        total = 0
        for t in D._leaves(list(tree)):
            div = math.prod(t.device_mesh.size(m)
                            for m, p in enumerate(t.placements)
                            if isinstance(p, Shard))
            total += t.numel() * t.element_size() // div
        return total
""")

_CELLS = _PRELUDE + textwrap.dedent("""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import runtime_flags
    from repro_torch.models.model import decode_step, init_cache, \\
        init_model, prefill
    from repro_torch.train.train_step import TrainConfig, \\
        init_train_state, make_train_step

    arch = sys.argv[1]
    out = {}
    m = mesh(2, 2)
    for shape in sys.argv[2:]:
        low, why = D.build_lowered(arch, shape, m, microbatches=1)
        rec = low.trace()
        out[shape] = {"status": "ok" if low else why,
                      "argument_bytes": rec["argument_bytes"],
                      "shard_bytes": shard_bytes(low.args),
                      "mismatches": D.placement_mismatches(
                          m, rec["out"], low.out_specs)}
    # a 1 x 1 mesh: the rank does the whole step
    m = mesh(1, 1)
    cfg = D.get_config(arch)
    for shape in sys.argv[2:]:
        sh = SHAPES[shape]
        low, _ = D.build_lowered(arch, shape, m, microbatches=1)
        out[shape]["flops"] = low.trace()["flops"]
        runtime_flags.set_moe_mesh(None)
        runtime_flags.set_moe_groups(1)
        params = init_model(cfg, device="cpu", seed=0)
        tokens = torch.zeros((sh.global_batch, 1 if sh.kind == "decode"
                              else sh.seq_len), dtype=torch.int32)
        spec = S.input_specs(cfg, shape)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in spec.get("batch", {}).items()}
        with FlopCounterMode(display=False) as fc:
            if sh.kind == "train":
                step = make_train_step(cfg, TrainConfig())
                step(init_train_state(params, TrainConfig()), batch)
            elif sh.kind == "prefill":
                with torch.no_grad():
                    prefill(params, batch, cfg, kv_chunk=1024)
            else:
                with torch.no_grad():
                    decode_step(params, init_cache(
                        cfg, batch=sh.global_batch, seq_len=sh.seq_len,
                        device="cpu"), tokens, cfg)
        out[shape]["plain_flops"] = fc.get_total_flops()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of this file, six at a time: their results by name
    (an exception for a child that failed)."""
    tmp = tmp_path_factory.mktemp("dryrun")
    jobs = {("cells", fam): (_CELLS, arch, *STEPS)
            for fam, arch in FAMILIES.items()}
    jobs.update({("extrapolate", a): (_EXTRAPOLATE, a)
                 for a in ("olmoe_1b_7b", "zamba2_7b")})
    jobs.update({("flops",): (_FLOPS,), ("parity",): (_PARITY,),
                 ("skip",): (_SKIP, "qwen3_0_6b", str(tmp)),
                 ("cli",): (_CLI, "--arch", "olmo_1b", "--shape",
                            "decode_32k", "--mesh", "single", "--device",
                            "cpu", "--out", str(tmp))})
    with ThreadPoolExecutor(max_workers=6) as pool:
        futs = {k: pool.submit(_run, *v) for k, v in jobs.items()}
        return {k: f.result() for k, f in futs.items()}, tmp


def _run(code, *args, timeout=240):
    return subprocess.run([sys.executable, "-c", code, *args], env=ENV,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


def _result(children, *key):
    out = children[0][key]
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", STEPS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_cells_trace_on_a_fake_mesh(children, family, shape):
    got = _result(children, "cells", family)[shape]
    assert got["status"] == "ok"
    assert got["argument_bytes"] == got["shard_bytes"] > 0
    # on one rank the traced step is the plain step, FLOP for FLOP
    assert got["flops"] == got["plain_flops"] > 0


_FLOPS = textwrap.dedent("""
    import json, math, torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun as D

    D.init_fake_group(4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    fake = FakeTensorMode()
    with fake:
        a = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0)],
                              src_data_rank=None)
        b = distribute_tensor(torch.randn(32, 16), mesh, [Replicate()],
                              src_data_rank=None)
    # a template on the meta device (prefill's cache shapes) is no memory
    rank = D._trace_once(
        lambda x, y: (torch.empty(1 << 20, device="meta"), x @ y)[1],
        (a, b), fake, False)
    with fake, FlopCounterMode(display=False) as fc:
        a @ b
    print(json.dumps({"rank": rank["flops"], "global": fc.get_total_flops(),
                      "temp": rank["temp_bytes"],
                      "out": rank["output_bytes"]}))
""")


def test_flops_are_the_ranks_own(children):
    got = _result(children, "flops")
    assert got["global"] == 2 * 64 * 32 * 16 == 65_536
    assert got["rank"] == 16_384
    assert got["temp"] == got["out"] == 16 * 16 * 4


_EXTRAPOLATE = _PRELUDE + textwrap.dedent("""
    import dataclasses
    SHAPES["train_4k"] = ShapeConfig("train_4k", 16, 16, "train")
    m = mesh(2, 2)
    out = []
    for extrapolate in (False, True):
        low, _ = D.build_lowered(sys.argv[1], "train_4k", m, microbatches=4,
                                 extrapolate=extrapolate)
        rec = low.trace()
        out.append({k: rec[k] for k in ("argument_bytes", "output_bytes",
                                         "temp_bytes", "flops", "census")})
    print(json.dumps(out))
""")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_7b"])
def test_train_extrapolation_equals_the_whole_step(children, arch):
    whole, line = _result(children, "extrapolate", arch)
    # FLOPs, every collective's count and bytes, the arguments and the
    # outputs exactly; the peak to within the loss scalars the loop
    # keeps (4 bytes a microbatch: the peak may fall before or after a
    # microbatch's scalar is kept)
    temp = whole.pop("temp_bytes"), line.pop("temp_bytes")
    assert line == whole
    assert abs(temp[0] - temp[1]) <= 4 * 4
    assert whole["flops"] > 0 and whole["census"]["total_bytes"] > 0


_PARITY = textwrap.dedent("""
    import copy, json, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.counting_sort.counting_sort import placement
    from repro_torch.kernels.hist.hist import block_histogram
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.sharding import (batch_specs_for, cache_specs,
                                             param_specs)
    from repro_torch.models import runtime_flags
    from repro_torch.models.model import decode_step, init_cache, init_model
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("olmoe_1b_7b").reduced()
    tcfg = TrainConfig(microbatches=2)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), dtype=torch.int32,
                              generator=g) for k in ("tokens", "labels")}
    tokens = batch["tokens"][:, :1].contiguous()

    def counts():
        return (block_histogram.launches, placement.launches)

    plain = init_train_state(init_model(cfg, device="cpu", seed=3), tcfg)
    placed = D._place(mesh, copy.deepcopy(plain), param_specs(mesh, plain))
    b_placed = D._place(mesh, batch, batch_specs_for(mesh, batch, batch=4))
    step = make_train_step(cfg, tcfg)
    new_plain, m_plain = step(plain, batch)
    runtime_flags.set_moe_mesh(mesh, ("data",))
    new_placed, m_placed = step(placed, b_placed)
    same = [torch.equal(a, b.full_tensor()) for a, b in zip(
        D._leaves(new_plain), D._leaves(new_placed))]
    loss = torch.equal(m_plain["loss"], m_placed["loss"].full_tensor())

    cache = init_cache(cfg, batch=4, seq_len=16, device="cpu")
    params = new_plain["params"]
    runtime_flags.set_moe_mesh(None)
    torch.set_grad_enabled(False)  # as the serving path decodes
    logits, c_plain = decode_step(params, cache, tokens, cfg)
    p_placed = D._place(mesh, params, param_specs(mesh, params,
                                                  mode="serve"))
    c_placed = D._place(mesh, cache, cache_specs(mesh, cache, cfg, batch=4))
    t_placed = D._place(mesh, {"t": tokens}, batch_specs_for(
        mesh, {"t": tokens}, batch=4))["t"]
    runtime_flags.set_moe_mesh(mesh, ("data",))
    logits2, c2 = decode_step(p_placed, c_placed, t_placed, cfg)
    print(json.dumps({"state": same, "loss": loss,
                      "logits": torch.equal(logits, logits2.full_tensor()),
                      "cache": all(torch.equal(c_plain[k], c2[k].full_tensor())
                                   for k in c_plain)}))
""")


def test_dtensor_steps_on_one_rank_are_the_plain_steps(children):
    got = _result(children, "parity")
    assert got["state"] and all(got["state"])
    assert got["loss"] and got["logits"] and got["cache"]


_SKIP = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun as D
    r = D.run_cell(sys.argv[1], "long_500k", "single", sys.argv[2],
                   device="cpu")
    print(json.dumps(r))
""")


def test_long_500k_skip_reason_is_the_references(children):
    got = _result(children, "skip")
    tmp_path = children[1]
    ok, why = ref_cell_applicable(ref_get_config("qwen3_0_6b"),
                                  REF_SHAPES["long_500k"])
    assert not ok
    assert got["status"] == "skipped" and got["reason"] == why
    assert got["mesh_shape"] == {"data": 16, "model": 16}
    assert json.loads((tmp_path / "qwen3_0_6b__long_500k__single.json")
                      .read_text()) == got


_CLI = _PRELUDE + textwrap.dedent("""
    SHAPES["decode_32k"] = ShapeConfig("decode_32k", 32, 32, "decode")
    sys.exit(D.main(sys.argv[1:]))
""")


def test_cli_writes_the_references_files_and_keys(children):
    out, tmp_path = children[0][("cli",)], children[1]
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[dryrun] olmo_1b x decode_32k x single: OK" in out.stdout
    assert "[dryrun] done: 1 ok, 0 skipped, 0 errors" in out.stdout
    r = json.loads((tmp_path / "olmo_1b__decode_32k__single.json")
                   .read_text())
    # the reference's keys, with trace_s where it has lower_s, compile_s
    assert {"arch", "shape", "mesh", "mesh_shape", "status", "trace_s",
            "memory", "flops", "transcendentals", "bytes_accessed",
            "collectives"} <= set(r)
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "generated_code_bytes"}
    assert r["status"] == "ok" and r["flops"] > 0
    assert r["transcendentals"] == 0 and r["bytes_accessed"] == -1
    assert r["mesh_shape"] == {"data": 16, "model": 16}
    assert set(r["collectives"]) == set(ref_census(""))
