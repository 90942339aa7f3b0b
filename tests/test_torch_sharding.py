"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``).

The cases of ``tests/test_sharding.py`` with the same expected values;
then, for every architecture, both modes and both production meshes (as
``FakeMesh``es), the port's spec of every leaf of the full-size model
and train state (fake tensors: nothing allocated) against the
reference's spec of the same leaf over ``jax.eval_shape``, the layer
entry dropped where the reference stacks blocks; the cache, batch and
logits specs; the per-rank bytes of the parameters and of the train
state; and, in a child with four forced host devices, every rank's
shard of ``param_shardings`` on a 2 x 2 mesh against
``NamedSharding.devices_indices_map``.
"""
import functools
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref_sharding
from repro.launch.specs import cell_applicable as ref_cell_applicable
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.model import init_cache as ref_init_cache
from repro.models.model import init_model as ref_init_model
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.train_step import TrainConfig as RefTrainConfig
from repro.train.train_step import init_train_state as ref_init_train_state
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.sharding import (
    P,
    batch_spec,
    batch_specs_for,
    cache_specs,
    logits_spec,
    map_with_path,
    param_shardings,
    param_specs,
    spec_for_param,
)
from repro_torch.launch.specs import cell_applicable, input_specs
from repro_torch.models.config import SHAPES
from repro_torch.models.model import init_cache, init_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Mesh stand-in with production axis sizes (no devices needed)."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class FakeMultiMesh:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = {"single": FakeMesh(), "multi": FakeMultiMesh()}


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases, on the port
# ---------------------------------------------------------------------------
def test_param_rules():
    fm = FakeMesh()
    assert spec_for_param(fm, "layers/attn/q_in", (16, 1024, 2048)) == \
        P(None, "data", "model")
    assert spec_for_param(fm, "layers/attn/o_out", (16, 2048, 1024)) == \
        P(None, "model", "data")
    assert spec_for_param(fm, "embed/embedding", (50304, 1024)) == \
        P("model", None)
    assert spec_for_param(fm, "layers/moe/gate_ein", (64, 1024, 512)) == \
        P("model", "data", None)
    assert spec_for_param(fm, "layers/norm1/scale", (1024,)) == P(None)
    assert spec_for_param(fm, "opt/master/layers/attn/q_in",
                          (16, 1024, 2048)) == P(None, "data", "model")


def test_param_rules_divisibility_fallback():
    fm = FakeMesh()
    # vocab not divisible by 16 -> replicate that dim
    assert spec_for_param(fm, "embed/embedding", (50281, 1024)) == \
        P(None, None)
    # head count smaller than axis -> replicated
    assert spec_for_param(fm, "layers/mamba/a_log", (7,)) == P(None)


def test_cache_specs_batch_vs_sequence_sharding():
    fm = FakeMesh()
    cfg = get_config("gemma3_1b")
    # decode_32k: batch 128 shards on data; gemma kv=1 can't TP-shard,
    # so the sequence dim goes on "model" (§Perf iteration 8)
    cache = init_cache(cfg, batch=128, seq_len=256, device="meta")
    specs = cache_specs(fm, cache, cfg, batch=128)
    assert specs["k"][1] == "data"
    assert specs["k"][2] == "model"
    # long_500k: batch 1 -> sequence carries both data and model axes
    cache1 = init_cache(cfg, batch=1, seq_len=512 * 16 * 16, device="meta")
    specs1 = cache_specs(fm, cache1, cfg, batch=1)
    assert specs1["k"][1] is None
    assert specs1["k"][2] == ("data", "model")


def test_batch_spec_b1_fallback():
    fm = FakeMesh()
    assert batch_spec(fm, batch=256) == P(("data",), None)
    assert batch_spec(fm, batch=1) == P(None, None)


def test_mesh_functions_do_not_touch_devices():
    """make_production_mesh is a function; importing mesh.py is inert."""
    import torch.distributed as dist

    import repro_torch.launch.mesh as m
    from torch.distributed.device_mesh import DeviceMesh

    names = [n for n in dir(m) if not n.startswith("_")]
    for n in names:
        assert not isinstance(getattr(m, n), DeviceMesh)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="exactly 256 ranks"):
        m.make_production_mesh(device="cpu")


def test_axis_size_reads_every_kind_of_mesh():
    from repro_torch.launch.mesh import (axis_size, batch_axes, dp_size,
                                         make_host_mesh, tp_size)

    class DeviceMeshLike:  # a DeviceMesh's shape is a tuple
        shape = (2, 16, 16)
        mesh_dim_names = ("pod", "data", "model")

    port = make_host_mesh(data=2, model=3, device="cpu")
    for mesh, dp, tp in ((FakeMultiMesh(), 32, 16), (DeviceMeshLike(), 32, 16),
                         (port, 2, 3), (FakeMesh(), 16, 16)):
        assert dp_size(mesh) == dp and tp_size(mesh) == tp
        assert axis_size(mesh, batch_axes(mesh)) == dp
        assert axis_size(mesh, ()) == 1


# ---------------------------------------------------------------------------
# Every leaf of every config against the reference
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_trees(arch):
    cfg = ref_get_config(arch)
    params = jax.eval_shape(lambda: ref_init_model(jax.random.key(0), cfg))
    state = jax.eval_shape(lambda: ref_init_train_state(
        ref_init_model(jax.random.key(0), cfg),
        RefTrainConfig(opt=RefOptConfig(), compress_grads=True)))
    return params, state


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    with FakeTensorMode():
        params = init_model(cfg, device="cpu")
        state = init_train_state(params, TrainConfig(
            opt=OptConfig(), compress_grads=True))
    return params, state


def _norm(spec) -> tuple:
    """A spec's entries as JAX's ``PartitionSpec`` iterates them: a
    one-axis tuple reads as that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_named(tree, specs):
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name] = (tuple(leaf.shape), tuple(spec))
    return out


def _port_named(tree, specs):
    leaves, got = [], []
    map_with_path(lambda n, leaf, b: leaves.append((n, leaf, b)), tree)
    map_with_path(lambda n, s, b: got.append(s), specs)
    return [(n, tuple(leaf.shape), b, tuple(s))
            for (n, leaf, b), s in zip(leaves, got)]


def _assert_same_specs(port_tree, ref_tree, mesh, mode):
    ref = _ref_named(ref_tree, ref_sharding.param_specs(mesh, ref_tree,
                                                        mode=mode))
    port = _port_named(port_tree, param_specs(mesh, port_tree, mode=mode))
    assert {n for n, *_ in port} == set(ref)
    for name, shape, blocks, spec in port:
        ref_shape, ref_spec = ref[name]
        if blocks is None:
            assert (shape, spec) == (ref_shape, ref_spec), name
        else:
            assert (blocks, *shape) == ref_shape, name
            assert spec == ref_spec[1:], name
            assert ref_spec[0] is None, name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mode, mesh):
    assert ARCHS == REF_ARCHS
    _assert_same_specs(_port_trees(arch)[0], _ref_trees(arch)[0],
                       MESHES[mesh], mode)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_the_reference(arch, mesh):
    _assert_same_specs(_port_trees(arch)[1], _ref_trees(arch)[1],
                       MESHES[mesh], "train")


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    ok, why = cell_applicable(cfg, SHAPES[shape])
    assert (ok, why) == ref_cell_applicable(ref_cfg, REF_SHAPES[shape])
    if not ok:
        assert why.startswith("skipped: pure full-attention arch")
        return
    B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    port_cache = input_specs(cfg, shape)["cache"]
    ref_cache = jax.eval_shape(lambda: ref_init_cache(ref_cfg, batch=B,
                                                      seq_len=S))
    for mesh in MESHES.values():
        got = cache_specs(mesh, port_cache, cfg, batch=B)
        want = ref_sharding.cache_specs(mesh, ref_cache, ref_cfg, batch=B)
        assert set(got) == set(want)
        for k in got:
            assert tuple(port_cache[k].shape) == ref_cache[k].shape
            assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batch_and_logits_specs_match_the_reference(shape):
    B = SHAPES[shape].global_batch
    specs = input_specs(get_config("zamba2_7b"), shape)
    batch = specs.get("batch") or {"tokens": specs["tokens"]}
    ref_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                 for k, v in batch.items()}
    for mesh in MESHES.values():
        got = batch_specs_for(mesh, batch, batch=B)
        want = ref_sharding.batch_specs_for(mesh, ref_batch, batch=B)
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        assert _norm(logits_spec(mesh, batch=B)) == \
            tuple(ref_sharding.logits_spec(mesh, batch=B))
        assert _norm(batch_spec(mesh, batch=B)) == \
            tuple(ref_sharding.batch_spec(mesh, batch=B))
        assert batch_spec(mesh, batch=B) == ref_sharding.batch_spec(
            mesh, batch=B)


# ---------------------------------------------------------------------------
# Per-rank bytes
# ---------------------------------------------------------------------------
#: params per rank in the serve mode the dry run picks, and the train
#: state per rank (MiB, one decimal), from the reference's rules
PER_RANK_MIB = {
    "seamless_m4t_medium": ("serve", 85.4, 313.0),
    "mamba2_780m": ("serve", 93.2, 132.5),
    "dbrx_132b": ("train", 1060.7, 9486.3),
    "olmoe_1b_7b": ("serve", 820.4, 602.0),
    "qwen3_0_6b": ("serve", 71.2, 197.7),
    "starcoder2_15b": ("serve", 2586.9, 1766.9),
    "gemma3_1b": ("serve", 119.3, 372.1),
    "olmo_1b": ("serve", 140.3, 182.8),
    "zamba2_7b": ("serve", 791.7, 569.1),
    "llama_3_2_vision_11b": ("serve", 1143.3, 1177.4),
}


def _port_rank_bytes(tree, mesh, mode) -> int:
    specs, leaves = [], []
    map_with_path(lambda n, s, b: specs.append(s),
                  param_specs(mesh, tree, mode=mode))
    map_with_path(lambda n, t, b: leaves.append(t), tree)
    return sum(t.numel() * t.element_size() // math.prod(
        math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str) else e))
        for e in s if e is not None) for t, s in zip(leaves, specs))


def _ref_rank_bytes(tree, mesh, mode) -> int:
    total = 0
    specs = ref_sharding.param_specs(mesh, tree, mode=mode)
    for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x,
                                                jax.sharding.PartitionSpec))):
        div = math.prod(
            math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str)
                                               else e))
            for e in s if e is not None)
        total += leaf.size * leaf.dtype.itemsize // div
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_bytes(arch):
    mode, serve_mib, train_mib = PER_RANK_MIB[arch]
    port_params, port_state = _port_trees(arch)
    ref_params, ref_state = _ref_trees(arch)
    # the dry run's serving rule: TP only while params / TP < 8 GiB
    param_bytes = sum(t.numel() * t.element_size()
                      for t in port_params.parameters())
    assert (param_bytes / 16 < 8 * 2**30) == (mode == "serve")
    for mesh in MESHES.values():
        got = _port_rank_bytes(port_params, mesh, mode)
        assert got == _ref_rank_bytes(ref_params, mesh, mode)
        assert round(got / 2**20, 1) == serve_mib
        got = _port_rank_bytes(port_state, mesh, "train")
        assert got == _ref_rank_bytes(ref_state, mesh, "train")
        assert round(got / 2**20, 1) == train_mib


# ---------------------------------------------------------------------------
# Every rank's shard against JAX's NamedSharding
# ---------------------------------------------------------------------------
_SHARDS_CHILD = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.launch.sharding import param_specs
    from repro.models.model import init_model
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    coord = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
             for d in mesh.devices.flat}
    out = {}
    for arch in sys.argv[1:]:
        cfg = get_config(arch).reduced(d_model=256, n_heads=8, head_dim=32)
        params = jax.eval_shape(lambda: init_model(jax.random.key(0), cfg))
        specs = param_specs(mesh, params)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        for (path, leaf), spec in zip(flat, jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))):
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            out[arch + ":" + name] = sorted(
                (coord[d.id], [[s.start or 0, s.stop if s.stop is not None
                                else n] for s, n in zip(idx, leaf.shape)])
                for d, idx in m.items())
    print(json.dumps(out))
""")


def _flat(tree) -> list:
    """The leaves of a tree of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def test_param_shardings_give_each_rank_the_reference_shard():
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset

    archs = ["olmoe_1b_7b", "zamba2_7b"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _SHARDS_CHILD, *archs],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    want = json.loads(out.stdout.strip().splitlines()[-1])

    class Mesh22:
        shape = (2, 2)
        mesh_dim_names = ("data", "model")

    checked = 0
    for arch in archs:
        cfg = get_config(arch).reduced(d_model=256, n_heads=8, head_dim=32)
        with FakeTensorMode():
            params = init_model(cfg, device="cpu")
        leaves = []
        map_with_path(lambda n, t, b: leaves.append((n, t, b)), params)
        pls = _flat(param_shardings(Mesh22(), params))
        seen = {}
        for (name, t, blocks), pl in zip(leaves, pls):
            shards = []
            for i in range(2):
                for j in range(2):
                    shape, offset = _compute_local_shape_and_global_offset(
                        tuple(t.shape), (2, 2), [i, j], pl)
                    box = [[o, o + n] for o, n in zip(offset, shape)]
                    if blocks is not None:  # the reference's layer axis
                        box = [[0, blocks]] + box
                    shards.append(([i, j], box))
            seen.setdefault(f"{arch}:{name}", sorted(shards))
        for key, shards in seen.items():
            assert shards == [(c, b) for c, b in want[key]], key
            checked += 1
    assert checked == len(want)
