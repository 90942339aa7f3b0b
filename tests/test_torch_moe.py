"""The port's MoE dispatch and layer against the JAX package, on the CPU.

``moe_dispatch_indices`` (the counting sort of the expert keys: B12 and
B11's plain versions here) is held bit for bit, alone and per token
group; ``moe_ffn`` under ``MOE_GROUPS`` 1 and 2 and on one-device meshes
(``moe_ffn_shardmap``) within ``F32_RTOL = 1e-5`` of the largest
magnitude of the reference's output, in float32, with the reference's
weights carried across.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.runtime_flags as jflags
from repro.launch import mesh as jmesh
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import runtime_flags as tflags

torch.set_num_threads(1)

F32_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# MoE dispatch: bit for bit
# ---------------------------------------------------------------------------
def _dispatch_case(name):
    rng = np.random.default_rng(5)
    if name == "capacity_drops":  # tests/test_models.py's own cases
        return np.array([0, 0, 0, 0, 1, 2, 3, 3], np.int32), 4, 2
    if name == "expert_contiguous":
        return rng.integers(0, 8, 256).astype(np.int32), 8, 64
    if name == "skewed":  # most picks on two experts: many drops
        e = np.where(rng.random(1000) < 0.8, rng.integers(0, 2, 1000),
                     rng.integers(0, 64, 1000))
        return e.astype(np.int32), 64, 24
    if name == "decode":  # 4 tokens x top-8 of 64
        return np.stack([rng.permutation(64)[:8] for _ in range(4)]) \
            .reshape(-1).astype(np.int32), 64, 8
    return rng.integers(0, 64, 20_000).astype(np.int32), 64, 320


@pytest.mark.parametrize("case", ["capacity_drops", "expert_contiguous",
                                  "skewed", "decode", "large"])
def test_moe_dispatch_indices_bit_for_bit(case):
    e, E, C = _dispatch_case(case)
    ws, wl = jmoe.moe_dispatch_indices(jnp.asarray(e), n_experts=E,
                                       capacity=C)
    gs, gl = tmoe.moe_dispatch_indices(_t(e), n_experts=E, capacity=C)
    assert gs.dtype == torch.int32 and gl.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    if case == "capacity_drops":
        assert int((gs >= E * C).sum()) == 2
        assert gl.tolist() == [4, 1, 1, 2]


@pytest.mark.parametrize("G,E,C,Lg", [(2, 8, 16, 64), (4, 64, 8, 32),
                                      (3, 5, 8, 40)])
def test_grouped_dispatch_is_the_reference_per_group(G, E, C, Lg):
    """One counting sort of ``g * E + e`` over G * E bins gives each
    group the reference's own dispatch (its vmapped per-group sorts)."""
    rng = np.random.default_rng(G * E)
    e = rng.integers(0, E, (G, Lg)).astype(np.int32)
    ws, wl = jax.vmap(lambda x: jmoe.moe_dispatch_indices(
        x, n_experts=E, capacity=C))(jnp.asarray(e))
    gs, gl = tmoe._group_dispatch(_t(e), n_experts=E, capacity=C, groups=G)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _moe_flags(groups=1, jax_mesh=None, torch_mesh=None):
    try:
        jflags.set_moe_groups(groups)
        tflags.set_moe_groups(groups)
        jflags.set_moe_mesh(jax_mesh)
        tflags.set_moe_mesh(torch_mesh)
        yield
    finally:
        jflags.set_moe_groups(1)
        tflags.set_moe_groups(1)
        jflags.set_moe_mesh(None)
        tflags.set_moe_mesh(None)


@pytest.mark.parametrize("route", ["groups1", "groups2", "mesh1",
                                   "mesh2_vs_groups2"])
def test_moe_ffn_matches_reference(route):
    cfg = get_config("olmoe_1b_7b").reduced(dtype="float32")
    p = jmoe.init_moe(jax.random.key(2), cfg)
    pt = tmodel._node(jax.tree.map(np.asarray, p), "cpu")
    x = np.random.default_rng(3).normal(size=(4, 6, cfg.d_model)) \
        .astype(np.float32)
    flags = {"groups1": dict(), "groups2": dict(groups=2),
             "mesh1": dict(jax_mesh=jmesh.make_host_mesh(),
                           torch_mesh=tmesh.make_host_mesh(device="cpu")),
             "mesh2_vs_groups2": dict(
                 groups=2, torch_mesh=tmesh.make_host_mesh(data=2,
                                                           device="cpu"))}
    with _moe_flags(**flags[route]):
        yj, auxj = jmoe.moe_ffn(p, jnp.asarray(x), cfg)
        yt, auxt = tmoe.moe_ffn(pt, _t(x), cfg)
        assert _rel_err(tmoe.moe_ffn_decode(pt, _t(x), cfg), yj) <= F32_RTOL
    if route == "mesh1":  # moe_ffn took moe_ffn_shardmap in both packages
        ys, _ = tmoe.moe_ffn_shardmap(pt, _t(x), cfg, flags[route][
            "torch_mesh"], ("data",))
        assert torch.equal(ys, yt)
    assert _rel_err(yt, yj) <= F32_RTOL
    assert abs(float(auxt.detach()) - float(auxj)) <= \
        F32_RTOL * abs(float(auxj))
