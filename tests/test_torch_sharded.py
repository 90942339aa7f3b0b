"""The sharded assembly path (``sparse/sharded.py``) against the JAX package's.

The same seeded numpy triplets go to ``repro.sparse.plan_sharded`` and
to the port's, on a mesh of p shards: p = 1 in this process (the
reference on a one-device mesh, the port on
``make_data_mesh(1, device="cpu")``), p = 4 against the reference in
one subprocess that sees four forced host devices and writes every
array to one ``.npz``.  Every ``ShardedPattern`` field must be bit for
bit the reference's; values bit for bit on integer-valued data and
within ``C_SEG * eps`` of each slot's sum|terms| on random data (the
reference's scatter-add order is not fixed); gradients within float32
rounding of ``jax.grad`` through the reference's ``custom_vjp``; every
rejection's message word for word, and the validators' invariant names
and messages.  Then what only the port has: the mesh helpers and their
refusals, the ``sparse2`` key over meshes, ``PlanService``'s sharded
branch and the operators over the ``"sharded"`` format.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ransparse import dataset
from repro.launch.mesh import make_data_mesh as jax_mesh
from repro.sparse import convert as jconvert
from repro.sparse import fsparse as jax_fsparse
from repro.sparse import plan_sharded as jax_plan_sharded
from repro.sparse import sparse2 as jax_sparse2
from repro.sparse.analysis import invariants as jax_invariants
from repro.sparse.errors import InvariantViolation as JaxInvariantViolation
from repro_torch.kernels import fill_sharded_pallas
from repro_torch.launch import Mesh, make_data_mesh
from repro_torch.sparse import (PlanService, ShardedCSC, ShardedPattern,
                                convert, find, fsparse, nnz_of, ops,
                                plan_cache_clear, plan_cache_info,
                                plan_sharded, plan_sharded_coo, sparse2,
                                validate_matrix, validate_pattern)
from repro_torch.sparse.errors import InvariantViolation
from repro_torch.sparse.matlab import plan_lookup
from repro_torch.sparse.sharded import mesh_fingerprint, resolve_mesh

torch.set_num_threads(1)

CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: the plan's integer fields, held bit for bit
FIELDS = ("send_slot", "perm", "slot", "indices", "indptr", "nnz",
          "send_base", "block_load", "overflow")
#: B3''s tolerance: each slot within C_SEG * eps * sum|terms|
C_SEG = 16
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _fresh_cache():
    plan_cache_clear()
    yield
    plan_cache_clear()


def mesh1():
    return make_data_mesh(1, device=CPU)


def _set(k):
    ii, jj, _, siz = dataset(k, seed=42, scale=0.01)
    return (ii - 1).astype(np.int32), (jj - 1).astype(np.int32), siz


def _assert_fields(pat, want: dict, what: str):
    for f in FIELDS:
        got = getattr(pat, f).numpy()
        ref = np.asarray(want[f])
        assert got.shape == ref.shape, f"{what}: {f} {got.shape}"
        np.testing.assert_array_equal(got, ref, err_msg=f"{what}: {f}")


def _within_seg_tol(got, want, mag):
    """|got - want| <= C_SEG * eps * sum|terms| slot by slot."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= C_SEG * EPS32 * np.asarray(mag) + 1e-30), \
        float(err.max())


def _message(fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the type is compared too
        return type(e).__name__, str(e)
    raise AssertionError("no exception raised")


# ---------------------------------------------------------------------------
# p = 1, in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plan_fields_fill_and_formats_match_reference(k):
    rows, cols, siz = _set(k)
    shape = (siz, siz)
    ref = jax_plan_sharded(rows, cols, shape, mesh=jax_mesh(1))
    pat = plan_sharded(rows, cols, shape, mesh=mesh1())
    assert isinstance(pat, ShardedPattern) and pat.p == 1
    assert (pat.L, pat.L_pad, pat.capacity, pat.rpb, pat.nzb) == \
        (ref.L, ref.L_pad, ref.capacity, ref.rpb, ref.nzb)
    _assert_fields(pat, {f: getattr(ref, f) for f in FIELDS}, f"set {k}")
    assert int(pat.nnz_total()) == int(ref.nnz_total())
    assert bool(pat.any_overflow()) is False
    rng = np.random.default_rng(k)
    L = rows.shape[0]
    vi = rng.integers(-9, 10, L).astype(np.float32)
    A, R = pat.assemble(torch.from_numpy(vi)), ref.assemble(jnp.asarray(vi))
    for f in ("data", "indices", "indptr", "nnz"):
        np.testing.assert_array_equal(getattr(A, f).numpy(),
                                      np.asarray(getattr(R, f)), err_msg=f)
    np.testing.assert_array_equal(A.to_dense().numpy(),
                                  np.asarray(R.to_dense()))
    for target in ("coo", "csc"):
        mine, want = convert(A, target), jconvert(R, target)
        for f, g in zip(dataclasses.astuple(mine)[:-1],
                        dataclasses.astuple(want)[:-1]):
            np.testing.assert_array_equal(f.numpy(), np.asarray(g))
    assert nnz_of(A) == nnz_of(R)
    vb = rng.standard_normal((3, L)).astype(np.float32)
    Ab = pat.assemble_batch(torch.from_numpy(vb))
    Rb = ref.assemble_batch(jnp.asarray(vb))
    assert tuple(Ab.data.shape) == tuple(Rb.data.shape)
    mag = pat.assemble_batch(torch.from_numpy(np.abs(vb))).data.numpy()
    _within_seg_tol(Ab.data.numpy(), np.asarray(Rb.data), mag)
    for b in range(3):
        one = pat.assemble(torch.from_numpy(vb[b])).data.numpy()
        np.testing.assert_array_equal(Ab.batch_select(b).data.numpy(), one)
    x = rng.standard_normal(siz).astype(np.float32)
    A1 = Ab.batch_select(0)
    y = A1.spmv(torch.from_numpy(x)).numpy()
    y_ref = np.asarray(Rb.batch_select(0).spmv(jnp.asarray(x)))
    bound = np.abs(A1.to_dense().numpy()) @ np.abs(x)
    assert np.all(np.abs(y - y_ref) <= 8 * EPS32 * bound + 1e-30)
    np.testing.assert_array_equal((A1 @ torch.from_numpy(x)).numpy(), y)


def test_gradient_matches_jax_grad_through_the_custom_vjp():
    rng = np.random.default_rng(3)
    L, M, N = 800, 41, 29
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    v = rng.standard_normal(L).astype(np.float32)
    x = rng.standard_normal(N).astype(np.float32)
    ref = jax_plan_sharded(rows, cols, (M, N), mesh=jax_mesh(1))
    pat = plan_sharded(rows, cols, (M, N), mesh=mesh1())
    g_ref = jax.grad(lambda w: jnp.sum(
        ref.assemble(w).spmv(jnp.asarray(x)) ** 2))(jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_()
    (pat.assemble(vt).spmv(torch.from_numpy(x)) ** 2).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)
    vb = rng.standard_normal((3, L)).astype(np.float32)
    w = rng.standard_normal((1, 3, pat.nzb)).astype(np.float32)
    gb_ref = jax.grad(lambda u: jnp.sum(
        ref.assemble_batch(u).data * w))(jnp.asarray(vb))
    vbt = torch.from_numpy(vb).requires_grad_()
    (pat.assemble_batch(vbt).data * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(vbt.grad.numpy(), np.asarray(gb_ref))


def _rejections(rows, cols, shape, pat_ref, pat):
    """(name, reference call, port call) of every sharded rejection."""
    L = rows.shape[0]
    args = (rows + 1, cols + 1, np.ones(L))
    v = np.ones(L, np.float32)
    A_ref = pat_ref.assemble_batch(jnp.ones((2, L)))
    A = pat.assemble_batch(torch.ones(2, L))
    x = np.ones(shape[1], np.float32)
    jm, pm = jax_mesh(1), mesh1()
    return [
        ("symmetric",
         lambda: jax_plan_sharded(rows, cols, shape, mesh=jm, symmetric=True),
         lambda: plan_sharded(rows, cols, shape, mesh=pm, symmetric=True)),
        ("update", lambda: pat_ref.update(rows, cols),
         lambda: pat.update(rows, cols)),
        ("nzmax",
         lambda: jax_fsparse(*args, shape, 5, method="sharded", mesh=jm),
         lambda: fsparse(*args, shape, 5, method="sharded", mesh=pm)),
        ("format",
         lambda: jax_fsparse(*args, shape, method="sharded", mesh=jm,
                             format="bsr", block=1),
         lambda: fsparse(*args, shape, method="sharded", mesh=pm,
                         format="bsr", block=1)),
        ("accum",
         lambda: jax_fsparse(*args, shape, method="sharded", mesh=jm,
                             accum="max"),
         lambda: fsparse(*args, shape, method="sharded", mesh=pm,
                         accum="max")),
        ("slack",
         lambda: jax_sparse2(*args, shape, method="sharded", mesh=jm,
                             nzmax_slack=3),
         lambda: sparse2(*args, shape, method="sharded", mesh=pm,
                         nzmax_slack=3)),
        ("unused mesh", lambda: jax_fsparse(*args, shape, mesh=jm),
         lambda: fsparse(*args, shape, mesh=pm, device=CPU)),
        ("overflow",
         lambda: jconvert(jconvert(pat_ref.assemble(jnp.asarray(v)), "coo"),
                          "sharded", mesh=jm, capacity_factor=0.1),
         lambda: convert(convert(pat.assemble(torch.from_numpy(v)), "coo"),
                         "sharded", mesh=pm, capacity_factor=0.1)),
        ("batched block", lambda: A_ref.block(0), lambda: A.block(0)),
        ("batched to_dense", A_ref.to_dense, A.to_dense),
        ("batched spmv", lambda: A_ref.spmv(jnp.asarray(x)),
         lambda: A.spmv(torch.from_numpy(x))),
        ("batched convert", lambda: jconvert(A_ref, "coo"),
         lambda: convert(A, "coo")),
        ("unbatched batch_select",
         lambda: pat_ref.assemble(jnp.asarray(v)).batch_select(0),
         lambda: pat.assemble(torch.from_numpy(v)).batch_select(0)),
        ("vals length", lambda: pat_ref.assemble(jnp.asarray(v[:-1])),
         lambda: pat.assemble(torch.from_numpy(v[:-1]))),
        ("batch ndim", lambda: pat_ref.assemble_batch(jnp.asarray(v)),
         lambda: pat.assemble_batch(torch.from_numpy(v))),
        ("no mesh",
         lambda: dataclasses.replace(pat_ref.assemble(jnp.asarray(v)),
                                     mesh=None).spmv(jnp.asarray(x)),
         lambda: dataclasses.replace(pat.assemble(torch.from_numpy(v)),
                                     mesh=None).spmv(torch.from_numpy(x))),
    ]


def test_every_rejection_message_is_the_reference():
    rows, cols, siz = _set(1)
    rows, cols = rows[:3000], cols[:3000]
    shape = (siz, siz)
    pat_ref = jax_plan_sharded(rows, cols, shape, mesh=jax_mesh(1))
    pat = plan_sharded(rows, cols, shape, mesh=mesh1())
    cases = _rejections(rows, cols, shape, pat_ref, pat)
    assert len(cases) == 16
    for name, ref_call, port_call in cases:
        assert _message(port_call) == _message(ref_call), name
    assert plan_cache_info()["size"] == 0  # rejected before any plan


def test_plan_sharded_coo_and_fill_sharded_pallas_are_the_plan_and_fill():
    rows, cols, siz = _set(3)
    v = np.random.default_rng(4).standard_normal(rows.shape[0]) \
        .astype(np.float32)
    coo = convert(fsparse(rows + 1, cols + 1, np.ones(rows.shape[0]),
                          (siz, siz), device=CPU), "coo")
    pat = plan_sharded_coo(coo, mesh=mesh1())
    want = plan_sharded(coo.rows, coo.cols, coo.shape, mesh=mesh1())
    for f in FIELDS:
        assert torch.equal(getattr(pat, f), getattr(want, f)), f
    pat = plan_sharded(rows, cols, (siz, siz), mesh=mesh1())
    K = fill_sharded_pallas(pat, torch.from_numpy(v))
    assert isinstance(K, ShardedCSC)
    assert torch.equal(K.data, pat.assemble(torch.from_numpy(v)).data)


# ---------------------------------------------------------------------------
# the validators: invariant names and messages against the reference's
# ---------------------------------------------------------------------------
def _corrupt(pat, field, fn):
    arr = getattr(pat, field).clone()
    fn(arr)
    return dataclasses.replace(pat, **{field: arr})


def _pattern_corruptions(pat):
    drop = pat.p * pat.capacity
    nzb, rpb = pat.nzb, pat.rpb
    nnz0 = int(pat.nnz[0])

    def set_(idx, val):
        def fn(a):
            a[idx] = val
        return fn

    out = {
        "field-shape": dataclasses.replace(pat, send_slot=pat.send_slot[0]),
        "slot-bounds": _corrupt(pat, "send_slot", set_((0, 0), drop + 5)),
        "perm-permutation": _corrupt(pat, "perm", set_(
            (pat.p - 1, 1), int(pat.perm[pat.p - 1, 0]))),
        "slot-bounds/block": _corrupt(pat, "slot", set_((0, 0), nzb + 3)),
        "nzmax-capacity": _corrupt(pat, "nnz", set_(0, nzb + 1)),
        "indptr-monotone": _corrupt(pat, "indptr", set_((0, 1), -1)),
        "indptr-nnz": _corrupt(pat, "indptr", set_((0, -1), nnz0 + 1)),
        "indices-bounds": _corrupt(pat, "indices", set_((0, 0), rpb + 3)),
        "padding-sentinel": _corrupt(pat, "indices", set_((0, nzb - 1), 0)),
        "sharded-block-consistency/scan": _corrupt(
            pat, "send_base", set_((pat.p - 1, 0), -1)),
    }
    if pat.p > 1:  # one shard's row is always consistent with itself
        out["sharded-block-consistency"] = _corrupt(
            pat, "block_load", set_((pat.p - 1, 0), -7))
    return out


def _matrix_corruptions(A):
    nzb, rpb = A.nzb, A.rows_per_block

    def set_(idx, val):
        def fn(a):
            a[idx] = val
        return fn

    return {
        "field-shape": dataclasses.replace(A, indices=A.indices[0]),
        "field-shape/data": dataclasses.replace(A, data=A.data[:, :-1]),
        "field-shape/indptr": dataclasses.replace(A, indptr=A.indptr[:, :-1]),
        "indptr-monotone": _corrupt(A, "indptr", set_((A.n_blocks - 1, 1),
                                                      -1)),
        "indices-bounds": _corrupt(A, "indices", set_((0, 0), rpb + 3)),
        "padding-sentinel": _corrupt(A, "indices", set_((0, nzb - 1), 0)),
        "stream-sorted": _corrupt(A, "indices", set_((0, 1), int(
            A.indices[0, 0]))),
    }


def _violation(fn, obj, cls):
    with pytest.raises(cls) as err:
        fn(obj)
    return err.value.invariant, str(err.value)


@pytest.mark.parametrize("p", [1, 4])
def test_validators_name_each_corruption_as_the_reference(p):
    """The reference's validators read the port's fields as numpy arrays,
    so both judge the same corrupted structure."""
    rows, cols, siz = _set(2)
    pat = plan_sharded(rows, cols, (siz, siz),
                       mesh=make_data_mesh(p, device=CPU))
    A = pat.assemble(torch.ones(rows.shape[0]))
    assert validate_pattern(pat) is pat and validate_matrix(A) is A
    jax_invariants._validate_sharded_pattern(pat)
    jax_invariants._validate_sharded_csc(A)
    for name, bad in _pattern_corruptions(pat).items():
        got = _violation(validate_pattern, bad, InvariantViolation)
        want = _violation(jax_invariants._validate_sharded_pattern, bad,
                          JaxInvariantViolation)
        assert got == want and got[0] == name.split("/")[0], name
    for name, bad in _matrix_corruptions(A).items():
        got = _violation(validate_matrix, bad, InvariantViolation)
        want = _violation(jax_invariants._validate_sharded_csc, bad,
                          JaxInvariantViolation)
        assert got == want and got[0] == name.split("/")[0], name


# ---------------------------------------------------------------------------
# p = 4 against the reference in one subprocess
# ---------------------------------------------------------------------------
#: the p = 4 cases: (M, N, L, capacity_factor, kind)
CASES = {
    # Table 4.1 set 1 at scale 0.01 (sets 2 and 3 run at p = 1 above)
    "set1": None,
    # every source shard holds copies of every pair: duplicates of one
    # (row, col) arrive at a block from all four shards
    "dups": (16, 16, 4096, 4.0, "tiled"),
    # L % p != 0 and M % p != 0
    "odd": (37, 23, 1001, 2.0, "random"),
    # explicit padding rows (row == M) among the triplets
    "padding": (41, 9, 999, 2.0, "padding"),
    # every row in block 0: the buckets to it overflow
    "overflow": (16, 16, 4096, 0.1, "skewed"),
    # fewer rows and triplets than shards: empty blocks
    "tiny": (3, 2, 2, 2.0, "random"),
}


def _case(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    if name.startswith("set"):
        rows, cols, siz = _set(int(name[-1]))
        M = N = siz
        cf = 2.0
    else:
        M, N, L, cf, kind = CASES[name]
        rows = rng.integers(0, M, L).astype(np.int32)
        cols = rng.integers(0, N, L).astype(np.int32)
        if kind == "tiled":
            rows, cols = np.tile(rows[:64], 64), np.tile(cols[:64], 64)
        elif kind == "padding":
            rows[::7] = M
        elif kind == "skewed":
            rows[:] = 0
    L = rows.shape[0]
    return dict(rows=rows, cols=cols, shape=np.array([M, N]),
                cf=np.array(cf), vals=rng.integers(-9, 10, L)
                .astype(np.float32),
                batch=rng.standard_normal((3, L)).astype(np.float32),
                x=rng.standard_normal(N).astype(np.float32))


_CHILD = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_data_mesh
from repro.sparse import fsparse, plan_sharded

assert len(jax.devices()) == 4, jax.devices()
mesh = make_data_mesh(4)
inp = np.load(sys.argv[1])
out = {}
for name in sorted({k.split("/")[0] for k in inp.files}):
    g = {k.split("/")[1]: inp[k] for k in inp.files
         if k.startswith(name + "/")}
    r, c, v, vb, x = g["rows"], g["cols"], g["vals"], g["batch"], g["x"]
    M, N = (int(t) for t in g["shape"])
    pat = plan_sharded(r, c, (M, N), mesh=mesh, capacity_factor=float(g["cf"]))
    for f in %r:
        out[f"{name}/{f}"] = np.asarray(getattr(pat, f))
    out[f"{name}/capacity"] = np.array(pat.capacity)

    def loss(w):
        A = pat.assemble(w)
        y = A.spmv(jnp.asarray(x))
        return jnp.sum(y ** 2), (A.data, y)

    (_, (data, y)), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(v))
    out[f"{name}/data"], out[f"{name}/spmv"] = np.asarray(data), np.asarray(y)
    out[f"{name}/grad"] = np.asarray(g)
    w = np.linspace(-1, 1, 3 * pat.nzb, dtype=np.float32).reshape(3, -1)

    def batch_loss(u):
        data = pat.assemble_batch(u).data
        return jnp.sum(data * w[None]), data

    (_, data), g = jax.value_and_grad(batch_loss, has_aux=True)(
        jnp.asarray(vb))
    out[f"{name}/batch_data"] = np.asarray(data)
    out[f"{name}/batch_grad"] = np.asarray(g)
    if bool(pat.any_overflow()):
        try:
            fsparse(r + 1, c + 1, v, (M, N), method="sharded", mesh=mesh)
        except ValueError as e:
            out[f"{name}/fsparse_error"] = np.array(str(e))
np.savez(sys.argv[2], **out)
print("child-ok")
""" % (FIELDS,)


@pytest.fixture(scope="module")
def four_shards(tmp_path_factory):
    """The reference's arrays for every case at p = 4, from one child
    process that sees four forced host devices."""
    tmp = tmp_path_factory.mktemp("sharded4")
    inp = {f"{n}/{k}": a for n in CASES for k, a in _case(n).items()}
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n" \
        f"{out.stderr}"
    got = np.load(tmp / "out.npz")
    return {k: got[k] for k in got.files}


def _ref(four, name):
    return {k.split("/")[1]: a for k, a in four.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_shards_match_reference(four_shards, name):
    ref = _ref(four_shards, name)
    case = _case(name)
    M, N = (int(t) for t in case["shape"])
    mesh = make_data_mesh(4, device=CPU)
    pat = plan_sharded(case["rows"], case["cols"], (M, N), mesh=mesh,
                       capacity_factor=float(case["cf"]))
    assert pat.p == 4 and pat.capacity == int(ref["capacity"])
    _assert_fields(pat, ref, name)
    v = torch.from_numpy(case["vals"])
    A = pat.assemble(v)
    np.testing.assert_array_equal(A.data.numpy(), ref["data"])
    if not bool(pat.any_overflow()):  # an overflow drops triplets
        keep = case["rows"] < M
        dense = np.zeros((M, N), np.float64)
        np.add.at(dense, (case["rows"][keep], case["cols"][keep]),
                  case["vals"][keep])
        np.testing.assert_array_equal(A.to_dense().numpy(), dense)
    x = case["x"]
    bound = np.abs(A.to_dense().numpy()) @ np.abs(x)
    y = A.spmv(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(y - ref["spmv"]) <= 8 * EPS32 * bound + 1e-30)
    vb = torch.from_numpy(case["batch"])
    Ab = pat.assemble_batch(vb)
    mag = pat.assemble_batch(vb.abs()).data.numpy()
    _within_seg_tol(Ab.data.numpy(), ref["batch_data"], mag)
    vt = v.clone().requires_grad_()
    (pat.assemble(vt).spmv(torch.from_numpy(x)) ** 2).sum().backward()
    np.testing.assert_allclose(vt.grad.numpy(), ref["grad"], rtol=1e-5,
                               atol=1e-4)
    w = np.linspace(-1, 1, 3 * pat.nzb, dtype=np.float32).reshape(3, -1)
    vbt = vb.clone().requires_grad_()
    (pat.assemble_batch(vbt).data * torch.from_numpy(w)[None]).sum() \
        .backward()
    np.testing.assert_array_equal(vbt.grad.numpy(), ref["batch_grad"])
    rows, cols = case["rows"], case["cols"]
    if (rows >= M).any():
        return
    args = (rows + 1, cols + 1, case["vals"], (M, N))
    assert bool(pat.any_overflow()) == ("fsparse_error" in ref)
    if "fsparse_error" in ref:
        with pytest.raises(ValueError) as err:
            fsparse(*args, method="sharded", mesh=mesh)
        assert str(err.value) == str(ref["fsparse_error"])
        return
    # the Matlab layout equals the single-device fsparse's (itself held
    # against the reference's); its capacity is L, the converted p * nzb
    C = convert(fsparse(*args, method="sharded", mesh=mesh), "csc")
    F = fsparse(*args, device=CPU)
    nnz = int(F.nnz)
    assert torch.equal(C.indptr, F.indptr) and int(C.nnz) == nnz
    for f in ("data", "indices"):
        assert torch.equal(getattr(C, f)[:nnz], getattr(F, f)[:nnz]), f


def test_four_shards_keep_phase_a_invariants(four_shards):
    """Phase A's scan: shard 0 starts every block's arrivals, the bases
    grow with the source shard and stay within the block's load, and the
    loads sum to L; the blocks' nnz sum to the global nnz."""
    for name in CASES:
        case = _case(name)
        pat = plan_sharded(case["rows"], case["cols"],
                           tuple(int(t) for t in case["shape"]),
                           mesh=make_data_mesh(4, device=CPU),
                           capacity_factor=float(case["cf"]))
        sb, bl = pat.send_base.numpy(), pat.block_load.numpy()
        assert np.all(sb[0] == 0) and np.all(np.diff(sb, axis=0) >= 0)
        assert np.all(sb <= bl)
        M = int(case["shape"][0])
        assert int(bl[0].sum()) == int((case["rows"] < M).sum())
        assert int(pat.nnz_total()) == int(four_shards[f"{name}/nnz"].sum())


# ---------------------------------------------------------------------------
# what only the port has: meshes, the plan cache key, the service
# ---------------------------------------------------------------------------
def test_data_mesh_helpers():
    m4 = make_data_mesh(4, device=CPU)
    assert isinstance(m4, Mesh) and m4.shape == {"data": 4}
    assert m4.axis_names == ("data",)
    assert m4.device == torch.device(CPU) and len(m4.devices) == 4
    assert make_data_mesh(4, device=CPU) is m4  # memoised
    assert make_data_mesh(4, device=torch.device(CPU)) == m4
    assert hash(make_data_mesh(4, device=torch.device(CPU))) == hash(m4)
    assert make_data_mesh(device=CPU).shape == {"data": 1}
    assert resolve_mesh(m4) is m4
    assert resolve_mesh(device=CPU, axis="rows").shape == {"rows": 1}
    assert mesh_fingerprint(m4, "data") == (("data",), (4,),
                                            (None,) * 4, "data")
    with pytest.raises(ValueError, match="n >= 1"):
        make_data_mesh(0, device=CPU)
    with pytest.raises(NotImplementedError, match="item 14"):
        Mesh(("data",), (2,), (torch.device("cuda", 0),
                               torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="needs 2 shard devices"):
        Mesh(("data",), (2,), (torch.device(CPU),))


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make_data_mesh.cache_clear()
    try:
        for call in (lambda: make_data_mesh(),
                     lambda: make_data_mesh(4),
                     lambda: fsparse([1], [1], [1.0], method="sharded")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    finally:
        make_data_mesh.cache_clear()


def test_numpy_rows_default_to_the_card_and_tensors_to_their_device(
        monkeypatch):
    rows, cols = np.array([0, 1], np.int32), np.array([1, 0], np.int32)
    pat = plan_sharded(torch.from_numpy(rows), torch.from_numpy(cols),
                       (2, 2))
    assert pat.mesh == make_data_mesh(device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make_data_mesh.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_sharded(rows, cols, (2, 2))
    finally:
        make_data_mesh.cache_clear()


def test_a_sharded_request_runs_on_its_mesh_device():
    args = ([1, 2], [1, 2], [1.0, 2.0], (2, 2))
    S = fsparse(*args, method="sharded", mesh=make_data_mesh(2, device=CPU))
    assert S.data.device.type == "cpu" and S.n_blocks == 2
    assert fsparse(*args, method="sharded", device=CPU).n_blocks == 1
    with pytest.raises(ValueError, match="differs from the mesh's device"):
        fsparse(*args, method="sharded",
                mesh=make_data_mesh(2, device=CPU), device="meta")


def test_sparse2_keys_sharded_plans_by_mesh():
    rows, cols, siz = _set(1)
    args = (rows + 1, cols + 1)
    vals = np.random.default_rng(5).integers(-9, 10, rows.shape[0]) * 1.0
    m4, m2 = make_data_mesh(4, device=CPU), make_data_mesh(2, device=CPU)
    S1 = sparse2(*args, vals, (siz, siz), method="sharded", mesh=m4)
    S2 = sparse2(*args, 2 * vals, (siz, siz), method="sharded", mesh=m4)
    info = plan_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (1, 1, 1)
    np.testing.assert_array_equal(S2.data.numpy(), 2 * S1.data.numpy())
    S3 = sparse2(*args, vals, (siz, siz), method="sharded", mesh=m2)
    assert plan_cache_info()["misses"] == 2 and S3.n_blocks == 2
    np.testing.assert_array_equal(S3.to_dense().numpy(),
                                  S1.to_dense().numpy())
    k4 = plan_lookup(*args, vals, (siz, siz), method="sharded", mesh=m4)[0]
    k2 = plan_lookup(*args, vals, (siz, siz), method="sharded", mesh=m2)[0]
    assert k4[-1] == ("sum", None, 1) + mesh_fingerprint(m4, "data")
    assert k4 != k2 and plan_cache_info()["misses"] == 2
    # the reference keys a sharded request the same way, on its own mesh
    R = jax_sparse2(*args, vals, (siz, siz), method="sharded",
                    mesh=jax_mesh(1))
    np.testing.assert_array_equal(S1.to_dense().numpy(),
                                  np.asarray(R.to_dense()))


def test_plan_service_serves_sharded_requests_uncaptured(tmp_path):
    rows, cols, siz = _set(3)
    args = (rows + 1, cols + 1)
    vals = np.random.default_rng(6).integers(-9, 10, rows.shape[0]) * 1.0
    svc = PlanService(device=CPU, cache_dir=tmp_path)
    A = svc.assemble(*args, vals, (siz, siz), method="sharded")
    B = fsparse(*args, vals, (siz, siz), method="sharded", device=CPU)
    assert isinstance(A, ShardedCSC) and torch.equal(A.data, B.data)
    out = svc.assemble_many([(*args, vals, (siz, siz)),
                             (*args, 3 * vals, (siz, siz))],
                            method="sharded")
    assert torch.equal(out[0].data, A.data)
    assert torch.equal(out[1].data, 3 * A.data)
    stats = svc.stats()
    assert stats["graphs"] == {"captures": {}, "replays": {}}
    assert stats["persisted"] == 0 and not list(tmp_path.glob("plan*"))
    assert plan_cache_info()["misses"] == 1


def test_operators_over_the_sharded_format():
    rows, cols, siz = _set(1)
    vals = np.random.default_rng(7).integers(-9, 10, rows.shape[0]) * 1.0
    mesh = make_data_mesh(3, device=CPU)
    S = fsparse(rows + 1, cols + 1, vals, (siz, siz), method="sharded",
                mesh=mesh)
    dense = S.to_dense()
    assert ops.to_dense(S).equal(dense)
    assert ops.transpose(S).to_dense().equal(dense.T)
    assert ops.diagonal(S).equal(torch.diagonal(dense))
    twice = ops.add(S, S)
    assert isinstance(twice, ShardedCSC) and twice.mesh == mesh
    assert twice.to_dense().equal(2 * dense)
    assert ops.scale(S, 3.0).to_dense().equal(3 * dense)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(siz)
                         .astype(np.float32))
    assert ops.matmul(S, x).equal(S.spmv(x))
    i, j, v = find(convert(S, "csc"))
    fi, fj, fv = find(fsparse(rows + 1, cols + 1, vals, (siz, siz),
                              device=CPU))
    for a, b in ((i, fi), (j, fj), (v, fv)):
        np.testing.assert_array_equal(a, b)
    back = convert(convert(S, "csc"), "sharded", mesh=mesh)
    assert back.to_dense().equal(dense)
