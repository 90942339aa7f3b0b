"""The sharded assembly across ranks: one process a shard, ``gloo`` on the CPU.

``tests/test_torch_sharded.py`` holds the port's one-process sharded path
(the p shards a leading tensor axis) against the JAX package's.  Here
the same cases run on a rank mesh: four ``gloo`` ranks, started once
for the module by :func:`repro_torch.launch.ranks.spawn_ranks`, each
planning, filling, multiplying and differentiating its own block and
exchanging with the others through ``torch.distributed``; every rank
writes what it holds to one ``.npz``.  The ranks' arrays, stacked in
rank order, must be the reference's at p = 4 (``four_shards``, a child
with four forced host devices) and the one-process port's: the plan's
integer fields bit for bit, fills bit for bit on integer-valued data and
within ``C_SEG * eps`` of each slot's sum|terms| on random data, the
SpMV within ``8 eps sum_j |a_ij x_j|``, the gradients within float32
rounding of ``jax.grad``.  Every gathered view (``to_dense``, the SpMV's
``y``, ``convert``, ``find``, ``nnz_of``) must be the global answer on
every rank.  Eight ranks run the reference's ``tests/test_distributed.py``
oracle and overflow checks; two ranks show that a failing rank, a hang
and a collective timeout fail the run.
"""
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.oracle import dense_oracle
from repro.launch.mesh import make_data_mesh as jax_mesh
from repro.sparse import sparse2 as jax_sparse2
from repro_torch.launch import make_data_mesh
from repro_torch.launch.ranks import choose_backend, spawn_ranks
from repro_torch.sparse import convert, find, fsparse, nnz_of, plan_sharded
from test_torch_sharded import (CASES, EPS32, FIELDS, _case, _ref,
                                _within_seg_tol)
from test_torch_sharded import four_shards  # noqa: F401 - the fixture

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: a run of ranks that takes longer fails (the four ranks take ~15 s)
RANKS_TIMEOUT_S = 240


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(code: str, world: int, tmp, *args, timeout_s=RANKS_TIMEOUT_S):
    return spawn_ranks([sys.executable, "-c", textwrap.dedent(code),
                        *map(str, args)], world, timeout_s=timeout_s,
                       env=_env(), rendezvous=str(tmp / "rendezvous"))


_CHILD = """
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import (init_ranks, is_rank_mesh,
                                         make_data_mesh, mesh_device)
    from repro_torch.sparse import (convert, find, fsparse, nnz_of,
                                    plan_cache_clear, plan_cache_info,
                                    plan_sharded, sparse2)
    from repro_torch.sparse.sharded import mesh_fingerprint

    info = init_ranks(device="cpu")
    mesh = make_data_mesh()
    r, p = info.rank, info.world
    inp = np.load(sys.argv[1])
    out = {"info/backend": np.array(info.backend),
           "info/device": np.array(str(mesh_device(mesh))),
           "info/rank_mesh": np.array(is_rank_mesh(mesh)),
           "info/fingerprint": np.array(repr(mesh_fingerprint(mesh, "data"))),
           "info/same_mesh": np.array(make_data_mesh(p) is mesh)}
    try:
        make_data_mesh(p + 1)
    except ValueError as e:
        out["info/wrong_n"] = np.array(str(e))
    fields = sys.argv[3].split(",")
    for name in sorted({k.split("/")[0] for k in inp.files}):
        g = {k.split("/")[1]: inp[k] for k in inp.files
             if k.startswith(name + "/")}
        rows, cols, v, vb, x = (g[k] for k in ("rows", "cols", "vals",
                                               "batch", "x"))
        M, N = (int(t) for t in g["shape"])
        cf = float(g["cf"])
        pat = plan_sharded(rows, cols, (M, N), mesh=mesh, capacity_factor=cf)
        o = {f: getattr(pat, f) for f in fields}
        o["capacity"] = torch.tensor(pat.capacity)
        o["p"] = torch.tensor(pat.p)
        o["nnz_total"] = pat.nnz_total()
        o["any_overflow"] = pat.any_overflow()
        A = pat.assemble(torch.from_numpy(v))
        o["data"], o["dense"] = A.data, A.to_dense()
        o["spmv"] = A.spmv(torch.from_numpy(x))
        o["nnz_of"] = torch.tensor(nnz_of(A))
        o["batch_data"] = pat.assemble_batch(torch.from_numpy(vb)).data
        o["batch_mag"] = pat.assemble_batch(
            torch.from_numpy(np.abs(vb))).data
        vt = torch.from_numpy(v).requires_grad_()
        (pat.assemble(vt).spmv(torch.from_numpy(x)) ** 2).sum().backward()
        o["grad"] = vt.grad
        w = np.linspace(-1, 1, 3 * pat.nzb, dtype=np.float32).reshape(3, -1)
        vbt = torch.from_numpy(vb).requires_grad_()
        (pat.assemble_batch(vbt).data * torch.from_numpy(w)[None]).sum() \\
            .backward()
        o["batch_grad"] = vbt.grad
        # the triplets as a Shard(0) DTensor: each rank passes its shard
        from torch.distributed.tensor import Shard, distribute_tensor
        dt = [distribute_tensor(torch.from_numpy(a), mesh, [Shard(0)],
                                src_data_rank=None) for a in (rows, cols, v)]
        q = plan_sharded(dt[0], dt[1], (M, N), mesh=mesh, capacity_factor=cf)
        o["dtensor_same"] = torch.tensor(all(
            torch.equal(getattr(q, f), getattr(pat, f)) for f in fields)
            and torch.equal(q.assemble(dt[2]).data, A.data))
        if not (rows >= M).any():
            args = (rows + 1, cols + 1, v, (M, N))
            try:
                S = fsparse(*args, method="sharded", mesh=mesh)
            except ValueError as e:
                out[f"{name}/fsparse_error"] = np.array(str(e))
            else:
                C = convert(S, "csc")
                o.update(csc_data=C.data, csc_indices=C.indices,
                         csc_indptr=C.indptr, csc_nnz=C.nnz)
                back = convert(convert(S, "coo"), "sharded", mesh=mesh)
                o["roundtrip"] = torch.tensor(
                    back.ranked and torch.equal(back.to_dense(),
                                                S.to_dense()))
                i, j, fv = find(S)
                o.update(find_i=torch.from_numpy(i), find_j=torch.from_numpy(j),
                         find_v=torch.from_numpy(fv))
                plan_cache_clear()
                S1 = sparse2(*args, method="sharded", mesh=mesh)
                S2 = sparse2(rows + 1, cols + 1, 2 * v, (M, N),
                             method="sharded", mesh=mesh)
                ci = plan_cache_info()
                o["sparse2"] = torch.tensor([ci["misses"], ci["hits"],
                                             ci["size"]])
                o["sparse2_same"] = torch.tensor(
                    torch.equal(S1.data, S.data)
                    and torch.equal(S2.data, 2 * S.data))
        for k, t in o.items():
            out[f"{name}/{k}"] = t.detach().numpy()
    np.savez(sys.argv[2] % r, **out)
    dist.barrier()
    print(info.describe())
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every case on a mesh of four ``gloo`` ranks: ``{rank: arrays}``."""
    tmp = tmp_path_factory.mktemp("ranks4")
    inp = {f"{n}/{k}": a for n in CASES for k, a in _case(n).items()}
    np.savez(tmp / "in.npz", **inp)
    res = _spawn(_CHILD, 4, tmp, tmp / "in.npz", tmp / "out%d.npz",
                 ",".join(FIELDS))
    assert [rc for rc, _, _ in res] == [0] * 4
    for r, (_, so, _) in enumerate(res):
        assert so.strip().endswith(f"rank {r} of 4 on cpu (gloo)"), so
    return {r: dict(np.load(tmp / f"out{r}.npz")) for r in range(4)}


def _of(ranks, name, key):
    return [ranks[r][f"{name}/{key}"] for r in sorted(ranks)]


def _one_process(name):
    case = _case(name)
    M, N = (int(t) for t in case["shape"])
    return case, plan_sharded(case["rows"], case["cols"], (M, N),
                              mesh=make_data_mesh(4, device="cpu"),
                              capacity_factor=float(case["cf"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_plans_are_the_reference_and_the_one_process_plan(
        four_ranks, four_shards, name):
    """Each rank's fields are row ``r`` of the reference's sharded
    arrays and of the one-process plan's, bit for bit."""
    ref = _ref(four_shards, name)
    case, pat = _one_process(name)
    for f in FIELDS:
        got = np.concatenate(_of(four_ranks, name, f))
        np.testing.assert_array_equal(got, ref[f], err_msg=f"{name}: {f}")
        np.testing.assert_array_equal(got, getattr(pat, f).numpy(),
                                      err_msg=f"{name}: {f}")
    for r in range(4):
        arrays = {k.split("/")[1]: a for k, a in four_ranks[r].items()
                  if k.startswith(name + "/")}
        assert int(arrays["capacity"]) == int(ref["capacity"])
        assert int(arrays["p"]) == 4
        # the reductions over the shard axis: every rank the global value
        assert int(arrays["nnz_total"]) == int(ref["nnz"].sum())
        assert bool(arrays["any_overflow"]) == bool(ref["overflow"].any())
        assert bool(arrays["dtensor_same"]), f"{name}: DTensor input"


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_fills_spmv_and_gathered_views(four_ranks, four_shards, name):
    ref = _ref(four_shards, name)
    case, pat = _one_process(name)
    M, N = (int(t) for t in case["shape"])
    data = np.concatenate(_of(four_ranks, name, "data"))
    np.testing.assert_array_equal(data, ref["data"])
    A = pat.assemble(torch.from_numpy(case["vals"]))
    np.testing.assert_array_equal(data, A.data.numpy())
    dense = A.to_dense().numpy()
    bound = np.abs(dense) @ np.abs(case["x"])
    for r in range(4):
        np.testing.assert_array_equal(_of(four_ranks, name, "dense")[r],
                                      dense)
        y = _of(four_ranks, name, "spmv")[r]
        assert y.shape == (M,)
        assert np.all(np.abs(y - ref["spmv"]) <= 8 * EPS32 * bound + 1e-30)
        np.testing.assert_array_equal(
            y, A.spmv(torch.from_numpy(case["x"])).numpy())
        assert int(_of(four_ranks, name, "nnz_of")[r]) == nnz_of(A)
    batch = np.concatenate(_of(four_ranks, name, "batch_data"))
    mag = np.concatenate(_of(four_ranks, name, "batch_mag"))
    _within_seg_tol(batch, ref["batch_data"], mag)
    np.testing.assert_array_equal(batch, pat.assemble_batch(
        torch.from_numpy(case["batch"])).data.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_gradients_match_jax_grad(four_ranks, four_shards, name):
    """The fill's VJP across ranks: every rank holds the gradient of the
    global values, ``jax.grad``'s through the reference's custom_vjp."""
    ref = _ref(four_shards, name)
    case, pat = _one_process(name)
    vt = torch.from_numpy(case["vals"]).requires_grad_()
    (pat.assemble(vt).spmv(torch.from_numpy(case["x"])) ** 2).sum() \
        .backward()
    for r in range(4):
        g = _of(four_ranks, name, "grad")[r]
        np.testing.assert_allclose(g, ref["grad"], rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(g, vt.grad.numpy())
        np.testing.assert_array_equal(_of(four_ranks, name, "batch_grad")[r],
                                      ref["batch_grad"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_fsparse_and_sparse2(four_ranks, four_shards, name):
    """``fsparse(method="sharded")`` on the rank mesh: the overflow
    error word for word, else the Matlab layout, ``find`` and ``sparse2``'s
    plan LRU (a miss, then a hit) on every rank; ``coo -> sharded``
    plans the gathered triplets on the ranks again."""
    ref = _ref(four_shards, name)
    case = _case(name)
    M, N = (int(t) for t in case["shape"])
    if (case["rows"] >= M).any():
        return
    args = (case["rows"] + 1, case["cols"] + 1, case["vals"], (M, N))
    for r in range(4):
        got = four_ranks[r]
        assert (f"{name}/fsparse_error" in got) == ("fsparse_error" in ref)
        if "fsparse_error" in ref:
            assert str(got[f"{name}/fsparse_error"]) == \
                str(ref["fsparse_error"])
            continue
        C = convert(fsparse(*args, method="sharded",
                            mesh=make_data_mesh(4, device="cpu")), "csc")
        for f in ("data", "indices", "indptr", "nnz"):
            np.testing.assert_array_equal(got[f"{name}/csc_{f}"],
                                          getattr(C, f).numpy(), err_msg=f)
        for k, want in zip("ijv", find(C)):
            np.testing.assert_array_equal(got[f"{name}/find_{k}"], want)
        assert bool(got[f"{name}/roundtrip"]), "coo -> sharded on ranks"
        np.testing.assert_array_equal(got[f"{name}/sparse2"], [1, 1, 1])
        assert bool(got[f"{name}/sparse2_same"])
    if name == "set1":  # the reference's sparse2 on its own mesh
        R = jax_sparse2(*args, method="sharded", mesh=jax_mesh(1))
        np.testing.assert_array_equal(
            _of(four_ranks, name, "dense")[0], np.asarray(R.to_dense()))


def test_rank_mesh_and_backend(four_ranks):
    for r in range(4):
        info = {k.split("/")[1]: v for k, v in four_ranks[r].items()
                if k.startswith("info/")}
        assert str(info["backend"]) == "gloo"
        assert str(info["device"]) == "cpu"
        assert bool(info["rank_mesh"]) and bool(info["same_mesh"])
        assert str(info["fingerprint"]) == \
            "(('data',), (4,), (0, 1, 2, 3), 'gloo', 'data')"
        assert "a group of 4 ranks meshes 4 shards" in str(info["wrong_n"])
    assert choose_backend("cpu", ranks_on_host=4, cards=0) == "gloo"
    assert choose_backend("cuda", ranks_on_host=4, cards=1) == "gloo"
    assert choose_backend("cuda", ranks_on_host=4, cards=4) == "nccl"
    assert choose_backend("cuda", ranks_on_host=1, cards=8) == "nccl"
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        choose_backend("meta", ranks_on_host=1, cards=0)


# ---------------------------------------------------------------------------
# eight ranks: the reference's tests/test_distributed.py assembly checks
# ---------------------------------------------------------------------------
_EIGHT = """
    import sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.distributed import (make_distributed_assemble,
                                              make_distributed_spmv)
    from repro_torch.launch.mesh import init_ranks, make_host_mesh

    info = init_ranks(device="cpu")
    mesh = make_host_mesh(data=8, model=1)
    inp = np.load(sys.argv[1])
    M = N = 96
    fn = make_distributed_assemble(mesh, M=M, N=N, capacity_factor=4.0)
    A, ovf = fn(inp["rows"], inp["cols"], torch.from_numpy(inp["vals"]))
    y = make_distributed_spmv(mesh, M=M, N=N)(A, torch.from_numpy(inp["x"]))
    skew = make_distributed_assemble(mesh, M=64, N=64, capacity_factor=0.1)
    _, skew_ovf = skew(np.zeros(4096, np.int32),
                       np.arange(4096, dtype=np.int32) % 64,
                       np.ones(4096, np.float32))
    np.savez(sys.argv[2] % info.rank, dense=A.to_dense().numpy(),
             y=y.numpy(), ovf=bool(ovf), skew_ovf=bool(skew_ovf),
             blocks=A.n_blocks, shape=np.array(mesh.shape))
    print(info.describe())
"""


def test_eight_ranks_match_the_oracle_and_flag_overflow(tmp_path):
    M = N = 96
    rng = np.random.default_rng(0)
    L = 4096
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = rng.normal(size=L).astype(np.float32)
    x = rng.normal(size=N).astype(np.float32)
    np.savez(tmp_path / "in.npz", rows=rows, cols=cols, vals=vals, x=x)
    _spawn(_EIGHT, 8, tmp_path, tmp_path / "in.npz", tmp_path / "out%d.npz")
    ref = dense_oracle(rows, cols, vals, M, N)
    for r in range(8):
        got = np.load(tmp_path / f"out{r}.npz")
        assert int(got["blocks"]) == 8 and list(got["shape"]) == [8, 1]
        assert not bool(got["ovf"])
        assert np.abs(got["dense"] - ref).max() < 1e-4
        assert np.abs(got["y"] - ref @ x).max() < 1e-3
        assert bool(got["skew_ovf"]), "overflow must be detected"


# ---------------------------------------------------------------------------
# failures end the run
# ---------------------------------------------------------------------------
_FAILING = """
    import sys, time
    import torch
    import torch.distributed as dist
    from repro_torch.launch.ranks import init_ranks

    info = init_ranks(device="cpu", timeout_s=float(sys.argv[2]))
    what = sys.argv[1]
    if what == "raise" and info.rank == 1:
        raise SystemExit(3)
    if what == "timeout" and info.rank == 1:
        time.sleep(300)
    if what == "hang":
        time.sleep(300)
    dist.all_reduce(torch.ones(1))
"""


@pytest.mark.parametrize("what, message, collective_s, limit_s", [
    ("raise", "rank 1 exited 3", 60, 120),
    ("timeout", "rank 0 exited 1", 10, 120),
    ("hang", "outlasted 10 s", 60, 10),
])
def test_a_failing_rank_fails_the_run(tmp_path, what, message,
                                      collective_s, limit_s):
    """A rank that exits nonzero, a collective that times out (rank 0
    waits 10 s for rank 1, which sleeps) and ranks that outlast their
    limit: the parent stops the others and raises; no rank carries on
    alone.  The first two end long before their limit."""
    with pytest.raises(RuntimeError, match=message) as err:
        _spawn(_FAILING, 2, tmp_path, what, collective_s, timeout_s=limit_s)
    assert "the other ranks were stopped" in str(err.value)
    if what == "timeout":
        assert "rank 1 (exit -9)" in str(err.value)


_REFORMED = """
    import os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_data_mesh
    from repro_torch.launch.ranks import close_ranks, rank_info
    from repro_torch.sparse import plan_cache_info, sparse2

    first = init_ranks(device="cpu")
    m1 = make_data_mesh()
    ij = np.array([1, 2, 3, 4])
    S = sparse2(ij, ij, np.ones(4, np.float32), (4, 4), method="sharded",
                mesh=m1)
    assert plan_cache_info()["size"] == 1
    close_ranks()
    assert rank_info() is None and not dist.is_initialized()
    assert plan_cache_info()["size"] == 0
    os.environ["REPRO_RANKS_FILE"] = sys.argv[1]
    second = init_ranks(device="cpu")
    m2 = make_data_mesh()
    assert second is not first and m2 is not m1
    x = torch.ones(1)
    dist.all_reduce(x, group=m2.get_group("data"))
    assert x.item() == second.world
    S = sparse2(ij, ij, np.ones(4, np.float32), (4, 4), method="sharded",
                mesh=m2)
    assert np.array_equal(S.to_dense().numpy(), np.eye(4))
"""


def test_a_closed_group_is_forgotten(tmp_path):
    """``close_ranks`` ends the group and forgets what was made over it
    (the memoised rank meshes, ``sparse2``'s plans): a second group in the
    same processes meshes and plans over itself."""
    _spawn(_REFORMED, 2, tmp_path, tmp_path / "rendezvous2")


def test_one_process_meshes_are_unchanged():
    """With no group, ``make_data_mesh`` keeps the one-process mesh."""
    mesh = make_data_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4} and len(mesh.devices) == 4
    rows = np.array([0, 1, 2, 3], np.int32)
    pat = plan_sharded(rows, rows, (4, 4), mesh=mesh)
    assert pat.p == 4 and not pat.ranked
    assert np.array_equal(pat.assemble(torch.ones(4)).to_dense().numpy(),
                          np.eye(4))
