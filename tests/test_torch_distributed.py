"""The deprecated one-shot factories (``core/distributed.py``).

Counterparts of ``tests/test_distributed.py``'s assembly tests: the
port's ``make_distributed_assemble``/``make_distributed_spmv`` on a mesh
of eight shards on the CPU against the dense oracle, the overflow flag
of a skewed stream, and, on one shard, against the reference's
factories in this process.  The shim is ``plan_sharded`` plus one fill,
so it must also equal that, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import make_distributed_assemble as jax_assemble
from repro.core.distributed import make_distributed_spmv as jax_spmv
from repro.core.oracle import dense_oracle
from repro.launch.mesh import make_data_mesh as jax_mesh
from repro_torch.core import distributed
from repro_torch.core.distributed import (ShardedCSC,
                                          make_distributed_assemble,
                                          make_distributed_spmv)
from repro_torch.launch import make_data_mesh
from repro_torch.sparse import plan_sharded, sharded

torch.set_num_threads(1)


def _triplets(M, N, L, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M, L).astype(np.int32)
    cols = rng.integers(0, N, L).astype(np.int32)
    vals = rng.standard_normal(L).astype(np.float32)
    return rows, cols, vals, rng.standard_normal(N).astype(np.float32)


def test_shim_reexports_the_sharded_format():
    assert ShardedCSC is sharded.ShardedCSC
    assert distributed.__all__ == ["ShardedCSC", "make_distributed_assemble",
                                   "make_distributed_spmv"]


def test_distributed_assembly_matches_oracle():
    M = N = 96
    rows, cols, vals, x = _triplets(M, N, 4096)
    mesh = make_data_mesh(8, device="cpu")
    fn = make_distributed_assemble(mesh, M=M, N=N, capacity_factor=4.0)
    A, ovf = fn(torch.from_numpy(rows), torch.from_numpy(cols),
                torch.from_numpy(vals))
    assert isinstance(A, ShardedCSC) and A.n_blocks == 8 and not bool(ovf)
    ref = dense_oracle(rows, cols, vals, M, N)
    assert np.abs(A.to_dense().numpy() - ref).max() < 1e-4
    pat = plan_sharded(rows, cols, (M, N), mesh=mesh, capacity_factor=4.0)
    assert torch.equal(A.data, pat.assemble(torch.from_numpy(vals)).data)
    spmv = make_distributed_spmv(mesh, M=M, N=N)
    y = spmv(A, torch.from_numpy(x)).numpy()
    assert np.abs(y - ref @ x).max() < 1e-3
    np.testing.assert_array_equal(y, A.spmv(torch.from_numpy(x)).numpy())


def test_distributed_assembly_capacity_overflow_flag():
    M = N = 64
    L = 4096
    rows = np.zeros(L, np.int32)  # every row in block 0
    cols = np.arange(L, dtype=np.int32) % N
    fn = make_distributed_assemble(make_data_mesh(8, device="cpu"), M=M,
                                   N=N, capacity_factor=0.1)
    _, ovf = fn(rows, cols, np.ones(L, np.float32))
    assert bool(ovf), "overflow must be detected"


@pytest.mark.parametrize("cf", [2.0, 0.1])
def test_one_shard_factories_match_reference(cf):
    M, N = 37, 23
    rows, cols, vals, x = _triplets(M, N, 1001, seed=1)
    vals = np.round(vals * 8).astype(np.float32)  # integer-valued: exact
    A, ovf = make_distributed_assemble(
        make_data_mesh(1, device="cpu"), M=M, N=N, capacity_factor=cf)(
        rows, cols, torch.from_numpy(vals))
    R, rovf = jax_assemble(jax_mesh(1), M=M, N=N, capacity_factor=cf)(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals))
    assert bool(ovf) == bool(rovf)
    for f in ("data", "indices", "indptr", "nnz"):
        np.testing.assert_array_equal(getattr(A, f).numpy(),
                                      np.asarray(getattr(R, f)), err_msg=f)
    y = make_distributed_spmv(None, M=M, N=N)(A, torch.from_numpy(x))
    y_ref = jax_spmv(jax_mesh(1), M=M, N=N)(R, jnp.asarray(x))
    bound = np.abs(A.to_dense().numpy()) @ np.abs(x)
    eps = float(np.finfo(np.float32).eps)
    assert np.all(np.abs(y.numpy() - np.asarray(y_ref))
                  <= 8 * eps * bound + 1e-30)
