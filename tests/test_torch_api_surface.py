"""The port's public surface against the JAX package's.

Every name in ``__all__`` of ``repro.core``, ``repro.sparse`` and
``repro.kernels``, every public method of their public classes, and the
oracle's functions must exist in the port under the same name, unless
it is on the commented list of deliberate absences below.  A name on
that list must still be absent, so the list stays true as the port
grows.  Beside the walk: ``A @ x`` on a port ``CSC``, ``len`` of a
``COO``, the one-shot ``assemble``, the aliases of the renamed kernel
entry points and the oracle's copies, each against the reference.
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.oracle as jax_oracle
from repro.core.coo import coo_from_matlab as jax_coo_from_matlab
from repro.sparse import assemble as jax_assemble
from repro.sparse.matlab import fsparse as jax_fsparse
from repro_torch.core import oracle
from repro_torch.core.coo import coo_from_matlab
from repro_torch.sparse import assemble, fsparse

torch.set_num_threads(1)

#: names of the reference the port leaves out on purpose, with the
#: reason (ROADMAP.md queue A numbers where the module is still to port)
ABSENT = {
    # the Pallas interpret switch: the port has no interpret mode
    "INTERPRET",
    # B3', B6 and B4 return segment results, not prefix scans: the
    # reference's names would change meaning
    "gather_masked_cumsum", "gather2_masked_cumsum", "gather_masked_segscan",
}
PACKAGES = ("core", "sparse", "kernels")
#: special methods a caller reaches through an operator or a builtin
DUNDERS = ("__matmul__", "__len__", "__call__", "__getitem__", "__iter__")


def _public_names(pkg: str):
    return list(importlib.import_module(f"repro.{pkg}").__all__)


def _methods(cls):
    """Public methods and properties of ``cls`` (and the dunders above
    that it defines itself)."""
    return sorted(m for m in dir(cls)
                  if not m.startswith("_")
                  or (m in DUNDERS and m in vars(cls)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_public_name_of_the_reference_is_in_the_port(pkg):
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = [n for n in _public_names(pkg)
               if n not in ABSENT and not hasattr(port, n)]
    assert missing == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_public_method_of_the_reference_classes_is_in_the_port(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = []
    for name in _public_names(pkg):
        cls = getattr(ref, name)
        if not inspect.isclass(cls) or name in ABSENT:
            continue
        for m in _methods(cls):
            if f"{name}.{m}" not in ABSENT and not hasattr(
                    getattr(port, name), m):
                missing.append(f"{name}.{m}")
    assert missing == []


def test_the_deliberate_absences_are_still_absent():
    """A name the port gained comes off ``ABSENT``."""
    present = []
    for pkg in PACKAGES:
        port = importlib.import_module(f"repro_torch.{pkg}")
        for name in _public_names(pkg):
            if name in ABSENT and hasattr(port, name):
                present.append(name)
    for dotted in (a for a in ABSENT if "." in a):
        cls, m = dotted.split(".")
        if hasattr(getattr(importlib.import_module("repro_torch.sparse"),
                           cls), m):
            present.append(dotted)
    assert present == []


def test_the_oracle_copy_has_every_oracle_function():
    names = [n for n, f in vars(jax_oracle).items()
             if inspect.isfunction(f) and not n.startswith("_")]
    assert sorted(n for n in names if not hasattr(oracle, n)) == []


def _triplets(seed, L=400, M=23, N=17):
    rng = np.random.default_rng(seed)
    ii = rng.integers(1, M + 1, L)
    jj = rng.integers(1, N + 1, L)
    ss = rng.integers(-4, 5, L).astype(np.float64)
    return ii, jj, ss, M, N


@pytest.mark.parametrize("seed", [0, 1])
def test_csc_matmul_matches_reference(seed):
    ii, jj, ss, M, N = _triplets(seed)
    x = np.random.default_rng(seed + 10).integers(-3, 4, N) \
        .astype(np.float32)
    want = np.asarray(jax_fsparse(ii, jj, ss, (M, N)) @ jnp.asarray(x))
    A = fsparse(ii, jj, ss, (M, N), device="cpu")
    got = A @ torch.from_numpy(x)
    assert got.shape == (M,)
    np.testing.assert_array_equal(got.numpy(), want)  # integer-valued
    X = np.stack([x, 2 * x], axis=1)
    np.testing.assert_array_equal(
        (A @ torch.from_numpy(X)).numpy(),
        np.asarray(jax_fsparse(ii, jj, ss, (M, N)) @ jnp.asarray(X)))


def test_coo_len_and_one_shot_assemble_match_reference():
    ii, jj, ss, M, N = _triplets(3)
    ref = jax_coo_from_matlab(ii, jj, ss, (M, N))
    coo = coo_from_matlab(ii, jj, ss, (M, N), device="cpu")
    assert len(coo) == len(ref) == ii.shape[0]
    A, B = assemble(coo), jax_assemble(ref)
    nnz = int(A.nnz)
    assert nnz == int(B.nnz)
    np.testing.assert_array_equal(A.indptr.numpy(), np.asarray(B.indptr))
    np.testing.assert_array_equal(A.indices[:nnz].numpy(),
                                  np.asarray(B.indices)[:nnz])
    np.testing.assert_array_equal(A.data[:nnz].numpy(),
                                  np.asarray(B.data)[:nnz])


def test_renamed_kernel_entry_points_keep_the_reference_names():
    from repro_torch import kernels

    assert kernels.plan_pallas is kernels.plan_kernels
    assert kernels.assemble_pallas is kernels.assemble_kernels


def test_oracle_copies_match_reference():
    ii, jj, ss, M, N = _triplets(4, L=60, M=9, N=7)
    for got, want in zip(oracle.fsparse_listing15(ii, jj, ss, M, N),
                         jax_oracle.fsparse_listing15(ii, jj, ss, M, N)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        oracle.dense_oracle(ii - 1, jj - 1, ss, M, N),
        jax_oracle.dense_oracle(ii - 1, jj - 1, ss, M, N))
