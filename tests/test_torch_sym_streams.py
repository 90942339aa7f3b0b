"""B9 (the symmetric SpMV's streams) on the streams that break a design
of tiles over the merge of column ends and slots, on the CPU.

The kernel (``csrc/spmv_sym.cu``) cuts the merge of SymCSC's column ends
with its slots into tiles of ``SYM_TILE`` items, sums each column inside
a tile and carries a column that crosses tiles by a look-back.
``chip_smoke.sym_stream`` builds the streams that test it: the arrow
matrix (one column of 2^20 strict-upper entries beside columns of 3, a
bordered system's Lagrange-multiplier column), a column whose first
slot is a tile's last item, runs of empty columns with sentinel rows and
a padded tail, and short columns of as many slots as the arrow matrix.
The card's tests (``test_torch_gpu.py``) hold the kernel against the
plain version on them.  Here: the port's wrapper (its plain version)
against the JAX package's Pallas ``sym_streams`` in interpret mode, its
running sum differenced at ``indptr`` as the reference's ``spmv_sym``
does, bit for bit on integer-valued data; the kernel's route in plain
PyTorch (``sym_streams_tiled_ref``) against the plain version, bit for
bit on integer-valued data, also at small tiles; the streams' own
invariants; and the exact per-column sums the card's tests measure
errors against.
"""
import importlib
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmv_sym.spmv_sym import sym_streams as jax_sym_streams
from repro_torch.core.csc import slot_columns
from repro_torch.kernels.spmv_sym.ref import (SHORT_COLUMN, SYM_TILE,
                                              sym_shape, sym_streams_ref,
                                              sym_streams_tiled_ref)

#: the wrapper module: the subpackage's attribute ``spmv_sym`` is the
#: function, as in the reference
sym = importlib.import_module("repro_torch.kernels.spmv_sym.spmv_sym")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py at the repo root
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

KINDS = ("arrow", "tile_edge", "empty_runs", "short")
#: the arrow matrix's dense column where the JAX package's interpret-mode
#: kernel runs (5 tiles and a bit; the full 2^20 runs on the port alone)
SMALL_DENSE = 5 * SYM_TILE + 3


def _stream(kind, dense=SMALL_DENSE, seed=82):
    rng = np.random.default_rng(seed)
    rows, indptr, M = chip_smoke.sym_stream(kind, SYM_TILE, rng, dense)
    return rng, rows, indptr, M


def _values(rng, nz, M, dtype, ints=True):
    draw = (lambda k: rng.integers(-8, 9, k)) if ints else \
        rng.standard_normal
    return draw(nz).astype(dtype), draw(M).astype(dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_sym_streams_are_strict_upper_csc(kind):
    """Rows ascend inside each column and lie above it (or are the
    sentinel M); indptr runs from 0 within the stream."""
    _, rows, indptr, M = _stream(kind)
    assert indptr[0] == 0 and np.all(np.diff(indptr) >= 0)
    E = int(indptr[-1])
    assert rows.size >= E and np.all(rows[E:] == M)
    col = np.repeat(np.arange(M), np.diff(indptr))
    kept = rows[:E] < M
    assert np.all(rows[:E][kept] < col[kept])
    same = col[1:] == col[:-1]
    r = rows[:E]
    both = same & kept[1:] & kept[:-1]
    assert np.all(r[1:][both] > r[:-1][both])


def test_sym_streams_meet_the_edges_they_name():
    T = SYM_TILE
    _, rows, indptr, M = _stream("arrow", dense=chip_smoke.ARROW_DENSE)
    lengths = np.diff(indptr)
    assert lengths[-1] == chip_smoke.ARROW_DENSE == M - 1
    assert lengths[:-1].max() == 3
    _, rows_s, indptr_s, _ = _stream("short", dense=chip_smoke.ARROW_DENSE)
    assert abs(int(indptr_s[-1]) - int(indptr[-1])) <= 3
    _, rows, indptr, M = _stream("tile_edge")
    lengths = np.diff(indptr)
    c = int(np.argmax(lengths))
    assert lengths[c] == 2 * T + 1
    first_item = int(indptr[c]) + c       # slots and ends before it
    assert first_item % T == T - 1
    _, rows, indptr, M = _stream("empty_runs")
    lengths = np.diff(indptr)
    empty = np.flatnonzero(lengths == 0)
    runs = np.split(empty, np.flatnonzero(np.diff(empty) != 1) + 1)
    assert max(len(r) for r in runs) >= T
    E = int(indptr[-1])
    assert np.sum(rows[:E] == M) >= E // 64 and rows.size - E == 37


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_matches_reference_on_sym_streams(kind, dtype):
    """The port's B9 wrapper (its plain version on the CPU) against the
    JAX package's Pallas kernel in interpret mode, its running sum
    differenced at indptr: up and the column totals bit for bit on
    integer-valued data."""
    rng, rows, indptr, M = _stream(kind)
    data, x = _values(rng, rows.size, M, dtype)
    up, ct = sym.sym_streams(*(torch.from_numpy(a) for a in
                               (rows, data, indptr, x)))
    cols = np.clip(slot_columns(torch.from_numpy(indptr), rows.size).numpy(),
                   0, M - 1)
    jup, cs = jax_sym_streams(jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(data), jnp.asarray(x), M=M,
                              interpret=True)
    csum = np.concatenate([[0], np.asarray(cs)])
    np.testing.assert_array_equal(up.numpy(), np.asarray(jup))
    np.testing.assert_array_equal(ct.numpy(),
                                  csum[indptr[1:]] - csum[indptr[:-1]])


@pytest.mark.parametrize("tile", [SYM_TILE, 256, 7, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_tiled_route_matches_plain_version(kind, tile):
    """B9's route (tiles of the merge, pieces carried across them)
    against the plain version, bit for bit on integer-valued data, at
    the kernel's tile and at small ones."""
    rng, rows, indptr, M = _stream(kind)
    data, x = _values(rng, rows.size, M, np.float32)
    args = [torch.from_numpy(a) for a in (rows, data, indptr, x)]
    for got, want in zip(sym_streams_tiled_ref(*args, tile=tile),
                         sym_streams_ref(*args)):
        assert torch.equal(got, want)


def test_tiled_route_on_the_full_arrow_matrix():
    """The column of 2^20 entries spans 513 tiles: its pieces carried
    across all of them give the plain version's total."""
    rng, rows, indptr, M = _stream("arrow", dense=chip_smoke.ARROW_DENSE)
    data, x = _values(rng, rows.size, M, np.float32)
    args = [torch.from_numpy(a) for a in (rows, data, indptr, x)]
    got, want = sym_streams_tiled_ref(*args), sym_streams_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(indptr[-1] - indptr[-2]) // SYM_TILE >= 512


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["arrow", "tile_edge", "empty_runs"])
def test_sym_err_over_eps_reads_each_column_against_its_terms(kind, dtype):
    """The card's tests hold B9's column totals to C_SEG eps of the exact
    sum of each column's rounded products (``sym_err_over_eps``): the
    plain version passes, a nudged total does not, and the exact sums
    agree with ``math.fsum`` within eps64 of sum|terms|."""
    rng, rows, indptr, M = _stream(kind)
    data, x = _values(rng, rows.size, M, dtype, ints=False)
    args = [torch.from_numpy(a) for a in (rows, data, indptr, x)]
    eps = float(np.finfo(dtype).eps)
    # the terms as the kernel rounds them, and their exact column sums
    col = torch.searchsorted(args[2][1:].long(), torch.arange(rows.size),
                             right=True)
    valid = (col < M) & (args[0] < M)
    terms = torch.where(valid, args[1] * args[3][torch.where(
        valid, args[0], 0).long()], 0)
    want, mag = chip_smoke.exact_segment_sums(
        terms, torch.where(valid, col, -1), M)
    c = int(np.argmax(np.diff(indptr)))
    t = terms[int(indptr[c]):int(indptr[c + 1])].double().numpy()
    assert abs(want[c] - math.fsum(t)) <= np.finfo(np.float64).eps * mag[c]
    # the totals rounded once from the exact sums pass, a nudged one fails
    ct = torch.from_numpy(want).to(args[1].dtype)
    assert chip_smoke.sym_err_over_eps(ct, *args, eps) <= 1
    ct[c] += 4 * chip_smoke.C_SEG * eps * mag[c]
    assert chip_smoke.sym_err_over_eps(ct, *args, eps) > chip_smoke.C_SEG


@pytest.mark.parametrize("M,nz", [(0, 0), (4, 0), (3, 2), (1, 9)])
def test_empty_and_tail_only_streams(M, nz):
    """No columns, no slots, or only a padded tail: the route and the
    wrapper give the plain version's zeros."""
    rows = torch.full((nz,), M, dtype=torch.int32)
    data = torch.ones(nz)
    indptr = torch.zeros(M + 1, dtype=torch.int32)
    x = torch.ones(M)
    want = sym_streams_ref(rows, data, indptr, x)
    for got in (sym.sym_streams(rows, data, indptr, x),
                sym_streams_tiled_ref(rows, data, indptr, x, tile=2)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not want[0].any() and not want[1].any()


def _symmetric_triplets(kind, dense=SMALL_DENSE):
    """The full symmetric structure of a ``sym_stream`` (both halves and
    the diagonal), as triplets a plan takes, and its longest column of
    the strict upper half."""
    _, rows, indptr, M = _stream(kind, dense)
    lengths = np.diff(indptr)
    cols = np.repeat(np.arange(M), lengths)
    r = np.concatenate([rows, cols, np.arange(M)])
    c = np.concatenate([cols, rows, np.arange(M)])
    return (torch.from_numpy(r.astype(np.int32)),
            torch.from_numpy(c.astype(np.int32)), M, int(lengths.max()))


@pytest.mark.parametrize("longest,M,nzmax,shape", [
    (None, 10, 30, "tiles"), (0, 10, 0, "columns"), (1, 10, 10, "columns"),
    (SHORT_COLUMN, 10, 40, "columns"), (SHORT_COLUMN + 1, 10, 40, "tiles"),
    (SHORT_COLUMN, 10, 41, "tiles"), (3, 10**6, 2_984_021, "columns"),
    (13, 10**5, 13 * 10**5, "tiles"), (SMALL_DENSE, 10**4, 3 * 10**4,
                                       "tiles")])
def test_sym_shape_by_longest_column(longest, M, nzmax, shape):
    """B9 takes one thread a column where no column holds more than
    SHORT_COLUMN (32) slots and they average at most SHORT_MEAN (4), the
    tiles otherwise or where the longest column is not known: a 27-point
    stencil's 13 a column take the tiles, the FEM matrix's 3 one thread
    a column."""
    assert sym_shape(longest, M, nzmax) == shape


@pytest.mark.parametrize("build", ["convert", "plan_symmetric", "direct",
                                   "from_arrays", "scale"])
@pytest.mark.parametrize("kind", ["arrow", "short"])
def test_symcsc_carries_its_longest_column(kind, build):
    """Every way of making a SymCSC gives it its own longest column (the
    most strict-upper entries a column holds), which picks B9's shape."""
    from repro_torch.sparse import (convert, from_arrays, ops, plan,
                                    plan_symmetric)
    from repro_torch.sparse.formats import SymCSC

    r, c, M, want = _symmetric_triplets(kind)
    v = torch.ones(r.numel())
    S = convert(plan(r, c, (M, M)).assemble(v), "symcsc")
    if build == "plan_symmetric":
        S = plan_symmetric(r, c, (M, M), device="cpu").assemble(v)
    elif build == "direct":
        S = SymCSC(diag=S.diag, data=S.data, indices=S.indices,
                   indptr=S.indptr, nnz=S.nnz, shape=S.shape)
    elif build == "from_arrays":
        S = from_arrays("symcsc", {k: getattr(S, k).numpy() for k in (
            "diag", "data", "indices", "indptr", "nnz")}, S.shape,
            device="cpu")
    elif build == "scale":
        S = ops.scale(S, 2.0)
    assert S.longest == want
    assert sym_shape(S.longest, S.M, S.nzmax) == (
        "tiles" if kind == "arrow" else "columns")


def test_two_symcsc_of_one_size_keep_their_own_longest_column():
    """Two SymCSC of one size built one after the other, the first with a
    long column, then a third like the first once the others are freed:
    each keeps its own longest column (nothing is looked up by storage),
    and the SpMV of each matches its dense product."""
    from repro_torch.sparse import convert, ops, plan

    ra, ca, M, long_a = _symmetric_triplets("arrow")
    rs, cs, _, _ = _symmetric_triplets("short")
    keep = (rs < M) & (cs < M)  # the short stream cut to the same size
    rs, cs = rs[keep], cs[keep]
    x = torch.from_numpy(np.random.default_rng(7).integers(
        -4, 5, M).astype(np.float32))
    got = []
    for r, c in ((ra, ca), (rs, cs), (ra, ca)):
        A = plan(r, c, (M, M)).assemble(torch.ones(r.numel()))
        S = convert(A, "symcsc")
        assert S.longest == int(torch.diff(S.indptr).max())
        assert torch.equal(ops.matmul(S, x), A.to_dense() @ x)
        got.append(S.longest)
        del A, S
    assert got[0] == got[2] == long_a and got[1] <= 3
