"""Parts 3-4 of the plan (``kernels/pattern_build``) on its edge cases.

On the CPU: the plain version against the JAX package's
``pattern_from_perm`` / ``pattern_from_sorted``, every field bit for bit.  On the card (the ``gpu`` cases, which skip inside
the test without CUDA): the kernel, both entries, against the plain
version bit for bit, on the same cases and on streams of many tiles.
The module imports nothing of JAX at its top, so the card runs

    python -m pytest -q -m gpu tests/test_torch_pattern_build.py
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import PARTS34_CASES, parts34_case  # noqa: E402
from repro_torch.kernels.pattern_build import ops
from repro_torch.kernels.pattern_build.ref import pattern_fields_ref
from repro_torch.sparse.pattern import pattern_from_perm, pattern_from_sorted

torch.set_num_threads(1)

FIELDS = ("perm", "slot", "indices", "indptr", "nnz", "srows", "scols")
KEYS = ("slot", "indices", "indptr", "nnz", "srows", "scols")


def _case(kind, device="cpu", **kw):
    rows, cols, perm, M, N, nzmax = parts34_case(kind, **kw)
    t = [torch.from_numpy(a).to(device) for a in (rows, cols, perm)]
    return (*t, dict(M=M, N=N, nzmax=nzmax))


def _assert_same(got: dict, want: dict, fields=KEYS):
    for f in fields:
        g, w = got[f], want[f]
        assert g.dtype == torch.int32, f
        assert torch.equal(g.cpu(), w.cpu()), f


def _jax_fields(rows, cols, perm, sizes, sorted_entry: bool) -> dict:
    import jax.numpy as jnp
    from repro.sparse import pattern as jax_pattern

    r, c, p = (jnp.asarray(x.numpy()) for x in (rows, cols, perm))
    if sorted_entry:
        pat = jax_pattern.pattern_from_sorted(r[p], c[p], p, **sizes)
    else:
        pat = jax_pattern.pattern_from_perm(r, c, p, **sizes)
    return {f: torch.from_numpy(np.asarray(getattr(pat, f)))
            for f in FIELDS}


@pytest.mark.parametrize("sorted_entry", [False, True])
@pytest.mark.parametrize("kind", PARTS34_CASES)
def test_plain_matches_reference(kind, sorted_entry):
    rows, cols, perm, sizes = _case(kind)
    if sorted_entry:
        pat = pattern_from_sorted(rows[perm.long()], cols[perm.long()], perm,
                                  **sizes)
    else:
        pat = pattern_from_perm(rows, cols, perm, **sizes)
    want = _jax_fields(rows, cols, perm, sizes, sorted_entry)
    _assert_same({f: getattr(pat, f) for f in FIELDS}, want, FIELDS)


#: columns outside [0, N): the pointers are searchsorted's answers
OFF_RANGE = [
    ("negative_and_past_last", [5, 2, 7, 1, 0, 3], [-2, -1, 0, 3, 4, 4]),
    ("all_below_zero", [1, 2, 3], [-3, -3, -1]),
    ("all_past_last", [1, 2, 3], [4, 4, 6]),
]


def _off_range(r, c, device="cpu"):
    rows, cols = (torch.tensor(x, dtype=torch.int32, device=device)
                  for x in (r, c))
    perm = torch.arange(len(r), dtype=torch.int32, device=device)
    return rows, cols, perm, dict(M=8, N=4, nzmax=5)


@pytest.mark.parametrize("name,r,c", OFF_RANGE)
def test_plain_matches_reference_off_range_columns(name, r, c):
    rows, cols, perm, sizes = _off_range(r, c)
    pat = pattern_from_perm(rows, cols, perm, **sizes)
    want = _jax_fields(rows, cols, perm, sizes, False)
    _assert_same({f: getattr(pat, f) for f in FIELDS}, want, FIELDS)


def test_cpu_entries_launch_nothing():
    before = ops.pattern_build.launches
    rows, cols, perm, sizes = _case("padding")
    ops.pattern_build(rows, cols, perm, **sizes)
    ops.pattern_build_sorted(rows[perm.long()], cols[perm.long()], **sizes)
    assert ops.pattern_build.launches == before
    assert ops.path(rows.device) == "plain"


@pytest.mark.parametrize("entry", ["pattern_build_kernel",
                                   "pattern_build_sorted_kernel"])
def test_kernel_wrapper_refuses_cpu_tensors(entry):
    rows, cols, perm, sizes = _case("padding")
    args = (rows, cols, perm) if entry == "pattern_build_kernel" \
        else (rows, cols)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        getattr(ops, entry)(*args, **sizes)


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_fake_and_meta_tensors_trace_through(device):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode() if device == "cuda" else contextlib.nullcontext()
    with mode:
        rows = torch.empty(100, dtype=torch.int32, device=device)
        out = ops.pattern_build(rows, rows, rows, M=7, N=5, nzmax=90)
        assert {k: tuple(t.shape) for k, t in out.items()} == {
            "slot": (100,), "indices": (90,), "indptr": (6,), "nnz": (),
            "srows": (100,), "scols": (100,)}
        out = ops.pattern_build_sorted(rows, rows, M=7, N=5, nzmax=9)
        assert tuple(out["indices"].shape) == (9,)
        assert out["srows"] is rows


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _check_on_card(rows, cols, perm, sizes):
    """Both entries against the plain version, and once more on inputs
    that are not 16 B aligned (the kernel's scalar loads)."""
    r_s, c_s = rows[perm.long()], cols[perm.long()]
    want = pattern_fields_ref(r_s, c_s, **sizes)
    before = ops.pattern_build.launches
    _assert_same(ops.pattern_build(rows, cols, perm, **sizes), want)
    _assert_same(ops.pattern_build_sorted(r_s, c_s, **sizes), want)
    shifted = [torch.cat([x[:1], x])[1:] for x in (rows, cols, perm)]
    assert shifted[0].data_ptr() % 16
    _assert_same(ops.pattern_build(*shifted, **sizes), want)
    _assert_same(ops.pattern_build_sorted(
        *[torch.cat([x[:1], x])[1:] for x in (r_s, c_s)], **sizes), want)
    assert ops.pattern_build.launches == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("kind", PARTS34_CASES)
def test_kernel_matches_plain(kind):
    dev = _cuda()
    _check_on_card(*_case(kind, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("name,r,c", OFF_RANGE)
def test_kernel_matches_plain_off_range_columns(name, r, c):
    _check_on_card(*_off_range(r, c, device=_cuda()))


#: streams of many tiles: (L, M, N, whether K0 makes pairs)
TILED = [
    (2048 * 37 + 5, 3000, 3000, False),  # many tiles, no multiple of one
    (2048 * 4, 50, 40, False),           # whole tiles, runs across them
    (2048 * 997 + 1023, 1 << 20, 1 << 20, True),  # nearly unique
    (4_000_003, 1 << 21, 1 << 21, True),
    (300_001, 50_000, 1, False),         # one column
]


def _tiled(L, M, N, device="cpu"):
    kind = "one_column" if N == 1 else "padding"
    return _case(kind, device=device, L=L, M=M, N=N, seed=L)


@pytest.mark.parametrize("L,M,N,pairs", TILED)
def test_plain_matches_reference_across_tiles(L, M, N, pairs):
    rows, cols, perm, sizes = _tiled(L, M, N)
    pat = pattern_from_perm(rows, cols, perm, **sizes)
    want = _jax_fields(rows, cols, perm, sizes, False)
    _assert_same({f: getattr(pat, f) for f in FIELDS}, want, FIELDS)


@pytest.mark.gpu
@pytest.mark.parametrize("L,M,N,pairs", TILED)
def test_kernel_matches_plain_across_tiles(L, M, N, pairs):
    dev = _cuda()
    rows, cols, perm, sizes = _tiled(L, M, N, device=dev)
    assert int(ops.pattern_build_kernel(rows, cols, perm,
                                        **sizes)["pairs"]) == pairs
    _check_on_card(rows, cols, perm, sizes)
    # nzmax cut inside the uniques, and past L
    for nzmax in (L // 3, L + 4097):
        _check_on_card(rows, cols, perm, {**sizes, "nzmax": nzmax})


@pytest.mark.gpu
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("L,M,N,chosen", TILED)
def test_both_gathers_give_the_same_outputs(L, M, N, chosen, pairs):
    """K0's choice imposed either way: the same outputs, bit for bit."""
    dev = _cuda()
    rows, cols, perm, sizes = _tiled(L, M, N, device=dev)
    want = pattern_fields_ref(rows[perm.long()], cols[perm.long()], **sizes)
    for args in ((rows, cols, perm),
                 [torch.cat([x[:1], x])[1:] for x in (rows, cols, perm)]):
        got = ops.pattern_build_kernel(*args, **sizes, pairs=pairs)
        assert int(got["pairs"]) == pairs
        _assert_same(got, want)


#: ``wide_gaps`` streams of one tile and of several: (L, seed)
WIDE_GAPS = [(3000, 1), (2048 * 3 + 17, 2)]


def _wide_gaps(L, seed, device):
    return _case("wide_gaps", device=device, L=L, seed=seed)


@pytest.mark.parametrize("L,seed", WIDE_GAPS)
def test_plain_matches_reference_on_wide_gaps(L, seed):
    rows, cols, perm, sizes = _wide_gaps(L, seed, "cpu")
    pat = pattern_from_perm(rows, cols, perm, **sizes)
    want = _jax_fields(rows, cols, perm, sizes, False)
    _assert_same({f: getattr(pat, f) for f in FIELDS}, want, FIELDS)


@pytest.mark.gpu
@pytest.mark.parametrize("L,seed", WIDE_GAPS)
def test_kernel_matches_plain_on_wide_gaps(L, seed):
    _check_on_card(*_wide_gaps(L, seed, _cuda()))


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_arguments():
    dev = _cuda()
    rows, cols, perm, sizes = _case("padding", device=dev)
    op = ops.pattern_build_kernel
    with pytest.raises(TypeError, match="dtype"):
        op(rows.long(), cols, perm, **sizes)
    with pytest.raises(ValueError, match="contiguous"):
        op(torch.stack([rows, rows], 1)[:, 0], cols, perm, **sizes)
    with pytest.raises(ValueError, match="length"):
        op(rows[:-1], cols, perm, **sizes)
    with pytest.raises(ValueError, match="CUDA tensor"):
        op(rows, cols.cpu(), perm, **sizes)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.pattern_build_sorted_kernel(rows, cols.cpu(), **sizes)
    with pytest.raises(ValueError, match="nzmax"):
        op(rows, cols, perm, **{**sizes, "nzmax": -1})


@pytest.mark.gpu
def test_kernel_captures_into_a_cuda_graph():
    dev = _cuda()
    rows, cols, perm, sizes = _case("padding", device=dev, L=50_000,
                                    M=3000, N=3000)
    want = pattern_fields_ref(rows[perm.long()], cols[perm.long()], **sizes)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.pattern_build(rows, cols, perm, **sizes)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = ops.pattern_build(rows, cols, perm, **sizes)
    g.replay()
    torch.cuda.synchronize()
    _assert_same(got, want)
