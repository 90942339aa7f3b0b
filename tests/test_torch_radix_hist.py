"""B1 (``digit_block_histogram``) on skewed streams, and its launch shape.

On the CPU the wrapper runs its plain version
(``digit_block_histogram_ref``); the reference runs its Pallas kernel in
interpret mode.  The streams are ``chip_smoke.hist_stream``'s, made with
numpy from a seed: every key equal, one digit only, sorted and reversed
keys, runs of 32 equal digits across the lanes' loads and the tiles'
edges, digits ``>= nbins``; at ``L`` of 1, ``TILE +- 1`` and ``G TILE
+- 1`` (G: the run of tiles a CUDA block walks at the paper's 2.5e6 on a
132-SM card).  Everything is integer, so every comparison is exact.
"""
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.radix_sort.radix_sort import \
    digit_block_histogram as jax_digit_block_histogram
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.radix_sort import radix_sort as rs, ref
from repro_torch.sparse import tuning
from repro_torch.sparse.analysis.vmem import declared_rows

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # chip_smoke.py at the repo root
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

#: B1's run at L = 2.5e6 on a 132-SM card (2 tiles a block)
RUN = ref.hist_runs(cdiv(2_500_000, rs.TILE), 132, rs.HIST_PER_SM)[0]
LENGTHS = (1, rs.TILE - 1, rs.TILE + 1, RUN * rs.TILE - 1,
           RUN * rs.TILE + 1)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("kind", chip_smoke.HIST_KINDS)
def test_digit_histogram_matches_reference_on_skewed_streams(kind, L):
    keys, kw = chip_smoke.hist_stream(kind, L, np.random.default_rng(L))
    want = np.asarray(jax_digit_block_histogram(
        jnp.asarray(keys), block_b=rs.TILE, **kw))[:, :kw["nbins"]]
    got = rs.digit_block_histogram(torch.from_numpy(keys), **kw)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (kw["nbins"], cdiv(L, rs.TILE))
    np.testing.assert_array_equal(got.numpy().T, want)  # digit-major
    # digits >= nbins count nowhere; every other key once
    d = (keys >> kw["shift"]) & ((1 << kw["bits"]) - 1)
    assert int(got.sum()) == int((d < kw["nbins"]).sum())


def test_skewed_streams_are_what_they_say():
    rng = np.random.default_rng(5)
    L = 3 * rs.TILE + 77
    digits = {}
    for kind in chip_smoke.HIST_KINDS:
        keys, kw = chip_smoke.hist_stream(kind, L, rng)
        assert keys.dtype == np.int32 and keys.shape == (L,)
        assert keys.min() >= 0
        digits[kind] = (keys >> kw["shift"]) & 255
    assert len(np.unique(chip_smoke.hist_stream("equal", L, rng)[0])) == 1
    assert len(np.unique(digits["one_digit"])) == 1
    assert np.all(np.diff(digits["sorted"]) >= 0)
    assert np.all(np.diff(digits["reversed"]) <= 0)
    # runs of 32 that start 13 keys in: they cross 16 B loads and tiles
    starts = np.flatnonzero(np.diff(digits["runs32"])) + 1
    assert np.all(np.diff(starts) == 32) and starts[0] == 19
    assert (rs.TILE - 19) % 32 != 0
    assert digits["over_nbins"].max() >= 200


@pytest.mark.parametrize("sms", [1, 132, 144])
def test_hist_runs_cover_every_tile_once_in_one_wave(sms):
    """For every nblocks in 1..2^15: block j counts tiles [j run,
    min((j + 1) run, nblocks)), a contiguous run; those runs cover
    0..nblocks - 1 once; no block is empty; the grid is at most one
    resident wave; where there are at least as many tiles as SMs, every
    SM gets a block."""
    per = rs.HIST_PER_SM
    wave = sms * per
    for nblocks in range(1, 2**15 + 1):
        run, grid = ref.hist_runs(nblocks, sms, per)
        assert run >= 1 and 1 <= grid <= wave
        assert (grid - 1) * run < nblocks <= grid * run
        if nblocks >= sms:
            assert grid >= sms
        if nblocks in (1, 611, 612, 12_208, 2**15) or nblocks % 997 == 0:
            tiles = np.concatenate([
                np.arange(j * run, min((j + 1) * run, nblocks))
                for j in range(grid)])
            np.testing.assert_array_equal(tiles, np.arange(nblocks))


def test_hist_runs_at_the_paths_sizes_and_bad_input():
    assert ref.hist_runs(611, 132, 4) == (2, 306)      # L = 2.5e6
    assert ref.hist_runs(12_208, 132, 4) == (24, 509)  # L = 5e7
    for bad in ((0, 132, 4), (611, 0, 4), (611, 132, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            ref.hist_runs(*bad)


@pytest.mark.parametrize("knob,pattern", [
    ("hist_per_sm", r"kHistPerSm = (\d+);"),
    ("hist_chunk", r"kHistChunk = (\d+);"),
])
def test_b1_build_knobs_are_the_sources_values(knob, pattern):
    src = (ROOT / "src/repro_torch/csrc/radix_sort.cu").read_text()
    k = tuning.kernel_spec("radix_sort").knob(knob)
    assert k.build and k.candidates == ()
    assert int(re.search(pattern, src).group(1)) == k.default
    with pytest.raises(ValueError, match="fixed at build time"):
        tuning.get_table().record("radix_sort", {knob: 1}, backend="cuda")


def test_b1_resource_row_declares_its_chunk():
    """The counted chunk [256 + 1][hist_chunk + 1] of int32 (a row for
    the keys that count nowhere); at most 64 registers for four resident
    blocks of 256 threads."""
    row = next(r for r in declared_rows() if r["kernel"] == "B1")
    chunk = tuning.prior_value("radix_sort", "hist_chunk")
    assert row["static_smem"] == 4 * 257 * (chunk + 1) == 17_476
    assert row["min_blocks"] == rs.HIST_PER_SM == 4
    assert row["max_registers"] == 64
    assert row["knobs"]["hist_chunk"] == chunk
