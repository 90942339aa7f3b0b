"""The generators: sizes, the FEM nonzero count, the mesh itself, and
that the same seed gives the same inputs."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, seeding  # noqa: E402
from portbench.generators import fem_p1, ransparse  # noqa: E402
from portbench.reference import csc  # noqa: E402


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_fem_sizes_and_nnz_formula(n):
    cfg = {"n": n, "coef": [0.5, 2.0]}
    rows, cols = fem_p1.pattern(cfg, 7, 0, "cpu")
    assert rows.dtype == cols.dtype == torch.int32
    assert rows.numel() == fem_p1.length(cfg) == 18 * n * n
    M, N = fem_p1.shape(cfg)
    assert int(rows.max()) < M and int(cols.max()) < N
    st = csc.structure(_np(rows), _np(cols), (M, N))
    assert st.nnz == fem_p1.nnz(cfg)


def test_fem_one_cell_is_the_examples_two_triangles():
    cfg = {"n": 1, "coef": [1.0, 1.0 + 1e-7]}
    rows, cols = fem_p1.pattern(cfg, 0, 0, "cpu")
    # v(x, y) = 2 y + x: triangles (0, 1, 2) and (3, 2, 1)
    tri = [(0, 1, 2), (3, 2, 1)]
    want_r = [a for t in tri for a in t for _ in range(3)]
    want_c = [b for t in tri for _ in range(3) for b in t]
    assert _np(rows).tolist() == want_r
    assert _np(cols).tolist() == want_c
    vals = fem_p1.values(cfg, 0, 0, "cpu")
    k = np.array(fem_p1.K, np.float32).ravel()
    np.testing.assert_allclose(_np(vals), np.concatenate([k, k]), rtol=1e-6)


def test_fem_assembled_rows_sum_to_zero():
    cfg = {"n": 4, "coef": [0.5, 2.0]}
    rows, cols = fem_p1.pattern(cfg, 3, 0, "cpu")
    vals = fem_p1.values(cfg, 3, 1, "cpu")
    A = np.zeros(fem_p1.shape(cfg))
    np.add.at(A, (_np(rows), _np(cols)), _np(vals).astype(np.float64))
    np.testing.assert_allclose(A.sum(1), 0, atol=1e-5)
    np.testing.assert_allclose(A, A.T, atol=1e-6)


def test_ransparse_rows_columns_and_sizes():
    cfg = {"siz": 400, "nnz_row": 5, "nrep": 3, "values": [0.5, 2.0]}
    rows, cols = ransparse.pattern(cfg, 11, 0, "cpu")
    L = ransparse.length(cfg)
    assert rows.numel() == cols.numel() == L == 400 * 5 * 3
    counts = np.bincount(_np(rows), minlength=400)
    assert (counts == 15).all()
    assert 0 <= int(cols.min()) and int(cols.max()) < 400
    st = csc.structure(_np(rows), _np(cols), ransparse.shape(cfg))
    assert st.nnz <= 400 * 5
    v = _np(ransparse.values(cfg, 11, 2, "cpu"))
    assert v.dtype == np.float32 and v.min() >= 0.5 and v.max() < 2.0


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**40 + 3])
def test_same_seed_same_inputs(seed):
    cfg = {"siz": 300, "nnz_row": 4, "nrep": 1, "values": [0.5, 2.0]}
    a = ransparse.pattern(cfg, seed, 1, "cpu")
    b = ransparse.pattern(cfg, seed, 1, "cpu")
    c = ransparse.pattern(cfg, seed, 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert torch.equal(ransparse.values(cfg, seed, 3, "cpu"),
                       ransparse.values(cfg, seed, 3, "cpu"))
    assert 0 <= seeding.state(seed, seeding.VALUES, 3) < 2**63


def test_sampled_call_is_in_the_pool_and_follows_the_seed():
    picks = {harness.sampled_call(s, 8) for s in range(64)}
    assert picks <= set(range(8)) and len(picks) > 1
    assert harness.sampled_call(5, 8) == harness.sampled_call(5, 8)


@pytest.mark.parametrize("name", ["fem_p1_1999", "ransparse_set2_1e6"])
def test_config_sizes_match_their_generator(name):
    conf = harness.load_json(ROOT / "portbench" / "configs" / f"{name}.json")
    gen = harness.generator(conf["generator"])
    assert gen.length(conf) == conf["L"]
    assert tuple(gen.shape(conf)) == (conf["M"], conf["N"])
    if hasattr(gen, "nnz"):
        assert gen.nnz(conf) == conf["nnz"]
