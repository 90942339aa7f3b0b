"""The port's data pipeline against the reference's, on the CPU: the
same batches bit for bit from the same seeds, steps and host indices,
for the synthetic stream and for a memory-mapped token file the test
writes."""
import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("host_index", [0, 1])
@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_synthetic_batches_match_reference(seed, host_index):
    kw = dict(vocab=50_304, batch=3, seq=17, seed=seed,
              host_index=host_index, num_hosts=2)
    ref, port = jpipe.SyntheticLM(**kw), tpipe.SyntheticLM(**kw)
    for step in (0, 1, 2, 7, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == np.int32 and got[k].shape == (3, 17)
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["labels"][:, :-1],
                                      got["tokens"][:, 1:])


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "tokens.bin"
    rng.integers(0, 65_535, 1_000, dtype=np.uint16).tofile(path)
    return str(path)


@pytest.mark.parametrize("host_index", [0, 1])
def test_memmap_batches_match_reference_with_wraparound(corpus, host_index):
    kw = dict(vocab=1_000, batch=4, seq=31, host_index=host_index,
              num_hosts=2)
    ref, port = jpipe.MemmapCorpus(corpus, **kw), \
        tpipe.MemmapCorpus(corpus, **kw)
    assert port.n_batches == ref.n_batches == (999 // 31) // 8
    for step in range(2 * port.n_batches + 1):  # wraps around twice
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in got:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(port.batch_at(port.n_batches)["tokens"],
                                  port.batch_at(0)["tokens"])


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_state_dict_resumes_the_stream(source, corpus):
    def make(pkg):
        if source == "synthetic":
            return pkg.SyntheticLM(100, 2, 8, seed=3)
        return pkg.MemmapCorpus(corpus, 1_000, 2, 8)

    port, ref = make(tpipe), make(jpipe)
    it_port, it_ref = iter(port), iter(ref)
    for _ in range(4):
        np.testing.assert_array_equal(next(it_port)["tokens"],
                                      next(it_ref)["tokens"])
    # a generator's position moves when it is resumed: after four
    # batches it reads the fourth's step, in both packages
    state = port.state_dict()
    assert state == ref.state_dict() == {
        "step": 3, "seed": 3 if source == "synthetic" else 0}
    resumed, ref2 = make(tpipe), make(jpipe)
    resumed.load_state_dict(state)
    ref2.load_state_dict(state)
    it_port, it_ref = iter(resumed), iter(ref2)
    for c in range(3):
        a, b = next(it_port), next(it_ref)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(
            a["tokens"], port.batch_at(state["step"] + c)["tokens"])
    assert resumed.state_dict() == ref2.state_dict()


def test_prefetcher_keeps_the_order():
    src = tpipe.SyntheticLM(50, 2, 4, seed=1)
    data = tpipe.Prefetcher(src, depth=2)
    try:
        got = [next(data) for _ in range(6)]
    finally:
        data.close()
    ref = jpipe.SyntheticLM(50, 2, 4, seed=1)
    for step, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], ref.batch_at(step)["tokens"])
        np.testing.assert_array_equal(b["labels"], ref.batch_at(step)["labels"])
    data.thread.join(timeout=10)  # close lets the thread run out
    assert not data.thread.is_alive()


def test_pipeline_state_is_the_reference_dataclass():
    assert tpipe.PipelineState() == tpipe.PipelineState(step=0, seed=0)
    assert [f.name for f in dataclasses.fields(tpipe.PipelineState)] == \
        [f.name for f in dataclasses.fields(jpipe.PipelineState)]
