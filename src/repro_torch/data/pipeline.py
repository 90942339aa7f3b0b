"""Deterministic, checkpointable data pipeline (a copy of
``repro/data/pipeline.py``: numpy only, the same seeding and the same
batches, so that the port imports nothing of the reference package).

Two sources:
  * ``SyntheticLM`` — stateless counter-hash token stream (any step can
    be regenerated from (seed, step) alone: exactly-once semantics under
    restart by construction).
  * ``MemmapCorpus`` — a flat binary token file (np.memmap) chunked into
    sequences; per-host sharding by (host_index, num_hosts); cursor is
    part of the checkpointable state.

Both yield {"tokens": [B, S] int32, "labels": [B, S] int32} with labels
= next-token shift.  A background prefetch thread keeps ``depth``
batches ready (overlap host data prep with device compute).  The
batches are numpy; the launcher moves them to the device.  On a rank
mesh every rank draws the same global batch (a function of the seed and
the step, so no rank waits for another) and keeps its own rows over the
data axes (``launch/sharding.py`` ``place_on_mesh(..., batch=B)``).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    seed: int = 0


class SyntheticLM:
    """Markov-ish synthetic tokens: learnable structure, not pure noise."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 host_index: int = 0, num_hosts: int = 1):
        self.vocab = int(vocab)
        self.batch = int(batch)
        self.seq = int(seq)
        self.state = PipelineState(step=0, seed=seed)
        self.host_index = host_index
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 65_537 + self.host_index
        )
        # order-2 structure: token_t = (a*token_{t-1} + b) % V with noise
        a = rng.integers(3, 23, size=(self.batch, 1))
        b = rng.integers(0, self.vocab, size=(self.batch, 1))
        t0 = rng.integers(0, self.vocab, size=(self.batch, 1))
        toks = [t0]
        for _ in range(self.seq):
            nxt = (a * toks[-1] + b) % self.vocab
            flip = rng.random((self.batch, 1)) < 0.1
            rnd = rng.integers(0, self.vocab, size=(self.batch, 1))
            toks.append(np.where(flip, rnd, nxt))
        arr = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": arr[:, : self.seq], "labels": arr[:, 1 : self.seq + 1]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.state.step)
            self.state.step += 1

    # -- checkpoint interface
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState(**d)


class MemmapCorpus:
    """Flat uint16/uint32 token file -> [B, S] batches, host-sharded."""

    def __init__(self, path: str, vocab: int, batch: int, seq: int,
                 dtype=np.uint16, host_index: int = 0, num_hosts: int = 1):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.host_index = host_index
        self.num_hosts = num_hosts
        n_seq = (len(self.tokens) - 1) // seq
        self.n_batches = n_seq // (batch * num_hosts)
        self.state = PipelineState(step=0)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        step = step % max(self.n_batches, 1)
        base = (step * self.num_hosts + self.host_index) * self.batch
        rows = []
        for b in range(self.batch):
            s = (base + b) * self.seq
            rows.append(np.asarray(self.tokens[s : s + self.seq + 1]))
        arr = np.stack(rows).astype(np.int32) % self.vocab
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        while True:
            yield self.batch_at(self.state.step)
            self.state.step += 1

    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState(**d)


class Prefetcher:
    """Background-thread prefetch of ``depth`` host batches."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        for item in self.source:
            if self._stop.is_set():
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
