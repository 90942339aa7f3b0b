"""Triplets to a finished CSC: the paper's operation, one call a request.

Call ``k`` is ``fsparse_coo(COO(rows, cols, vals, shape))`` with the
port's defaults, with value vector ``k % pool`` of the pool.  Its
indices depend on the configuration's generator:

* a mesh (``SHARED_PATTERN``): the one pattern of the mesh, every call;
* a random pattern: base pattern ``p = k % pool`` of the pool with its
  columns shifted, ``(cols_p + off_k) mod N``, where ``off_k = (o + k s)
  mod N`` with ``o`` and ``s`` (prime to ``N``) drawn from the seed.
  No two calls of a run below ``N`` calls share an offset, so every call
  brings a pattern that no earlier call had, and a cache of plans finds
  nothing to reuse.  The shift maps the ``(row, col)`` pairs one to one,
  so the pattern keeps its base's ``nnz`` and its uniform columns.  It
  is written into a buffer held from set-up (:meth:`Assemble.prepare`),
  outside the call's own time but inside the window.

The traced form makes the same call as the two layer calls that make up
``fsparse_coo``'s body: ``plan_coo``, then ``SparsePattern.assemble``,
each in a span of its own.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.coo import COO
from repro_torch.sparse import matlab, pattern

from .. import peaks, seeding
from ..reference import check

#: the bytes each span of a traced call needs (``call`` is the
#: harness's span around the whole call)
BYTES = {"plan": peaks.plan_bytes, "fill": peaks.fill_bytes,
         "call": peaks.assembly_bytes}
LIMITS = check.LIMITS
to_host = check.csc_to_host
compare = check.compare_csc
control = check.control_csc


def offsets(seed: int, N: int) -> tuple[int, int]:
    """``(o, s)`` of the column offsets ``off_k = (o + k s) mod N``."""
    rng = seeding.host_rng(seed, seeding.OFFSET)
    o = int(rng.integers(N))
    s = int(rng.integers(1, N)) if N > 1 else 1
    while math.gcd(s, N) != 1:
        s += 1
    return o, s


def pattern_nnz(rows: torch.Tensor, cols: torch.Tensor, shape) -> int:
    """Structural nonzeros of a pattern, for the byte counts."""
    M = int(shape[0])
    valid = rows < M
    key = cols[valid].long() * M + rows[valid].long()
    return int(torch.unique(key).numel())


class Assemble:
    def __init__(self, gen, cfg: dict, traffic: dict, seed: int, device):
        self.shape = tuple(gen.shape(cfg))
        self.pool = int(traffic["pool"])
        self.fresh = not getattr(gen, "SHARED_PATTERN", False)
        n_patterns = self.pool if self.fresh else 1
        self.patterns = [gen.pattern(cfg, seed, p, device)
                         for p in range(n_patterns)]
        self.vals = [gen.values(cfg, seed, k, device)
                     for k in range(self.pool)]
        self.L = int(self.vals[0].numel())
        self.offsets = offsets(seed, self.shape[1])
        self.cols = (torch.empty_like(self.patterns[0][1]) if self.fresh
                     else None)
        self.rows = None

    def base(self, k: int) -> int:
        return k % len(self.patterns)

    def offset(self, k: int) -> int:
        if not self.fresh:
            return 0
        o, s = self.offsets
        return (o + k * s) % self.shape[1]

    def indices(self, k: int, out=None):
        """Call ``k``'s ``(rows, cols)``; with ``out``, its columns are
        written there."""
        rows, cols = self.patterns[self.base(k)]
        if not self.fresh:
            return rows, cols
        cols = torch.add(cols, self.offset(k), out=out)
        return rows, cols.remainder_(self.shape[1])

    def prepare(self, k: int) -> None:
        self.rows, self.cols = self.indices(k, out=self.cols)

    def coo(self, k: int) -> COO:
        if self.fresh:
            rows, cols = self.rows, self.cols
        else:
            rows, cols = self.indices(k)
        return COO(rows, cols, self.vals[k % self.pool], self.shape)

    def call(self, k: int):
        return matlab.fsparse_coo(self.coo(k))

    def traced(self, k: int, span):
        coo = self.coo(k)
        with span("plan"):
            pat = pattern.plan_coo(coo)
        with span("fill"):
            return pat.assemble(coo.vals)

    def work(self, k: int) -> int:
        """Triplets of call ``k``."""
        del k
        return self.L

    def span_bytes(self, calls) -> dict:
        """The bytes the calls needed, by span: each call's ``nnz`` is its
        base pattern's, counted on the device by the benchmark."""
        nnz = {}
        out = {}
        for k in calls:
            b = self.base(k)
            if b not in nnz:
                nnz[b] = pattern_nnz(*self.patterns[b], self.shape)
            for span, fn in BYTES.items():
                out[span] = out.get(span, 0) + fn(self.L, self.shape[1],
                                                  nnz[b])
        return out

    def host_inputs(self, k: int) -> dict:
        """Call ``k``'s triplets on the host, made again from the pool."""
        rows, cols = self.indices(k)
        return {"rows": rows.cpu().numpy(), "cols": cols.cpu().numpy(),
                "vals": self.vals[k % self.pool].cpu().numpy(),
                "shape": self.shape, "pattern": (self.base(k),
                                                 self.offset(k))}


def setup(gen, cfg, traffic, seed, device) -> Assemble:
    return Assemble(gen, cfg, traffic, seed, device)
