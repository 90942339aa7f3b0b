"""The two-phase use: plan once, refill every call.

Set-up plans pattern 0 of the configuration once with ``plan_coo`` (the
port's defaults); that time counts in ``setup_s``.  Call ``k`` is
``SparsePattern.assemble(vals)`` with value vector ``k % pool`` of the
pool, in the traced form inside a ``fill`` span.
"""
from __future__ import annotations

from repro_torch.core.coo import COO
from repro_torch.sparse import pattern

from .. import peaks
from ..reference import check
from .assemble import pattern_nnz

BYTES = {"fill": peaks.fill_bytes, "call": peaks.fill_bytes}
LIMITS = check.LIMITS
to_host = check.csc_to_host
compare = check.compare_csc
control = check.control_csc


class Refill:
    def __init__(self, gen, cfg: dict, traffic: dict, seed: int, device):
        self.shape = tuple(gen.shape(cfg))
        self.pool = int(traffic["pool"])
        self.rows, self.cols = gen.pattern(cfg, seed, 0, device)
        self.vals = [gen.values(cfg, seed, k, device)
                     for k in range(self.pool)]
        self.L = int(self.vals[0].numel())
        self.plan = pattern.plan_coo(
            COO(self.rows, self.cols, self.vals[0], self.shape))

    def prepare(self, k: int) -> None:
        del k

    def call(self, k: int):
        return self.plan.assemble(self.vals[k % self.pool])

    def traced(self, k: int, span):
        with span("fill"):
            return self.call(k)

    def work(self, k: int) -> int:
        """Triplet values of call ``k``."""
        del k
        return self.L

    def span_bytes(self, calls) -> dict:
        nnz = pattern_nnz(self.rows, self.cols, self.shape)
        n = len(calls)
        return {span: n * fn(self.L, self.shape[1], nnz)
                for span, fn in BYTES.items()}

    def host_inputs(self, k: int) -> dict:
        return {"rows": self.rows.cpu().numpy(),
                "cols": self.cols.cpu().numpy(),
                "vals": self.vals[k % self.pool].cpu().numpy(),
                "shape": self.shape, "pattern": 0}


def setup(gen, cfg, traffic, seed, device) -> Refill:
    return Refill(gen, cfg, traffic, seed, device)
