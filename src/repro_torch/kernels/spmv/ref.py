"""Plain-PyTorch version of the ELL SpMV (counterpart of
``repro/kernels/spmv/ref.py``): the CPU path of :func:`.spmv.spmv_ell`
and the yardstick ``chip_smoke.py`` holds B8 against."""
from __future__ import annotations

import torch


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y[r] = sum_k vals[r, k] * x[cols[r, k]]``; ``col == N`` reads 0."""
    N = x.shape[0]
    xp = torch.cat([x, x.new_zeros(1)])
    xg = xp[cols.clamp(0, N).long()]
    return torch.sum(vals * xg, dim=1)
