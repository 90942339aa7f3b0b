"""Entry point of the merge positioning search (counterpart of
``repro/kernels/merge/ops.py``).

The reference chooses between its Pallas kernel (target keys resident
in VMEM) and its jnp version by an 8 MB residency budget
(``MERGE_RESIDENT_MAX_BYTES``).  The port has no such guard: B7 reads
the targets from device memory and serves every ``n``, as B3' and B6
do, so a CUDA tensor always launches the kernel.  ``merge_vmem_spec``
(the residency report) has no counterpart yet: it belongs to the
per-kernel report of ROADMAP queue A, item 13.
"""
from __future__ import annotations

import torch

from .merge import merge_search_kernel


def merge_search(q_rows: torch.Tensor, q_cols: torch.Tensor,
                 t_rows: torch.Tensor, t_cols: torch.Tensor, *,
                 side: str = "left") -> torch.Tensor:
    """Per-query insertion offsets into a sorted target stream.

    Same contract as :func:`repro_torch.kernels.merge.ref.merge_search_ref`
    (which it matches bit for bit): B7 on the card, the plain version on
    the CPU.  Inputs of any integer dtype become contiguous int32.
    """
    def i32(t):
        return t.to(torch.int32).contiguous()

    return merge_search_kernel(i32(q_rows), i32(q_cols), i32(t_rows),
                               i32(t_cols), side=side)
