"""Entry point of the merge positioning search (counterpart of
``repro/kernels/merge/ops.py``).

The reference chooses between its Pallas kernel (target keys resident
in VMEM) and its jnp version by an 8 MB residency budget
(``MERGE_RESIDENT_MAX_BYTES``).  The port has no such guard: B7 reads
the targets from device memory and serves every ``n``, as B3' and B6
do, so a CUDA tensor always launches the kernel.  ``merge_vmem_spec``
is replaced by the per-kernel resource report
(:mod:`repro_torch.sparse.analysis.vmem`).
"""
from __future__ import annotations

import torch

from .merge import merge_search_kernel
from .ref import merge_shape


def merge_search(q_rows: torch.Tensor, q_cols: torch.Tensor,
                 t_rows: torch.Tensor, t_cols: torch.Tensor, *,
                 side: str = "left", dense_ratio: int | None = None,
                 sparse_ratio: int | None = None,
                 sparse_targets: int | None = None) -> torch.Tensor:
    """Per-query insertion offsets into a sorted target stream.

    Same contract as :func:`repro_torch.kernels.merge.ref.merge_search_ref`
    (which it matches bit for bit): B7 on the card, the plain version on
    the CPU.  Inputs of any integer dtype become contiguous int32.  The
    shape thresholds left ``None`` resolve through the ``merge`` tuning
    policy (:func:`.ref.merge_shape`); every shape gives the same
    offsets.
    """
    def i32(t):
        return t.to(torch.int32).contiguous()

    shape = merge_shape(q_rows.shape[0], t_rows.shape[0],
                        dense_ratio=dense_ratio, sparse_ratio=sparse_ratio,
                        sparse_targets=sparse_targets, backend=q_rows.device)
    return merge_search_kernel(i32(q_rows), i32(q_cols), i32(t_rows),
                               i32(t_cols), side=side, shape=shape)
