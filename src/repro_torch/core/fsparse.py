"""Deprecated shim: the Matlab facade lives in ``repro_torch.sparse``.

Counterpart of ``repro/core/fsparse.py``, kept so that imports of the
old entry points keep working; the boolean ``fused=`` flag is
deprecated in favour of ``method=``.  The facade is imported inside the
functions: ``repro_torch.sparse`` imports this package's modules.
"""
from __future__ import annotations

from .compat import resolve_method_arg
from .coo import COO
from .csc import CSC


def fsparse(ii, jj, ss, shape=None, nzmax: int | None = None, *,
            fused: bool | None = None, method: str | None = None,
            device=None) -> CSC:
    """Assemble a sparse matrix from Matlab-style triplet data."""
    from ..sparse.matlab import fsparse as _fsparse

    return _fsparse(ii, jj, ss, shape, nzmax,
                    method=resolve_method_arg(fused, method, api="fsparse",
                                              device=device),
                    device=device)


def fsparse_coo(coo: COO, nzmax: int | None = None, *,
                fused: bool | None = None,
                method: str | None = None) -> CSC:
    """Zero-offset COO entry point (no host validation)."""
    from ..sparse.matlab import fsparse_coo as _fsparse_coo

    return _fsparse_coo(coo, nzmax, method=resolve_method_arg(
        fused, method, api="fsparse", device=coo.rows.device))
