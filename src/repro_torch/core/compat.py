"""The shared ``fused=`` deprecation helper.

Counterpart of ``repro/core/compat.py``'s ``resolve_method_arg``; its
jax version shims (``shard_map``) have no counterpart in the port.
"""
from __future__ import annotations

import warnings

from ..sparse.dispatch import method_from_fused


def resolve_method_arg(fused: bool | None, method: str | None, *, api: str,
                       device=None, stacklevel: int = 3) -> str:
    """Map the deprecated ``fused=`` flag to a ``method`` string, warning.

    Shared by every back-compat entry point so the deprecation message
    and the resolution cannot drift apart.  The warning names the exact
    replacement call for the flag value that was passed.  With neither
    argument the default backend of ``device`` applies.
    """
    resolved = method_from_fused(fused, method, device)
    if fused is not None:
        warnings.warn(
            f"{api}(..., fused={bool(fused)}) is deprecated; call "
            f"{api}(..., method='{resolved}') instead — see "
            "repro_torch.sparse for the full backend table",
            DeprecationWarning,
            stacklevel=stacklevel,
        )
    return resolved
