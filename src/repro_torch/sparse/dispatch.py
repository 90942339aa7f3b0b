"""Single backend-dispatch point for the assembly sort strategies.

Counterpart of ``repro/sparse/dispatch.py``.  Every planner selects its
backend through one ``method=`` string:

  "jnp"    two stable sorts (row pass, then column pass) with
           ``torch.sort`` -- the paper's Parts 1-3 structure (the name
           is the reference's)
  "fused"  one stable ``torch.sort`` on the int64 key
           ``col * (M+1) + row``.  torch always has int64, so the
           reference's int32-overflow fallback has no regime here
  "pallas" the paper's counting sort on the hand-written B12 (block
           histogram) and B11 (stable placement) kernels, one full
           pass per matrix dimension (``repro_torch.kernels
           .counting_sort``; the name is the reference's)
  "radix"  the LSD radix planner on the hand-written B1/B2 kernels
           (``repro_torch.kernels.radix_sort``)

All backends produce the identical (col,row)-ordered permutation.
``method=None`` resolves through the tuning table (family ``"plan"``,
:mod:`repro_torch.sparse.tuning`) for the tensors' backend: the priors
are ``"radix"`` for CUDA tensors and ``"fused"`` for CPU tensors, and a
measured entry can override them per shape bucket; for CUDA tensors only
with another hand-written kernel (``"pallas"``), never a plain sort.

The merge registry (``SparsePattern.update``'s sorted-stream merge by
key) selects the search backend through ``merge_method=``:

  "jnp"    the plain ``bit_length(n)``-step ladder in torch
           (``repro_torch.kernels.merge.ref``; the name is the
           reference's)
  "pallas" the hand-written B7 kernel (``repro_torch.kernels.merge``;
           on a CPU tensor its wrapper runs the plain version)

``merge_method=None`` resolves through the tuning table (family
``"merge"``): the priors are ``"pallas"`` for CUDA tensors and
``"jnp"`` for CPU tensors, and no table entry moves a CUDA tensor off
B7.  All backends are bit-identical.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from . import tuning

PermFn = Callable[..., torch.Tensor]

_METHODS: Dict[str, PermFn] = {}

#: the planning backend on the card (the hand-written kernels) and for CPU
#: tensors (where the kernels run their plain versions): the priors of
#: the ``plan`` tuning spec, kept as the documented pins
DEFAULT_METHOD_CUDA = tuning.prior_value("plan", "method", backend="cuda")
DEFAULT_METHOD_CPU = tuning.prior_value("plan", "method", backend="cpu")


def register_method(name: str, fn: PermFn) -> None:
    """Register a sort backend: ``fn(rows, cols, *, M, N, **kw) -> perm``."""
    _METHODS[name] = fn


def available_methods() -> tuple[str, ...]:
    return tuple(sorted(_METHODS))


def plan_key(M=None, N=None, L=None) -> dict:
    """The sizes ``method=None`` resolves the ``plan`` policy at (and the
    autotuner records a measured entry at)."""
    return {"M": M, "N": N, "L": L}


def default_method(device=None, *, M=None, N=None, L=None) -> str:
    """The backend used for ``method=None`` on ``device`` (a tensor's
    device, or ``None`` for the port's default device, CUDA), resolved
    through the tuning table (family ``"plan"``) at the given shape."""
    return str(tuning.resolve_policy("plan", backend=tuning.backend_of(
        device), **plan_key(M, N, L))["method"])


def resolve_method(method: str | None, device=None, *, M=None, N=None,
                   L=None) -> str:
    """Map ``None`` to the device's default, pass names through."""
    if method is not None:
        return method
    return default_method(device, M=M, N=N, L=L)


def sorted_permutation(rows: torch.Tensor, cols: torch.Tensor, *, M: int,
                       N: int, method: str | None = None,
                       **kwargs) -> torch.Tensor:
    """(col,row)-stable-ordered int32 permutation via the selected
    backend."""
    method = resolve_method(method, rows.device, M=M, N=N,
                            L=rows.shape[0])
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown assembly method {method!r}; "
            f"available: {available_methods()}"
        ) from None
    return fn(rows, cols, M=M, N=N, **kwargs)


def method_from_fused(fused: bool | None, method: str | None,
                      device=None) -> str:
    """Back-compat shim: map the deprecated ``fused=`` flag to a method.

    An explicit ``fused=True/False`` keeps its historical meaning
    (``"fused"``/``"jnp"``); with neither argument given the device's
    default backend applies.
    """
    if method is not None:
        return method
    if fused is None:
        return default_method(device)
    return "fused" if fused else "jnp"


def _argsort_stable(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def _perm_jnp(rows, cols, *, M: int, N: int) -> torch.Tensor:
    """Two-pass path: stable row sort, then stable column sort (paper)."""
    del M, N
    rank = _argsort_stable(rows)
    rank2 = _argsort_stable(cols[rank])
    return rank[rank2].to(torch.int32)


def _perm_fused(rows, cols, *, M: int, N: int) -> torch.Tensor:
    """One stable sort on the int64 fused key ``col * (M+1) + row``."""
    del N
    key = cols.long() * (M + 1) + rows.long()
    return _argsort_stable(key).to(torch.int32)


def _perm_pallas(rows, cols, *, M: int, N: int,
                 block_b: int | None = None) -> torch.Tensor:
    """Counting sort on the B12/B11 kernels: rows first (``M + 1``
    bins, padding included), then the row-ordered cols (``N + 1``)."""
    from ..kernels.counting_sort.ops import counting_sort

    rank, _ = counting_sort(rows, nbins=M + 1, block_b=block_b)
    rank2, _ = counting_sort(cols[rank], nbins=N + 1, block_b=block_b)
    return rank[rank2]


def _perm_radix(rows, cols, *, M: int, N: int,
                max_bits: int | None = None) -> torch.Tensor:
    """LSD radix planner on the B1/B2 kernels (lazy import: no hard
    kernel dependency)."""
    from ..kernels.radix_sort.ops import radix_sort_pair

    return radix_sort_pair(rows, cols, M=M, N=N, max_bits=max_bits)


register_method("jnp", _perm_jnp)
register_method("fused", _perm_fused)
register_method("pallas", _perm_pallas)
register_method("radix", _perm_radix)


# ---------------------------------------------------------------------------
# Merge backends (SparsePattern.update's sorted-stream merge by key)
# ---------------------------------------------------------------------------
_MERGE_METHODS: Dict[str, PermFn] = {}

#: the merge backend on the card (B7) and for CPU tensors (the plain
#: ladder): the priors of the ``merge`` tuning spec
DEFAULT_MERGE_CUDA = tuning.prior_value("merge", "method", backend="cuda")
DEFAULT_MERGE_CPU = tuning.prior_value("merge", "method", backend="cpu")


def register_merge_method(name: str, fn: PermFn) -> None:
    """Register a merge-search backend:
    ``fn(q_rows, q_cols, t_rows, t_cols, *, side, **kw) -> offsets``."""
    _MERGE_METHODS[name] = fn


def available_merge_methods() -> tuple[str, ...]:
    return tuple(sorted(_MERGE_METHODS))


def default_merge_method(device=None, *, L=None) -> str:
    """The backend used for ``merge_method=None`` on ``device`` (a
    tensor's device, or ``None`` for the port's default device, CUDA),
    resolved through the tuning table (family ``"merge"``; ``L`` the
    targets)."""
    from ..kernels.merge.ref import policy_key

    return str(tuning.resolve_policy("merge", backend=tuning.backend_of(
        device), **policy_key(L))["method"])


def resolve_merge_method(method: str | None, device=None, *,
                         L=None) -> str:
    if method is not None:
        return method
    return default_merge_method(device, L=L)


def merge_search(q_rows: torch.Tensor, q_cols: torch.Tensor,
                 t_rows: torch.Tensor, t_cols: torch.Tensor, *,
                 side: str = "left", method: str | None = None,
                 **kwargs) -> torch.Tensor:
    """Per-query insertion offsets into a (col,row)-sorted target stream.

    ``side="left"`` counts targets strictly below each query key,
    ``side="right"`` counts targets at-or-below: the two halves of a
    stable merge's tie rule.  All backends are bit-identical.
    """
    method = resolve_merge_method(method, q_rows.device,
                                  L=t_rows.shape[0])
    try:
        fn = _MERGE_METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown merge method {method!r}; "
            f"available: {available_merge_methods()}"
        ) from None
    return fn(q_rows, q_cols, t_rows, t_cols, side=side, **kwargs)


def _merge_jnp(q_rows, q_cols, t_rows, t_cols, *, side="left"):
    """The plain ladder in torch (lazy import, like the sorts)."""
    from ..kernels.merge.ref import merge_search_ref

    return merge_search_ref(q_rows, q_cols, t_rows, t_cols, side=side)


def _merge_pallas(q_rows, q_cols, t_rows, t_cols, *, side="left", **shape):
    """B7 on the card (no residency guard: it serves every size);
    ``shape`` holds any of its thresholds passed explicitly."""
    from ..kernels.merge.ops import merge_search as _kernel_search

    return _kernel_search(q_rows, q_cols, t_rows, t_cols, side=side,
                          **shape)


register_merge_method("jnp", _merge_jnp)
register_merge_method("pallas", _merge_pallas)
