"""Contract auditor of the hot paths: the aten ops they dispatch.

Counterpart of ``repro/sparse/analysis/contracts.py``.  The reference
audits a traced jaxpr; the port is eager, so the audit records the aten
ops a call dispatches under a
:class:`torch.utils._python_dispatch.TorchDispatchMode`
(:func:`record_ops`) and checks three contracts the fill, refill,
SpGEMM multiply and SpMV paths promise:

* ``16-bit-accumulation``: no sum, cumsum, ``index_add``,
  ``scatter_add``, summing ``scatter_reduce`` or matmul accumulates into
  float16 or bfloat16 (the ``accum_dtype`` contract: 16-bit streams are
  summed in float32 and cast back once);
* ``host-sync``: no ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``, ``bool(t)``), no copy to the CPU of a tensor that is not
  there (``.cpu()``, ``.to("cpu")``) and no boolean compaction
  (``aten.nonzero``, ``aten.masked_select``, ``aten.index`` by a mask:
  the output's size is read back) runs inside the path;
* ``output-dtype``: floating outputs match the ``fill_dtype`` contract.

Ops are matched on their overload packet (``aten.sum``, every overload),
never on a substring of a name: the reference's substring rule
(``contracts.py:113-114``) misses ``debug_print`` under jax 0.9.

What the audit sees: the hand-written kernels are ctypes calls and do
not pass through the dispatcher, so on the card the audit sees each
wrapper's own allocations, casts and syncs around them, and on the CPU
the kernels' plain PyTorch versions.  An op's own internals (a host
synchronisation inside ``torch.bincount``'s CUDA implementation, say)
are not dispatched either.  ``.cpu()`` of a tensor already on the CPU
dispatches nothing: on a CPU run the copy rule cannot fire.

SpMV paths are audited at float32, as in the reference: only the fill
paths own the float32-accumulation contract.  The reference's
``RetraceAuditor``/``audit_retraces`` (an ``epoch`` bump retraces once)
have no counterpart until the executable tier of ``sparse/serving.py``
(CUDA-graph capture keyed on ``epoch``; ROADMAP queue A, item 11).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..errors import InvariantViolation

__all__ = [
    "OpRecord",
    "OpTrace",
    "audit_default_paths",
    "audit_jaxpr",
    "audit_trace",
    "iter_eqns",
    "record_ops",
]

_aten = torch.ops.aten
#: ops that *sum* into their output (a summing scatter_reduce too);
#: min/max/first/last selections are exact and deliberately not listed
_SUM_OPS = frozenset({
    _aten.sum, _aten.nansum, _aten.mean, _aten.cumsum, _aten.index_add,
    _aten.index_add_, _aten.scatter_add, _aten.scatter_add_, _aten.mm,
    _aten.mv, _aten.bmm, _aten.addmm, _aten.addmv, _aten.baddbmm,
    _aten.dot, _aten.vdot,
})
_SCATTER_REDUCE = frozenset({_aten.scatter_reduce, _aten.scatter_reduce_,
                             _aten.index_reduce, _aten.index_reduce_})
_SUMMING_REDUCTIONS = frozenset({"sum", "prod", "mean"})
_SYNC_OPS = frozenset({_aten._local_scalar_dense, _aten.nonzero,
                       _aten.masked_select})
_COPY_OPS = frozenset({_aten._to_copy, _aten.copy_, _aten.copy})
_16BIT_FLOATS = (torch.float16, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op: its overload packet, the devices of its
    tensor inputs, the devices and dtypes of its tensor outputs, the
    string arguments it took (a ``scatter_reduce``'s reduction) and the
    dtypes of its tensor inputs, in order."""

    packet: object
    in_devices: tuple
    out_devices: tuple
    out_dtypes: tuple
    strings: tuple
    in_dtypes: tuple = ()

    @property
    def name(self) -> str:
        return str(self.packet)


@dataclasses.dataclass
class OpTrace:
    """The ops one call dispatched, and what it returned."""

    records: list
    outputs: tuple


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        self.records.append(OpRecord(
            packet=func.overloadpacket,
            in_devices=tuple(t.device.type for t in ins
                             if isinstance(t, torch.Tensor)),
            out_devices=tuple(t.device.type for t in outs
                              if isinstance(t, torch.Tensor)),
            out_dtypes=tuple(t.dtype for t in outs
                             if isinstance(t, torch.Tensor)),
            strings=tuple(a for a in ins if isinstance(a, str)),
            in_dtypes=tuple(t.dtype for t in ins
                            if isinstance(t, torch.Tensor))))
        return out


def record_ops(fn, *args, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` once, recording every aten op."""
    rec = _Recorder()
    with rec:
        out = fn(*args, **kwargs)
    outs, _ = tree_flatten(out)
    return OpTrace(records=rec.records,
                   outputs=tuple(t for t in outs
                                 if isinstance(t, torch.Tensor)))


def iter_eqns(trace):
    """The records of a trace (the reference walks a jaxpr's equations)."""
    yield from getattr(trace, "records", trace)


def _host_sync(r: OpRecord) -> bool:
    if r.packet in _SYNC_OPS:
        return True
    if r.packet is _aten.index and torch.bool in r.in_dtypes[1:]:
        return True  # a boolean mask: compaction
    # a copy whose result lies on the CPU but whose source does not
    return (r.packet in _COPY_OPS and "cpu" in r.out_devices
            and any(d != "cpu" for d in r.in_devices))


def _accumulates_16bit(r: OpRecord) -> bool:
    summing = r.packet in _SUM_OPS or (
        r.packet in _SCATTER_REDUCE
        and bool(_SUMMING_REDUCTIONS & set(r.strings)))
    return summing and any(dt in _16BIT_FLOATS for dt in r.out_dtypes)


def audit_trace(trace, *, name: str = "trace", expect_dtype=None,
                forbid_16bit_accum: bool = True,
                forbid_callbacks: bool = True) -> dict:
    """Audit one recorded call (:func:`record_ops`).

    Raises :class:`~repro_torch.sparse.errors.InvariantViolation` named
    ``16-bit-accumulation``, ``host-sync`` (``forbid_callbacks``: the
    reference's switch for its host-callback rule) or ``output-dtype``
    (a floating output's dtype differs from ``expect_dtype``, when
    given).  Returns a small report (name, op count, op names).
    """
    n_ops = 0
    names: set[str] = set()
    for r in iter_eqns(trace):
        n_ops += 1
        names.add(r.name)
        if forbid_callbacks and _host_sync(r):
            raise InvariantViolation(
                "host-sync",
                f"hot path dispatches {r.name} (devices {r.in_devices} -> "
                f"{r.out_devices}): a synchronisation with the host",
                subject=name)
        if forbid_16bit_accum and _accumulates_16bit(r):
            raise InvariantViolation(
                "16-bit-accumulation",
                f"{r.name} accumulates into {list(r.out_dtypes)}; the "
                "accum_dtype contract requires a float32 accumulator for "
                "16-bit streams", subject=name)
    if expect_dtype is not None:
        bad = sorted({str(t.dtype) for t in trace.outputs
                      if t.dtype.is_floating_point
                      and t.dtype != expect_dtype})
        if bad:
            raise InvariantViolation(
                "output-dtype",
                f"floating outputs {bad} do not match the fill_dtype "
                f"contract ({expect_dtype})", subject=name)
    return {"name": name, "eqns": n_ops, "primitives": sorted(names),
            "ok": True}


#: the reference's name for the audit of one traced computation
audit_jaxpr = audit_trace


def _representative_structures(device):
    """Small operands exercising every audited path (4 x 4, a duplicate
    at (2, 2), structurally and numerically symmetric)."""
    from ..formats import convert
    from ..pattern import plan

    rows = torch.tensor([0, 1, 0, 2, 2, 2, 3], dtype=torch.int32,
                        device=device)
    cols = torch.tensor([0, 0, 1, 2, 2, 3, 2], dtype=torch.int32,
                        device=device)
    pat = plan(rows, cols, (4, 4))
    A = pat.assemble(torch.ones(pat.L, device=device))
    return pat, A, convert(A, "symcsc"), convert(A, "bsr", block=2)


def audit_default_paths(*, device=None,
                        dtypes=(torch.float32, torch.bfloat16)) -> list:
    """Record and audit every fill, refill, multiply and SpMV path.

    Fills run per ``accum`` mode and per dtype in ``dtypes`` (bf16
    included: that is where a missing float32 promotion shows up as a
    16-bit ``index_add``), the refill (``assemble``), the unfused fill
    (``fill_pallas``, B5) and the SpGEMM multiply per dtype, the SpMVs
    (CSC, ELL, SymCSC, BSR) at float32.
    ``device`` is ``"cuda"`` unless the caller passes another.  Returns
    the per-path reports; raises ``InvariantViolation`` on the first
    broken contract.
    """
    from ...kernels.assembly_ops import fill_pallas
    from ...kernels.common import resolve_device
    from ...kernels.spmv.ops import csc_to_ell, spmv as ell_spmv
    from .. import ops as sparse_ops
    from ..pattern import ACCUM_MODES, fill_dtype
    from ..spgemm import product_plan

    dev = resolve_device(device)
    pat, A, Y, B2 = _representative_structures(dev)
    reports: list = []

    def _audit(fn, args, *, name, expect=None):
        fn(*args)  # once unrecorded: lazy builds and first-use work
        reports.append(audit_trace(record_ops(fn, *args), name=name,
                                   expect_dtype=expect))

    for dtype in dtypes:
        vals = torch.ones(pat.L, dtype=dtype, device=dev)
        for accum in ACCUM_MODES:
            _audit(lambda v, a=accum: pat.scatter(v, accum=a), (vals,),
                   name=f"fill[{accum},{str(dtype)[6:]}]",
                   expect=fill_dtype(dtype))
        _audit(lambda v: pat.assemble(v).data, (vals,),
               name=f"refill[{str(dtype)[6:]}]", expect=fill_dtype(dtype))
        _audit(lambda v: fill_pallas(pat, v).data, (vals,),
               name=f"fill_unfused[{str(dtype)[6:]}]",
               expect=fill_dtype(dtype))
    pp = product_plan(A, A)
    for dtype in dtypes:
        da = torch.ones(pp.a_capacity, dtype=dtype, device=dev)
        db = torch.ones(pp.b_capacity, dtype=dtype, device=dev)
        _audit(lambda a, b: pp.multiply(a, b).data, (da, db),
               name=f"spgemm[{str(dtype)[6:]}]", expect=fill_dtype(dtype))
    x = torch.ones(4, dtype=torch.float32, device=dev)
    for mat, label in ((A, "csc"), (Y, "symcsc"), (B2, "bsr")):
        _audit(lambda m, v: sparse_ops.matmul(m, v), (mat, x),
               name=f"spmv[{label},float32]", expect=torch.float32)
    ell_cols, ell_vals, _ = csc_to_ell(A, max_per_row=4)
    _audit(lambda c, v, b: ell_spmv(c, v, b), (ell_cols, ell_vals, x),
           name="spmv[ell,float32]", expect=torch.float32)
    return reports
