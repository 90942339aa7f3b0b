"""Tuning-table validator + AST lint against re-scattered constants.

Counterpart of ``repro/sparse/analysis/tuning_check.py``.  Two checks
keep the execution-policy layer the single home of kernel knobs:

* :func:`validate_tuning_table`: every entry of a
  :class:`~repro_torch.sparse.tuning.TuningTable` must name a registered
  kernel family, only runtime knobs that family's spec declares,
  values type-compatible with the knob's prior and allowed on the
  entry's backend (no plain method for ``cuda`` or every backend), and
  size buckets only on the axes the family's call site resolves at;
  otherwise
  :class:`~repro_torch.sparse.errors.InvariantViolation` with a stable
  invariant name.
* :func:`lint_tuning_constants`: AST lint over the port's policy layer
  (``sparse/dispatch.py``, every ``kernels/*/ops.py`` and the wrappers
  and ``ref.py`` files that pick shapes) flagging a module-level numeric
  literal whose name says it is a policy value, or a knob keyword whose
  default is a numeric literal instead of ``None`` (= "resolve through
  the tuning table").  The name rule covers the reference's spellings
  and the port's own (``_BYTES``, ``_RATIO``, ``_TARGETS``, ``SHORT_``,
  ``_TILE``, ``_PER``, ``_BLOCK_B``).  An alias of a registry value
  (``TILE = tuning.prior_value("radix_sort", "tile")``, checked against
  its library at load) is clean.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from ..errors import InvariantViolation

__all__ = [
    "format_tuning_findings",
    "lint_tuning_constants",
    "validate_tuning_table",
]

#: policy-consuming modules the lint guards (relative to ``src/repro_torch``)
DEFAULT_TUNING_LINT_PATHS = (
    "kernels/assembly_ops.py",
    "kernels/counting_sort/ops.py",
    "kernels/hist/ops.py",
    "kernels/merge/ops.py",
    "kernels/merge/ref.py",
    "kernels/radix_sort/ops.py",
    "kernels/segment_sum/ops.py",
    "kernels/spmv/ops.py",
    "kernels/spmv/spmv.py",
    "kernels/spmv_sym/ops.py",
    "kernels/spmv_sym/ref.py",
    "sparse/dispatch.py",
)

#: module-level constant names that must live in the tuning registry
_CAP_NAME_RE = re.compile(
    r"(RESIDENT|BUDGET|MAX_BYTES$|_BYTES$|_COST$|_MAX_BITS$|^MAX_BITS$"
    r"|^BLOCK_[BRTQ]$|_BLOCK_B$|_RATIO$|_TARGETS$|^SHORT_|_TILE$|_PER$"
    r"|^SPLITTERS$)"
)

#: knob keywords whose literal defaults the registry owns
_KNOB_ARGS = frozenset({
    "block_b", "block_t", "block_r", "max_bits", "min_block_b",
    "max_block_b", "dense_ratio", "sparse_ratio", "sparse_targets", "short_column", "short_mean",
})


def validate_tuning_table(table=None):
    """Check every table entry against the registered kernel specs.

    Raises :class:`InvariantViolation` with invariant
    ``tuning-unknown-family`` / ``tuning-unknown-knob`` /
    ``tuning-bad-value`` (also for a build-time knob, which no table may
    override, and for a value not allowed on the entry's backend) /
    ``tuning-bad-axis`` (a size bucket off the family's axes); returns
    the number of entries checked.
    """
    from .. import tuning

    if table is None:
        table = tuning.get_table()
    checked = 0
    for entry in table.entries():
        family = entry.get("family")
        backend = entry.get("backend")
        subject = f"tuning[{family}@{backend}]"
        try:
            spec = tuning.kernel_spec(family)
        except KeyError:
            raise InvariantViolation(
                "tuning-unknown-family",
                f"entry names unregistered family {family!r}",
                subject=subject) from None
        off = sorted(a for a in ("M", "N", "L")
                     if entry.get(f"{a}_bucket") is not None
                     and a not in spec.axes)
        if off:
            raise InvariantViolation(
                "tuning-bad-axis",
                f"entry is keyed on {off}; the {family!r} call site "
                f"resolves at {spec.axes}", subject=subject)
        known = set(spec.knob_names())
        for name, value in entry.get("policy", {}).items():
            if name not in known:
                raise InvariantViolation(
                    "tuning-unknown-knob",
                    f"knob {name!r} is not declared by the {family!r} spec "
                    f"(knows {sorted(known)})", subject=subject)
            knob = spec.knob(name)
            if knob.build:
                raise InvariantViolation(
                    "tuning-bad-value",
                    f"knob {name!r} is fixed at build time "
                    f"({knob.default!r}); a table cannot override it",
                    subject=subject)
            prior = knob.prior(backend or "cpu")
            numeric = isinstance(value, (int, float)) and not isinstance(
                value, bool)
            ok = numeric if isinstance(prior, (int, float)) \
                else isinstance(value, type(prior))
            if not ok:
                raise InvariantViolation(
                    "tuning-bad-value",
                    f"knob {name!r} holds {value!r} "
                    f"({type(value).__name__}), prior is {prior!r}",
                    subject=subject)
            if numeric and value <= 0:
                raise InvariantViolation(
                    "tuning-bad-value",
                    f"knob {name!r} holds non-positive {value!r}",
                    subject=subject)
            if not knob.allows(value, backend):
                raise InvariantViolation(
                    "tuning-bad-value",
                    f"knob {name!r} holds {value!r}, not allowed on "
                    f"backend {backend or '*'} ({knob.allowed})",
                    subject=subject)
        checked += 1
    return checked


def _is_numeric_literal(node: ast.expr) -> bool:
    """True for ``1024``, ``8 << 20``, ``-5``, ``3 * 1024`` etc."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and not isinstance(
            node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_numeric_literal(node.left) and _is_numeric_literal(
            node.right)
    return False


class _ConstantVisitor(ast.NodeVisitor):
    def __init__(self, path: Path):
        self.path = path
        self.findings: list[dict] = []

    def _flag(self, node: ast.AST, name: str, reason: str) -> None:
        self.findings.append({"file": str(self.path), "line": node.lineno,
                              "name": name, "reason": reason})

    def visit_Module(self, node: ast.Module) -> None:
        for stmt in node.body:
            targets, value = [], None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign):
                targets, value = [stmt.target], stmt.value
            for t in targets:
                if (isinstance(t, ast.Name) and _CAP_NAME_RE.search(t.id)
                        and value is not None and _is_numeric_literal(value)):
                    self._flag(stmt, t.id,
                               f"module constant {t.id!r} holds a numeric "
                               "literal — register it as a tuning knob (or "
                               "alias the registry value) instead")
        self.generic_visit(node)

    def _visit_func(self, node) -> None:
        a = node.args
        pairs = list(zip(a.args[len(a.args) - len(a.defaults):],
                         a.defaults)) + [
            (arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
            if d is not None]
        for arg, default in pairs:
            if arg.arg in _KNOB_ARGS and _is_numeric_literal(default):
                self._flag(default, arg.arg,
                           f"{node.name}() defaults knob {arg.arg!r} to a "
                           "numeric literal — default to None and resolve "
                           "through repro_torch.sparse.tuning")
        self.generic_visit(node)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func


def lint_tuning_constants(paths=None) -> list[dict]:
    """Lint the policy-consuming layer; finding dicts (empty = clean)."""
    if paths is None:
        base = Path(__file__).resolve().parent.parent.parent
        paths = [base / rel for rel in DEFAULT_TUNING_LINT_PATHS]
    findings: list[dict] = []
    for path in map(Path, paths):
        tree = ast.parse(path.read_text(), filename=str(path))
        visitor = _ConstantVisitor(path)
        visitor.visit(tree)
        findings.extend(visitor.findings)
    return findings


def format_tuning_findings(findings: list[dict]) -> str:
    if not findings:
        return "tuning lint: clean"
    return "\n".join(f"{f['file']}:{f['line']}: {f['reason']}"
                     for f in findings)
