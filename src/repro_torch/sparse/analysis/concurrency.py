"""AST lint: shared-cache mutations must happen under a lock.

Counterpart of ``repro/sparse/analysis/concurrency.py``, the same rule
over the port's modules.  The port keeps module-level caches (the plan
LRU of ``matlab.py``, the product LRU and the retired-structure set of
``spgemm.py``) mutated from concurrent request threads; ``serving.py``
joins :data:`DEFAULT_MODULES` when it is ported (ROADMAP queue A, item
11).  The discipline that keeps them coherent (every mutation of
module-level shared mutable state happens inside an ``LRUCache`` method,
which locks internally, or inside an explicit ``with <lock>:`` scope) is
purely lexical, so it is checked statically; ``lru.py``'s lock
sanitizer (``REPRO_LOCK_SANITIZE``) checks it at run time.

:func:`lint_shared_state` parses the modules and classifies module-level
assignments:

* ``NAME = LRUCache(...)``: safe; its methods serialize internally.
* ``NAME = threading.Lock()/RLock()``: a lock name; ``with NAME:`` opens
  a protected scope (``with self._lock:`` style attributes whose name
  contains ``lock`` count too).
* ``NAME = set()/dict()/[]/{...}``: shared mutable state.

It then flags, inside any function body: mutator method calls
(``add``/``update``/``pop``/...), subscript stores/deletes, augmented
assignment, and ``global`` rebinds of a shared mutable that are not
lexically under a lock and not inside ``LRUCache`` itself.  Import-time
(module top-level) initialization is exempt: it runs single-threaded.
"""
from __future__ import annotations

import ast
from pathlib import Path

__all__ = ["format_findings", "lint_shared_state"]

#: the port's modules whose shared state this lint guards
DEFAULT_MODULES = ("lru.py", "matlab.py", "spgemm.py")

_MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend", "insert",
    "pop", "popitem", "remove", "setdefault", "update",
})
_MUTABLE_CALLS = frozenset({
    "Counter", "OrderedDict", "defaultdict", "deque", "dict", "list", "set",
})
_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
                     ast.SetComp)
_LOCK_CALLS = frozenset({"Condition", "Lock", "RLock", "Semaphore"})
_EXEMPT_CLASSES = frozenset({"LRUCache"})


def _call_name(node: ast.expr) -> str | None:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            return f.id
        if isinstance(f, ast.Attribute):
            return f.attr
    return None


def _classify_module(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(shared mutable names, lock names) from top-level assignments."""
    shared: set[str] = set()
    locks: set[str] = set()
    for node in tree.body:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names or node.value is None:
            continue
        called = _call_name(node.value)
        if called == "LRUCache":
            continue  # safe: locks internally
        if called in _LOCK_CALLS:
            locks.update(names)
        elif called in _MUTABLE_CALLS or isinstance(node.value,
                                                    _MUTABLE_LITERALS):
            shared.update(names)
    return shared, locks


class _MutationVisitor(ast.NodeVisitor):
    def __init__(self, path: Path, shared: set[str], locks: set[str]):
        self.path = path
        self.shared = shared
        self.locks = locks
        self.findings: list[dict] = []
        self._lock_depth = 0
        self._func_depth = 0
        self._class_stack: list[str] = []
        self._globals: set[str] = set()

    # -- scope tracking ------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_func(self, node) -> None:
        outer = self._globals
        self._globals = set()
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1
        self._globals = outer

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Global(self, node: ast.Global) -> None:
        self._globals.update(node.names)

    def _is_lock_expr(self, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.locks
        if isinstance(expr, ast.Attribute):
            return "lock" in expr.attr.lower()
        if isinstance(expr, ast.Call):
            return self._is_lock_expr(expr.func)
        return False

    def visit_With(self, node: ast.With) -> None:
        locked = any(self._is_lock_expr(item.context_expr)
                     for item in node.items)
        self._lock_depth += locked
        self.generic_visit(node)
        self._lock_depth -= locked

    # -- mutation checks -----------------------------------------------
    def _exempt(self) -> bool:
        return (self._func_depth == 0  # import-time init: single-threaded
                or self._lock_depth > 0
                or bool(_EXEMPT_CLASSES & set(self._class_stack)))

    def _flag(self, node: ast.AST, name: str, what: str) -> None:
        self.findings.append({
            "file": str(self.path), "line": node.lineno, "name": name,
            "reason": f"{what} of module-level shared mutable {name!r} "
                      "outside a lock scope or LRUCache method",
        })

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in _MUTATORS
                and isinstance(f.value, ast.Name)
                and f.value.id in self.shared and not self._exempt()):
            self._flag(node, f.value.id, f"unlocked .{f.attr}()")
        self.generic_visit(node)

    def _check_store(self, target: ast.expr, node: ast.AST, what: str):
        if (isinstance(target, ast.Subscript)
                and isinstance(target.value, ast.Name)
                and target.value.id in self.shared and not self._exempt()):
            self._flag(node, target.value.id, what)
        elif (isinstance(target, ast.Name) and target.id in self.shared
              and target.id in self._globals and not self._exempt()):
            self._flag(node, target.id, "unlocked global rebind")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store(t, node, "unlocked subscript store")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store(node.target, node, "unlocked augmented store")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_store(t, node, "unlocked subscript delete")
        self.generic_visit(node)


def lint_shared_state(paths=None) -> list[dict]:
    """Lint the modules; returns finding dicts (empty = clean)."""
    if paths is None:
        base = Path(__file__).resolve().parent.parent
        paths = [base / name for name in DEFAULT_MODULES]
    findings: list[dict] = []
    for path in map(Path, paths):
        tree = ast.parse(path.read_text(), filename=str(path))
        shared, locks = _classify_module(tree)
        visitor = _MutationVisitor(path, shared, locks)
        visitor.visit(tree)
        findings.extend(visitor.findings)
    return findings


def format_findings(findings: list[dict]) -> str:
    if not findings:
        return "concurrency lint: clean"
    return "\n".join(f"{f['file']}:{f['line']}: {f['reason']}"
                     for f in findings)
