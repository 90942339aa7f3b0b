"""Every mirrored submodule of the port exports what the reference's does.

``tests/test_torch_api_surface.py`` walks the ``__all__`` of the three
top-level packages; this walks every module of ``core``, ``sparse``,
``kernels`` and the LM stack's ``models``, ``configs``, ``train``,
``launch``, ``serve``, ``data`` and ``ckpt`` that both packages have, at
any depth.  A module's public
names are its ``__all__`` where it has one, else the public functions,
classes and assignments at its top level, and, in a package's
``__init__``, the names it imports from its own subpackage.  Each must
be an attribute of the port's module, reached through ``sys.modules``
(``repro_torch.kernels.spmv`` is the function there, as in the
reference, so attribute access would not reach the subpackage), unless
it is listed below with its reason.  A listed name must still be absent.
A reference module the port does not have at all must be listed in
``ABSENT_MODULES`` with its reason.
"""
import ast
import importlib
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.radix_sort import radix_pass_rank as jax_radix_pass_rank
from repro.kernels.radix_sort.ref import digit_rank_ref

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
PACKAGES = ("core", "sparse", "kernels", "models", "configs", "train",
            "launch", "serve", "data", "ckpt")

#: the reference's modules the port does not have, with the reason for
#: each (none: every module is ported)
ABSENT_MODULES = {}

#: names of the reference's submodules the port leaves out on purpose
ABSENT = {
    # TPU VMEM cost models; the card's kernels have no VMEM budget (the
    # resource report, sparse/analysis/vmem.py, measures them instead)
    "kernels.radix_sort.ops": {"radix_vmem_spec"},
    "kernels.spmv_sym.ops": {"bsr_vmem_spec", "sym_vmem_spec",
                             "FUSED_RESIDENT_MAX_BYTES"},
    "kernels.segment_sum.ops": {"fill_vmem_spec", "spgemm_vmem_spec",
                                "FUSED_RESIDENT_MAX_BYTES"},
    "kernels.merge.ops": {"merge_vmem_spec", "MERGE_RESIDENT_MAX_BYTES"},
    # the VMEM residency guards have no counterpart (ROADMAP queue C)
    "kernels.spmv_sym": {"FUSED_RESIDENT_MAX_BYTES"},
    "sparse.tuning": {"RESIDENT_BUDGET_BYTES"},
    # TPU vreg geometry and the Pallas interpret switch
    "kernels.common": {"INTERPRET", "LANES", "SUBLANES"},
    # the TPU and interpret-mode backend priors; the port's priors are
    # keyed by backend in the tuning registry
    "sparse.dispatch": {"DEFAULT_MERGE_INTERPRET", "DEFAULT_MERGE_TPU",
                        "DEFAULT_METHOD_INTERPRET", "DEFAULT_METHOD_TPU"},
    # the port's shards are a leading tensor axis; sparse/sharded.py maps
    # over them
    "core.compat": {"shard_map"},
    # B3', B6 and B4 return segment results, not prefix scans: the
    # reference's names would change meaning
    "kernels.segment_sum.segment_sum": {"gather_masked_cumsum",
                                        "gather2_masked_cumsum",
                                        "gather_masked_segscan"},
    # the package re-exports the three above and the interpret switch
    "kernels": {"INTERPRET", "gather_masked_cumsum",
                "gather2_masked_cumsum", "gather_masked_segscan"},
    # no scan to unroll (the layer loop is a Python loop)
    "models.runtime_flags": {"UNROLL", "set_unroll", "unroll"},
}


def _module_files(root: str):
    base = SRC / root
    out = {}
    for pkg in PACKAGES:
        for path in sorted((base / pkg).rglob("*.py")):
            if path.name == "__main__.py":
                continue
            rel = path.relative_to(base).with_suffix("")
            parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
            out[".".join(parts)] = path
    return out


def _public_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return {e.value for e in node.value.elts}
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and node.level == 1
              and path.name == "__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


REF = _module_files("repro")
PORT = _module_files("repro_torch")
MIRRORED = sorted(set(REF) & set(PORT))


def _module(name: str):
    # the serving launchers tune os.environ at import: keep it as it was
    env = dict(os.environ)
    try:
        importlib.import_module(name)
    finally:
        os.environ.clear()
        os.environ.update(env)
    return sys.modules[name]


@pytest.mark.parametrize("mod", MIRRORED)
def test_mirrored_module_exports_the_reference_names(mod):
    want = _public_names(REF[mod]) - ABSENT.get(mod, set())
    ref = _module(f"repro.{mod}")
    assert [n for n in sorted(want) if not hasattr(ref, n)] == []
    port = _module(f"repro_torch.{mod}")
    assert [n for n in sorted(want) if not hasattr(port, n)] == []


def test_the_listed_absences_are_still_absent():
    present = [f"{mod}.{n}" for mod, names in ABSENT.items()
               for n in sorted(names)
               if hasattr(_module(f"repro_torch.{mod}"), n)]
    assert present == []
    assert set(ABSENT) <= set(MIRRORED)
    listed = {(mod, n) for mod, names in ABSENT.items() for n in names}
    assert all(n in _public_names(REF[mod]) for mod, n in listed)


def test_the_absent_modules_are_the_listed_ones():
    assert set(REF) - set(PORT) == set(ABSENT_MODULES)


def test_c1_imports_succeed():
    from repro_torch.kernels.radix_sort import (DigitPass,  # noqa: F401
                                                plan_digit_passes,
                                                radix_pass_rank,
                                                radix_sort_pair)
    from repro_torch.kernels.spmv_sym import (spmv_bsr,  # noqa: F401
                                              spmv_bsr_ref, spmv_sym,
                                              spmv_sym_ref)


def test_submodule_imports_keep_the_package_functions():
    """``repro_torch.kernels.spmv``/``.spmv_sym`` stay the functions the
    package's properties hold, whatever submodule was imported."""
    import repro_torch.kernels as K
    from repro_torch.kernels.spmv.ops import spmv
    from repro_torch.kernels.spmv_sym.ops import spmv_sym

    for mod in MIRRORED:
        if mod.startswith("kernels"):
            _module(f"repro_torch.{mod}")
    importlib.import_module("repro_torch.kernels.spmv_sym.spmv_sym")
    importlib.import_module("repro_torch.kernels.spmv.spmv")
    assert K.spmv is spmv and K.spmv_sym is spmv_sym
    assert sys.modules["repro_torch.kernels.spmv_sym"].spmv_sym is spmv_sym


@pytest.mark.parametrize("L,vmax,shift,bits", [
    (1000, 5000, 0, 7), (1000, 5000, 7, 6), (257, 255, 0, 8),
])
def test_radix_pass_rank_matches_reference(L, vmax, shift, bits):
    from repro_torch.kernels.radix_sort import radix_pass_rank
    from repro_torch.kernels.radix_sort.ops import radix_pass_positions

    rng = np.random.default_rng(L + shift)
    keys = rng.integers(0, vmax + 1, L).astype(np.int32)
    nbins = (vmax >> shift) + 1 if shift + bits >= vmax.bit_length() \
        else 1 << bits
    got = radix_pass_rank(torch.from_numpy(keys), shift=shift, bits=bits,
                          nbins=nbins)
    want = jax_radix_pass_rank(jnp.asarray(keys), shift=shift, bits=bits,
                               nbins=nbins, block_b=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(digit_rank_ref(jnp.asarray(keys),
                                               shift=shift, bits=bits)))
    pos = radix_pass_positions(torch.from_numpy(keys), shift=shift,
                               bits=bits, nbins=nbins)
    assert torch.equal(pos[got.long()], torch.arange(L, dtype=torch.int32))
