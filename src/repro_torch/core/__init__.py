"""repro_torch.core: triplet and CSC containers, the numpy oracle, the
paper's data sets, its Parts 1-4 and the one-shot entry points
(counterpart of ``repro.core``).

Unlike the reference, the package does not re-export the generator
function ``ransparse``: that name stays the submodule
(``from repro_torch.core import ransparse`` is the module).
"""
from .coo import COO, coo_from_matlab, coo_to_dense
from .csc import CSC, csc_to_dense, spmv, spmv_t
from .assemble import (AssemblyIntermediate, assemble, assemble_arrays,
                       assemble_fused, assembly_intermediates,
                       counting_sort_positions, part1_count_rows, part2_rank,
                       part3_unique, part4_finalize, postprocess)
from .compat import resolve_method_arg
from .fsparse import fsparse, fsparse_coo
from .ransparse import DATA_SETS, dataset

# two-phase API re-exports (canonical home: repro_torch.sparse); submodule
# imports keep this safe while repro_torch.sparse is mid-initialization
from ..sparse.formats import CSR, SparseMatrix, convert
from ..sparse.pattern import SparsePattern, plan, plan_coo

__all__ = [
    "AssemblyIntermediate", "COO", "CSC", "CSR", "DATA_SETS",
    "SparseMatrix", "SparsePattern", "assemble", "assemble_arrays",
    "assemble_fused", "assembly_intermediates", "convert", "coo_from_matlab",
    "coo_to_dense", "counting_sort_positions", "csc_to_dense", "dataset",
    "fsparse", "fsparse_coo", "part1_count_rows", "part2_rank",
    "part3_unique", "part4_finalize", "plan", "plan_coo", "postprocess",
    "resolve_method_arg", "spmv", "spmv_t",
]
