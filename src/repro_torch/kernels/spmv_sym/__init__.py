"""Fused both-triangles symmetric SpMV + blocked (BSR) SpMV
(counterpart of ``repro.kernels.spmv_sym``).

  spmv_sym.py  wrappers of the B9 (symmetric streams) and B10 (BSR
               tiles) CUDA kernels
  ops.py       the two SpMVs around them
  ref.py       plain-PyTorch versions
"""
