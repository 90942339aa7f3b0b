"""Padded-ELL SpMV (counterpart of ``repro.kernels.spmv``).

  spmv.py  wrapper of the B8 CUDA kernel
  ops.py   the CSC -> ELL conversion and the SpMV entry point
  ref.py   plain-PyTorch version
"""
