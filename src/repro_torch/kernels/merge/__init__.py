"""Merge positioning search (counterpart of ``repro.kernels.merge``).

  merge.py  wrapper of the B7 CUDA kernel
  ops.py    the entry point ``merge_search``
  ref.py    plain-PyTorch version
"""
