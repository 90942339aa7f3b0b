"""Fused numeric fill (counterpart of ``repro.kernels.segment_sum``).

  segment_sum.py  wrapper of the B3' CUDA kernel
  ops.py          the fill's dtype contract
  ref.py          plain-PyTorch version
"""
