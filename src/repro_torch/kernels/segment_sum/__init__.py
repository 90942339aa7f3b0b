"""Numeric phase (counterpart of ``repro.kernels.segment_sum``).

  segment_sum.py  wrappers of the B3' (fused segment sum), B4 (fused
                  segment min/max) and B5 (prefix sum) CUDA kernels
  ops.py          the fills' dtype contract and every ``accum`` mode
  ref.py          plain-PyTorch versions
"""
