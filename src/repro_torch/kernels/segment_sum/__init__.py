"""Numeric phase (counterpart of ``repro.kernels.segment_sum``).

  segment_sum.py  wrappers of the B3' (fused segment sum), B4 (fused
                  segment min/max), B5 (prefix sum) and B6 (fused
                  product segment sum, the SpGEMM fill) CUDA kernels
  ops.py          the fills' dtype contract and every ``accum`` mode
  ref.py          plain-PyTorch versions
"""
