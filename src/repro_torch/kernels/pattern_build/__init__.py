"""Parts 3-4 of the plan (no counterpart in ``repro.kernels``: the
reference leaves them to XLA).

  ops.py  ``pattern_build``, ``pattern_build_sorted``: the wrapper of the
          CUDA pass (``csrc/pattern_build.cu``) and its entries
  ref.py  plain-PyTorch versions
"""
