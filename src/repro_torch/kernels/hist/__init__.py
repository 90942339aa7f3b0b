"""Part 1 of the counting-sort planner (counterpart of
``repro.kernels.hist``).

  hist.py  wrapper of the B12 CUDA kernel (per-block histogram)
  ops.py   ``histogram``, ``block_offsets`` and the block size
  ref.py   plain-PyTorch versions
"""
