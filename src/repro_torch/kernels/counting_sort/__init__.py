"""Part 2 of the counting-sort planner (counterpart of
``repro.kernels.counting_sort``).

  counting_sort.py  wrapper of the B11 CUDA kernel (stable placement)
  ops.py            ``counting_sort`` -> ``(rank, positions)``
  ref.py            plain-PyTorch versions
"""
