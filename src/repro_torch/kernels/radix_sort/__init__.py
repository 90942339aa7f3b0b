"""LSD radix-partition planner (counterpart of
``repro.kernels.radix_sort``).

  radix_sort.py  wrappers of the B1/B2 CUDA kernels
  ops.py         digit planning + the multi-pass sort
  ref.py         plain-PyTorch versions
"""
from .ops import (DigitPass, plan_digit_passes, radix_pass_rank,
                  radix_sort_pair)

__all__ = [
    "DigitPass",
    "plan_digit_passes",
    "radix_pass_rank",
    "radix_sort_pair",
]
