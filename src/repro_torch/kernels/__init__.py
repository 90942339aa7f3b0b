"""repro_torch.kernels: the hand-written CUDA kernels and their wrappers.

Layout (counterpart of ``repro.kernels``):
  radix_sort/     Parts 1-3: LSD radix planner (B1 digit histogram,
                  B2 stable placement fused with the payload scatter)
  segment_sum/    numeric phase: fused gather + mask + segment sum (B3')
  assembly_ops    end-to-end kernel-backed assembly
  common          integer helpers, the nvcc build and ctypes binding
"""
