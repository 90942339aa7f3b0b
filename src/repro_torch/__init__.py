"""repro_torch: the PyTorch/CUDA port of the ``repro`` sparse assembly.

Mirrors the JAX package's module tree file for file.  Plain tensor code
is PyTorch; every kernel the JAX package wrote in Pallas for the TPU is
a CUDA C++ kernel for Hopper (``csrc/``), built at first use and bound
with ctypes.  Entry points that take host data run on the card unless
the caller passes ``device="cpu"``, where each kernel runs its plain
PyTorch version.  The package imports nothing of JAX or of ``repro``.
"""
