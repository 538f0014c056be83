"""PyTorch / CUDA port of the Xar-Trek reproduction.

A package beside the JAX reference ``repro``, with the same layout
(``configs``, ``kernels``, ``models``, ``core``, ``serve``).  It imports
``torch`` and ``numpy`` only.  HOST step builds are plain eager PyTorch;
ACCEL step builds run hand-written CUDA kernels for Hopper (``sm_90a``),
built from ``kernels/csrc`` on first use.
"""
