"""Hand-written CUDA kernels of the port, each beside its plain version.

``flash_attention.flash_prefill`` (kernel A) and ``gqa_decode.paged_decode``
(kernel B) are built from ``csrc/`` on first use (``_build``); ``ref`` holds
the plain oracles; ``ops`` the model-facing wrappers.
"""
