"""Kernel B: paged GQA decode (CUDA, ``csrc/paged_decode.cu``).

Replaces the TPU kernel ``repro/kernels/gqa_decode.py::paged_gqa_decode``.
``paged_decode`` launches the hand-written kernel for CUDA tensors and runs
``paged_decode_plain`` (the port of ``ref.paged_decode_attention_ref``) for
CPU tensors; any other placement raises.  Each launch adds one to
``paged_decode.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _launch, ref

HEAD_DIMS = (64,)              # built for smollm-135m's head_dim
# (q dtype, pool dtype) pairs the kernel is built for
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16))
MAX_GROUP = 8

paged_decode_plain = ref.paged_decode_attention_ref


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,KV,G,hd); k_pages/v_pages: (NP,BS,KV,hd); k_new/v_new:
    (B,KV,1,hd); tables: (B,NBT) int32; lengths: (B,) int32.

    Attends pool positions [0, lengths[b]) through the block table plus the
    current token; a row with length 0 returns ``v_new``.  q, k_new, v_new
    share one dtype and the pools another, one of ``DTYPE_PAIRS``; the
    pools are read in their own dtype; hd is 64.  Block ids must lie in
    [0, NP) and lengths in [0, NBT*BS]: the kernel trusts the table, as
    the serve engine builds it.  Returns (B,KV,G,hd) in q's dtype."""
    if _launch.placement(q, k_pages, v_pages, k_new, v_new, tables,
                         lengths) == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, k_new, v_new, tables,
                                  lengths)
    B, KV, G, hd = q.shape
    NP, BS, KVp, hdp = k_pages.shape
    _launch.require(v_pages.shape == k_pages.shape, "k/v pool shapes differ")
    _launch.require(KVp == KV and hdp == hd, "q/pool kv heads or hd differ")
    _launch.require(k_new.shape == (B, KV, 1, hd) == v_new.shape,
                    f"k_new/v_new must be {(B, KV, 1, hd)}")
    _launch.require(tables.dim() == 2 and tables.shape[0] == B
                    and tables.dtype == torch.int32, "tables must be (B,NBT) int32")
    _launch.require(lengths.shape == (B,) and lengths.dtype == torch.int32,
                    "lengths must be (B,) int32")
    _launch.require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _launch.require(1 <= G <= MAX_GROUP, f"group {G} not in 1..{MAX_GROUP}")
    _launch.require(k_new.dtype == v_new.dtype == q.dtype,
                    "q/k_new/v_new dtypes differ")
    _launch.require(k_pages.dtype == v_pages.dtype, "pool dtypes differ")
    _launch.require((q.dtype, k_pages.dtype) in DTYPE_PAIRS,
                    f"q {q.dtype} over a {k_pages.dtype} pool is not built")
    _launch.require_contiguous(q=q, k_pages=k_pages, v_pages=v_pages,
                               k_new=k_new, v_new=v_new, tables=tables,
                               lengths=lengths)
    qc = _launch.dtype_code("q", q)
    pc = _launch.dtype_code("pool", k_pages)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _launch.c_function(
        "paged_decode", "paged_decode_launch",
        [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p])
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, KV, G, hd, BS,
            tables.shape[1], qc, pc, 1.0 / math.sqrt(hd),
            _launch.stream_ptr(q))
    _launch.check_rc(rc, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
