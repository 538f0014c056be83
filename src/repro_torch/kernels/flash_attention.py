"""Kernel A: causal flash prefill (CUDA, ``csrc/flash_prefill.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
``flash_prefill`` launches the hand-written kernel for CUDA tensors and runs
``flash_prefill_plain`` (the port of ``ref.attention_ref`` at the kernel's
layout) for CPU tensors; any other placement raises.  Each launch adds one
to ``flash_prefill.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _launch, ref

HEAD_DIMS = (64,)              # built for smollm-135m's head_dim


def flash_prefill_plain(q, k, v, kv_map):
    """q: (B,S,H,hd); k, v: (B,T,KV,hd); kv_map: (H,) kv head of each query
    head -> (B,S,H,hd).  Head-expands KV and runs ``ref.attention_ref``."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    idx = kv_map.long()
    qf = q.transpose(1, 2).reshape(B * H, S, hd)
    kf = k[:, :, idx].transpose(1, 2).reshape(B * H, T, hd)
    vf = v[:, :, idx].transpose(1, 2).reshape(B * H, T, hd)
    out = ref.attention_ref(qf, kf, vf, causal=True)
    return out.reshape(B, H, S, hd).transpose(1, 2)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_map: torch.Tensor) -> torch.Tensor:
    """Causal attention, query row i seeing keys j <= i + T - S.

    q: (B,S,H,hd); k, v: (B,T,KV,hd), T >= S; kv_map: (H,) int32.  All
    contiguous; q, k, v float32 or bfloat16 of one dtype; hd 64 (the only
    head_dim built).  Returns (B,S,H,hd) in q's dtype."""
    if _launch.placement(q, k, v, kv_map) == "cpu":
        return flash_prefill_plain(q, k, v, kv_map)
    B, S, H, hd = q.shape
    _launch.require(k.dim() == 4 and k.shape == v.shape,
                    f"k/v shapes {tuple(k.shape)} {tuple(v.shape)}")
    _, T, KV, hdk = k.shape
    _launch.require(k.shape[0] == B and hdk == hd, "q/k batch or hd mismatch")
    _launch.require(T >= S, f"kv length {T} < query length {S}")
    _launch.require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _launch.require(q.dtype == k.dtype == v.dtype,
                    f"dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    _launch.require(kv_map.dtype == torch.int32 and kv_map.shape == (H,),
                    "kv_map must be (H,) int32")
    _launch.require_contiguous(q=q, k=k, v=v, kv_map=kv_map)
    code = _launch.dtype_code("q", q)
    out = torch.empty_like(q)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _launch.c_function(
        "flash_prefill", "flash_prefill_launch",
        [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_map.data_ptr(), B, S, T, H, KV, hd, code,
            1.0 / math.sqrt(hd), _launch.stream_ptr(q))
    _launch.check_rc(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
