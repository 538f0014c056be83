"""Attention paths of the port: HOST math and the ACCEL kernel routes.

Port of ``repro/models/attention.py`` (dense, non-int8 subset).  The
``backend="ref"`` branches mirror the JAX package's ``backend="xla"``
reference math line for line: explicit products, masks and softmax in
plain PyTorch (never ``scaled_dot_product_attention``, which dispatches a
fused kernel of its own).  ``backend="cuda"`` routes the same ABI through
the hand-written kernels in ``repro_torch.kernels.ops`` (the JAX
``backend="pallas"`` branches).

GQA: query heads map to kv heads through ``kv_head_index``; the HOST math
head-expands K/V exactly like the reference, the kernels read the kv head
directly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import torch_dtype

BACKENDS = ("ref", "cuda")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")


def kv_head_index(num_heads: int, num_kv_heads: int,
                  padded_heads: int) -> np.ndarray | None:
    """Static map: query head -> kv head (padded heads clamp to the last).
    None when the map is the identity (MHA, no padding)."""
    group = max(num_heads // num_kv_heads, 1)
    idx = np.minimum(np.arange(padded_heads), num_heads - 1) // group
    idx = np.minimum(idx, num_kv_heads - 1)
    if len(idx) == num_kv_heads and np.array_equal(idx, np.arange(num_kv_heads)):
        return None
    return idx


def _expand(t: torch.Tensor, kv_index) -> torch.Tensor:
    if kv_index is None:
        return t
    return t[:, :, torch.as_tensor(kv_index, dtype=torch.long,
                                   device=t.device)]


def plain_attention(q, k, v, *, causal: bool = True, kv_index=None):
    """q: (B,S,Hp,hd)  k,v: (B,T,KV,hd) -> (B,S,Hp,hd).  O(S*T) memory.

    The JAX package switches to a blockwise online-softmax form above
    8192 query positions to bound memory; the values are the same, and
    the port's serve path stays far below that length."""
    B, S, Hp, hd = q.shape
    T = k.shape[1]
    k = _expand(k, kv_index)
    v = _expand(v, kv_index)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos + (T - S), scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


attention = plain_attention


class FlashAttentionHybrid(torch.autograd.Function):
    """Causal flash attention: kernel A forward, reference backward.

    The forward runs the hand-written prefill kernel (no S x S score
    matrix in device memory); the backward recomputes through
    ``plain_attention`` — the JAX package's ``custom_vjp`` pairing of
    ``flash_attention_hybrid``.  q: (B,S,Hp,hd); k/v: (B,T,KV,hd)."""

    @staticmethod
    def forward(ctx, q, k, v, grouping):
        ctx.save_for_backward(q, k, v)
        ctx.grouping = grouping
        return kernel_ops.flash_attention(q, k, v, grouping)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        kv_map = ctx.grouping.kv_map.cpu().numpy()
        with torch.enable_grad():
            q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
            out = plain_attention(q_, k_, v_, causal=True, kv_index=kv_map)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None


def flash_attention_hybrid(q, k, v, grouping):
    return FlashAttentionHybrid.apply(q, k, v, grouping)


# ------------------------------------------------------------------ cache

def init_kv_cache(num_layers: int, batch: int, max_seq: int,
                  num_kv_heads: int, head_dim: int, dtype: str,
                  device) -> dict:
    shape = (num_layers, batch, max_seq, num_kv_heads, head_dim)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_kv_cache(num_layers: int, num_blocks: int, block_size: int,
                        num_kv_heads: int, head_dim: int, dtype: str,
                        device) -> dict:
    """Block-pool KV cache (L, num_blocks, block_size, KV, hd); logical
    position p of a row lives at (table[p // block_size], p % block_size).
    ``num_blocks`` counts PHYSICAL blocks, including the reserved junk
    block 0."""
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(q, k_cache, v_cache, index, k_new, v_new,
                     kv_index=None):
    """HOST single-token attention over a dense cache (the ``xla`` branch
    of the JAX ``decode_attention`` with an explicit current token).

    q: (B,1,Hp,hd); k_cache/v_cache: (B,Smax,KV,hd); ``index`` (B,1,1,1)
    per-row positions; k_new/v_new: (B,1,KV,hd).  Attends cache[0, index)
    plus the current token, so the caller reads the old cache and writes
    the new entry independently.  (The JAX form without ``k_new`` runs
    kernel C, which is not ported: ROADMAP.md queue 2.)"""
    B, _, Hp, hd = q.shape
    Smax = k_cache.shape[1]
    k_cache = _expand(k_cache, kv_index)
    v_cache = _expand(v_cache, kv_index)
    k_new = _expand(k_new, kv_index)
    v_new = _expand(v_new, kv_index)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float() * scale
    positions = torch.arange(Smax, device=q.device)[None, None, None, :]
    scores = torch.where(positions < index, scores,
                         torch.full_like(scores, NEG_INF))
    s_cur = torch.einsum("bqhd,bkhd->bhqk", q, k_new).float() * scale
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_cur)
    p = torch.exp(scores - m)
    p_cur = torch.exp(s_cur - m)
    denom = p.sum(dim=-1, keepdim=True) + p_cur
    out = torch.einsum("bhqk,bkhd->bqhd", (p / denom).to(q.dtype), v_cache)
    return out + torch.einsum("bhqk,bkhd->bqhd",
                              (p_cur / denom).to(q.dtype), v_new)


def paged_decode_attention(q, k_pages, v_pages, table, index, k_new, v_new,
                           kv_index=None):
    """HOST single-token attention over one layer of a paged pool: gather
    the row's blocks in logical order, then ``decode_attention`` (the
    ``xla`` branch of the JAX ``paged_decode_attention``).  The gathered
    rows are cast to q's dtype after the gather, which gives the values
    of the reference's cast of the whole pool layer."""
    B = q.shape[0]
    NBT = table.shape[1]
    BS = k_pages.shape[1]
    tl = table.long()
    kc = k_pages[tl].reshape(B, NBT * BS, *k_pages.shape[2:]).to(q.dtype)
    vc = v_pages[tl].reshape(B, NBT * BS, *v_pages.shape[2:]).to(q.dtype)
    return decode_attention(q, kc, vc, index[:, None, None, None], k_new,
                            v_new, kv_index=kv_index)
