"""Plain PyTorch oracles of the kernels on the port's path.

Ports of ``repro.kernels.ref.attention_ref`` and
``paged_decode_attention_ref``, operation for operation: products in the
input dtype, scores in float32, masks with -1e30, probabilities cast back
to the query dtype before the value product.  The CPU tests hold these
against the JAX oracles; ``chip_smoke.py`` holds the CUDA kernels against
them on the card.  Where the JAX oracle relies on dtype promotion (float32
queries against a bfloat16 pool), the pool is cast to the query dtype
first, which is the value-exact equivalent.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, S, hd); k, v: (BH, T, hd) -> (BH, S, hd).  Causal offset
    ``T - S``: query row i sees keys j <= i + T - S."""
    BH, S, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqd,bkd->bqk", q, k.to(q.dtype)).float() * scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        s = torch.where(kpos <= qpos + (T - S), s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v.to(q.dtype))


def paged_decode_attention_ref(q, k_pages, v_pages, k_new, v_new, tables,
                               lengths):
    """Gather-then-attend oracle of the paged decode kernel.

    q: (B,KV,G,hd); k_pages/v_pages: (NP,BS,KV,hd); k_new/v_new:
    (B,KV,1,hd); tables: (B,NBT) int32; lengths: (B,) int32.  Attends over
    pool positions [0, lengths[b]) plus the explicit new token; a row with
    length 0 returns ``v_new``.
    """
    B, KV, G, hd = q.shape
    BS = k_pages.shape[1]
    NBT = tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    tl = tables.long()
    kc = k_pages[tl].reshape(B, NBT * BS, KV, hd).to(q.dtype)
    vc = v_pages[tl].reshape(B, NBT * BS, KV, hd).to(q.dtype)
    s = torch.einsum("bhgd,bkhd->bhgk", q, kc).float() * scale
    pos = torch.arange(NBT * BS, device=q.device)[None, None, None, :]
    mask = pos < lengths.long()[:, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s_cur = torch.einsum("bhgd,bhqd->bhgq", q, k_new.to(q.dtype)).float() \
        * scale
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_cur)
    p = torch.exp(s - m)
    p_cur = torch.exp(s_cur - m)
    denom = p.sum(dim=-1, keepdim=True) + p_cur
    out = torch.einsum("bhgk,bkhd->bhgd", (p / denom).to(q.dtype), vc)
    return out + (p_cur / denom).to(q.dtype) * v_new.to(q.dtype)
