"""Model-facing wrappers around the hand-written kernels.

The port of ``repro/kernels/ops.py`` for the two kernels on the serve path:
GQA grouping of query heads by kv head, the dense-cache-as-paged-pool view,
and the (B, S, H, hd) layouts the model uses.  The TPU lane padding of the
JAX wrappers (``_pad_lanes``, ``lane_align``) has no counterpart: the CUDA
kernels take the real head_dim.  Launch counts live on the kernel wrappers
(``flash_attention.flash_prefill.launches``,
``gqa_decode.paged_decode.launches``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_prefill
from repro_torch.kernels.gqa_decode import paged_decode


def kv_grouping(Hp: int, KV: int, kv_index):
    """Static grouping of query heads by the kv head they attend.

    Returns (kvmap, pos, qhead_for, G): query head h reads kv head
    ``kvmap[h]`` at group rank ``pos[h]``; group slot (kv, g) holds query
    head ``qhead_for[kv, g]``.  Non-uniform groups size G to the largest
    one; surplus slots repeat head 0 and are never read back.
    """
    kvmap = (np.arange(Hp) if kv_index is None
             else np.asarray(kv_index, np.int32))
    counts = np.bincount(kvmap, minlength=KV)
    G = max(int(counts.max()), 1)
    qhead_for = np.zeros((KV, G), np.int32)
    pos = np.zeros(Hp, np.int32)
    fill = np.zeros(KV, np.int32)
    for h, kv in enumerate(kvmap):
        qhead_for[kv, fill[kv]] = h
        pos[h] = fill[kv]
        fill[kv] += 1
    return kvmap, pos, qhead_for, G


@dataclasses.dataclass
class KVGrouping:
    """Device-resident index tensors of one model's GQA grouping, built
    once so no step re-uploads them."""

    kv_map: torch.Tensor        # (Hp,) int32: kv head of each query head
    kvmap: torch.Tensor         # (Hp,) int64
    pos: torch.Tensor           # (Hp,) int64
    qhead_for: torch.Tensor     # (KV, G) int64
    G: int

    @staticmethod
    def build(Hp: int, KV: int, kv_index, device) -> "KVGrouping":
        kvmap, pos, qhead_for, G = kv_grouping(Hp, KV, kv_index)
        return KVGrouping(
            kv_map=torch.as_tensor(kvmap, dtype=torch.int32, device=device),
            kvmap=torch.as_tensor(kvmap, dtype=torch.int64, device=device),
            pos=torch.as_tensor(pos, dtype=torch.int64, device=device),
            qhead_for=torch.as_tensor(qhead_for, dtype=torch.int64,
                                      device=device),
            G=G)


def flash_attention(q, k, v, grouping: KVGrouping):
    """Causal prefill attention.  q: (B,S,Hp,hd); k/v: (B,T,KV,hd).  KV
    heads are read through ``grouping.kv_map`` inside the kernel (no
    head-expanded copy)."""
    return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                         grouping.kv_map)


def paged_gqa_decode(q, k_pages, v_pages, k_new, v_new, tables, index,
                     grouping: KVGrouping):
    """Paged decode attention.  q: (B,1,Hp,hd); k_pages/v_pages:
    (NP,BS,KV,hd); k_new/v_new: (B,1,KV,hd); tables: (B,NBT) int32;
    index: (B,) int32 valid pool positions.  Returns (B,1,Hp,hd)."""
    qg = q[:, 0][:, grouping.qhead_for].contiguous()       # (B,KV,G,hd)
    kn = k_new.transpose(1, 2).contiguous()                # (B,KV,1,hd)
    vn = v_new.transpose(1, 2).contiguous()
    out = paged_decode(qg, k_pages, v_pages, kn, vn, tables,
                       index.to(torch.int32).contiguous())
    return out[:, grouping.kvmap, grouping.pos][:, None]


def dense_block_size(Smax: int, block_k: int = 128) -> int:
    """Block size of the dense cache's paged view: the largest power-of-two
    fraction of ``block_k`` that divides ``Smax`` (``ops.py:447-450`` of the
    JAX package)."""
    bs = min(block_k, Smax)
    while Smax % bs:
        bs //= 2
    return bs


def identity_tables(B: int, Smax: int, device) -> torch.Tensor:
    """(B, Smax // bs) int32 identity block table of the dense view."""
    nb = Smax // dense_block_size(Smax)
    return torch.arange(B * nb, dtype=torch.int32, device=device).view(B, nb)


def gqa_decode_ragged(q, k_cache, v_cache, index, k_new, v_new,
                      grouping: KVGrouping, tables=None):
    """Dense-cache decode through the paged kernel.  k_cache/v_cache:
    (B,Smax,KV,hd) are VIEWED as B*nb blocks under an identity table (a
    reshape, not a copy); ``tables`` may pass that table in precomputed."""
    B, Smax, KV, hd = k_cache.shape
    bs = dense_block_size(Smax)
    kp = k_cache.view(B * (Smax // bs), bs, KV, hd)
    vp = v_cache.view(B * (Smax // bs), bs, KV, hd)
    if tables is None:
        tables = identity_tables(B, Smax, q.device)
    return paged_gqa_decode(q, kp, vp, k_new, v_new, tables, index, grouping)


def build(device) -> None:
    """Build and load every CUDA kernel when ``device`` is a card (the
    ACCEL step builds' setup); nothing to build for the CPU, where the
    wrappers run the plain versions."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.BUILDER.load_all()
