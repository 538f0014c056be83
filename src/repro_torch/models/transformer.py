"""Dense decoder-only transformer of the port (``tp=1``, no mesh).

Port of the dense family of ``repro/models/transformer.py``.  Layer
weights stay stacked along a leading L dim, as in the JAX parameter tree;
the layer loop is a Python loop over ``l`` (the JAX ``lax.scan``).  The
KV cache is updated IN PLACE (``index_put_``) where the JAX package
donated the carried cache to XLA for aliasing; decode still reads the
old cache and passes the current token's K/V to attention explicitly
(write-then-attend), so the values match the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.model_config import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (
    ParamDef, apply_rope, rmsnorm, swiglu, torch_dtype,
)


# --------------------------------------------------------------- geometry

@dataclasses.dataclass(frozen=True)
class Geometry:
    """Head/vocab sizes at tensor-parallel degree 1 (the JAX package pads
    them to a TP-divisible count; at tp=1 nothing is padded)."""

    tp: int
    heads: int
    kv_heads: int
    vocab: int

    @staticmethod
    def of(cfg: ModelConfig, tp: int = 1) -> "Geometry":
        if tp != 1:
            raise NotImplementedError(
                "tensor parallelism is not ported (ROADMAP.md queue 1, "
                "item 14: parallel/ onto torch DeviceMesh)")
        heads = max(cfg.num_heads, 1)
        kv = heads if cfg.num_kv_heads == cfg.num_heads else cfg.num_kv_heads
        return Geometry(tp=1, heads=heads, kv_heads=kv, vocab=cfg.vocab_size)


def kv_index_for(cfg: ModelConfig, geom: Geometry):
    """Static q-head -> kv-head map, or None when identity."""
    if geom.kv_heads == geom.heads:
        return None
    return attn_lib.kv_head_index(cfg.num_heads, cfg.num_kv_heads,
                                  geom.heads)


# ------------------------------------------------------------- param defs

def transformer_defs(cfg: ModelConfig, geom: Geometry) -> dict:
    """Dense swiglu parameter tree, same names and shapes as the JAX
    package's ``transformer_defs`` (and the same insertion order)."""
    if cfg.family != "dense" or cfg.mlp_type != "swiglu":
        raise NotImplementedError(
            f"family {cfg.family!r}/{cfg.mlp_type!r} is not ported "
            f"(ROADMAP.md queue 1, item 13)")
    d, L, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
    hd = cfg.resolved_head_dim
    Hp, KV, Vp = geom.heads, geom.kv_heads, geom.vocab
    H = cfg.num_heads
    attn = {
        "wq": ParamDef((L, d, Hp, hd), "scaled", mask_dims={2: H}),
        "wk": ParamDef((L, d, KV, hd), "scaled",
                       mask_dims={2: cfg.num_kv_heads}),
        "wv": ParamDef((L, d, KV, hd), "scaled",
                       mask_dims={2: cfg.num_kv_heads}),
        "wo": ParamDef((L, Hp, hd, d), "scaled", mask_dims={1: H}),
    }
    if cfg.qkv_bias:
        attn["bq"] = ParamDef((L, Hp, hd), "zeros", mask_dims={1: H})
        attn["bk"] = ParamDef((L, KV, hd), "zeros",
                              mask_dims={1: cfg.num_kv_heads})
        attn["bv"] = ParamDef((L, KV, hd), "zeros",
                              mask_dims={1: cfg.num_kv_heads})
    mlp = {
        "w_gate": ParamDef((L, d, ff), "scaled"),
        "w_up": ParamDef((L, d, ff), "scaled"),
        "w_down": ParamDef((L, ff, d), "scaled"),
    }
    layers = {
        "attn": attn,
        "mlp": mlp,
        "ln1": ParamDef((L, d), "ones", dtype="float32"),
        "ln2": ParamDef((L, d), "ones", dtype="float32"),
    }
    embed = {"table": ParamDef((Vp, d), "normal",
                               mask_dims={0: cfg.vocab_size})}
    head = ({} if cfg.tie_embeddings
            else {"w": ParamDef((d, Vp), "scaled")})
    return {"embed": embed, "layers": layers,
            "final_norm": ParamDef((d,), "ones", dtype="float32"),
            "head": head}


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s slice of the stacked layer tree (views, no copy)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[li]
    return pick(params["layers"])


# ---------------------------------------------------------------- blocks

def qkv_project(x, lp, cfg: ModelConfig, positions):
    """x: (B,S,d) -> q (B,S,Hp,hd), k, v (B,S,KV,hd) with RoPE applied."""
    ap = lp["attn"]
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"])
    if cfg.qkv_bias:
        q = q + ap["bq"]
        k = k + ap["bk"]
        v = v + ap["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(x, lp, cfg: ModelConfig, geom: Geometry, grouping, *,
                    positions, backend: str):
    """Prefill attention block.  Returns (out, (k, v)).  ``backend="cuda"``
    runs kernel A (the JAX ``transformer.py:198`` ACCEL route)."""
    q, k, v = qkv_project(x, lp, cfg, positions)
    if backend == "cuda":
        out = attn_lib.flash_attention_hybrid(q, k, v, grouping)
    else:
        out = attn_lib.attention(q, k, v, causal=True,
                                 kv_index=kv_index_for(cfg, geom))
    out = torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"])
    return out, (k, v)


def dense_mlp_block(x, lp, cfg: ModelConfig):
    mp = lp["mlp"]
    return swiglu(x, mp["w_gate"], mp["w_up"], mp["w_down"])


def layer_body(x, lp, cfg: ModelConfig, geom: Geometry, grouping, *,
               positions, backend: str):
    h, kv = attention_block(rmsnorm(x, lp["ln1"], cfg.norm_eps), lp, cfg,
                            geom, grouping, positions=positions,
                            backend=backend)
    x = x + h
    h = dense_mlp_block(rmsnorm(x, lp["ln2"], cfg.norm_eps), lp, cfg)
    return x + h, kv


# --------------------------------------------------------------- embed/IO

def embed_inputs(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["table"][tokens.long()]


def output_logits(params, x, cfg: ModelConfig) -> torch.Tensor:
    w = (params["embed"]["table"].t() if cfg.tie_embeddings
         else params["head"]["w"])
    return torch.einsum("bsd,dv->bsv", x, w)


# ------------------------------------------------------------- full model

def forward_prefill(params, tokens, cfg: ModelConfig, geom: Geometry,
                    grouping, *, backend: str, last_index=None):
    """Prefill over (B, S) tokens at positions 0..S-1.

    Returns (logits, cache) where cache leaves are (L, B, S, KV, hd) in
    ``kv_cache_dtype``.  With ``last_index`` (B,) the logits are taken at
    each row's position only, (B, 1, V) — the same rows of the same
    product, without projecting every padded position onto the vocab."""
    attn_lib.check_backend(backend)
    x = embed_inputs(params, tokens)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = layer_body(x, layer_params(params, li), cfg, geom,
                               grouping, positions=positions,
                               backend=backend)
        ks.append(k)
        vs.append(v)
    if last_index is not None:
        x = x[torch.arange(B, device=x.device), last_index.long()][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    cdt = torch_dtype(cfg.kv_cache_dtype)
    cache = {"k": torch.stack(ks).to(cdt), "v": torch.stack(vs).to(cdt)}
    return output_logits(params, x, cfg), cache


def _decode_layer_tail(x, out, lp, cfg):
    x = x + torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"])
    return x + dense_mlp_block(rmsnorm(x, lp["ln2"], cfg.norm_eps), lp, cfg)


def forward_decode(params, cache, tokens, index, cfg: ModelConfig,
                   geom: Geometry, grouping, *, backend: str,
                   block_table=None):
    """One decode step of (B, 1) tokens at per-row positions ``index``.

    Dense cache (L, B, Smax, KV, hd), or with ``block_table`` (B, NBT) a
    paged pool (L, NP, BS, KV, hd).  Each layer reads the OLD cache with
    the current token's K/V passed explicitly, then writes that K/V into
    the cache in place.  Returns (logits (B, 1, V), cache)."""
    attn_lib.check_backend(backend)
    x = embed_inputs(params, tokens)
    B = x.shape[0]
    idx = index.long()
    positions = idx[:, None]
    kv_idx = kv_index_for(cfg, geom)
    rows = torch.arange(B, device=x.device)
    ck, cv = cache["k"], cache["v"]
    if block_table is not None:
        bs = ck.shape[2]
        blk = block_table.long().gather(1, (idx // bs)[:, None])[:, 0]
        off = idx % bs
    elif backend == "cuda":
        dense_tables = kernel_ops.identity_tables(B, ck.shape[2], x.device)
    for li in range(cfg.num_layers):
        lp = layer_params(params, li)
        xn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(xn, lp, cfg, positions)
        if block_table is not None:
            if backend == "cuda":
                out = kernel_ops.paged_gqa_decode(
                    q, ck[li], cv[li], k, v, block_table, index, grouping)
            else:
                out = attn_lib.paged_decode_attention(
                    q, ck[li], cv[li], block_table, index, k, v,
                    kv_index=kv_idx)
            ck[li].index_put_((blk, off), k[:, 0].to(ck.dtype))
            cv[li].index_put_((blk, off), v[:, 0].to(cv.dtype))
        else:
            if backend == "cuda":
                out = kernel_ops.gqa_decode_ragged(
                    q, ck[li], cv[li], index, k, v, grouping,
                    tables=dense_tables)
            else:
                out = attn_lib.decode_attention(
                    q, ck[li].to(x.dtype), cv[li].to(x.dtype),
                    idx[:, None, None, None], k, v, kv_index=kv_idx)
            ck[li].index_put_((rows, idx), k[:, 0].to(ck.dtype))
            cv[li].index_put_((rows, idx), v[:, 0].to(cv.dtype))
        x = _decode_layer_tail(x, out, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return output_logits(params, x, cfg), cache

