"""Model API of the port (dense subset of ``repro/models/model.py``).

``Model`` holds the config, the geometry and the device-resident GQA
index tensors, and exposes the step functions the serve engine
registers: ``prefill_at_sampled`` and ``decode_sampled``, each with a
``backend`` selector — ``"ref"`` (HOST: plain PyTorch mirroring the JAX
``xla`` branches) or ``"cuda"`` (ACCEL: kernels A and B).  Batches are
dicts of tensors on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.model_config import ModelConfig
from repro_torch.kernels.ops import KVGrouping
from repro_torch.models import attention as attn_lib
from repro_torch.models import sampling as sampling_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.transformer import Geometry


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and
    missing: an entry point never drops to the CPU on its own; callers
    that want the CPU say ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    geom: Geometry
    device: torch.device
    grouping: KVGrouping

    def defs(self) -> dict:
        return tf_lib.transformer_defs(self.cfg, self.geom)

    # ----------------------------------------------------------- forward
    def prefill_at(self, params, batch, backend: str = "ref"):
        """Prefill over right-padded prompts: batch {"tokens": (B, S_pad),
        "length": (B,)}.  Returns logits (B, 1, V) at each row's last REAL
        position and the padded cache (L, B, S_pad, KV, hd)."""
        idx = batch["length"].long() - 1
        return tf_lib.forward_prefill(params, batch["tokens"], self.cfg,
                                      self.geom, self.grouping,
                                      backend=backend, last_index=idx)

    def prefill_at_sampled(self, params, batch, backend: str = "ref"):
        """``prefill_at`` plus sampling of the first generated token at
        position = prompt length.  Returns ((B,) int32 tokens, (B,)
        float32 logprobs, cache)."""
        last, cache = self.prefill_at(params, batch, backend=backend)
        toks, logps = sampling_lib.sample_tokens(
            last[:, -1, :], batch["temperature"], batch["top_k"],
            batch["top_p"], batch["seed"], batch["length"])
        return toks, logps, cache

    def decode(self, params, cache, batch, backend: str = "ref"):
        """batch: {"tokens": (B, 1), "index": (B,) per-row positions,
        optional "block_table": (B, NBT)}.  Updates ``cache`` in place
        and returns (logits (B, 1, V), cache)."""
        return tf_lib.forward_decode(
            params, cache, batch["tokens"], batch["index"], self.cfg,
            self.geom, self.grouping, backend=backend,
            block_table=batch.get("block_table"))

    def decode_sampled(self, params, cache, batch, backend: str = "ref"):
        """``decode`` plus sampling at position index + 1.  Returns ((B,)
        int32 tokens, (B,) float32 logprobs, cache)."""
        logits, cache = self.decode(params, cache, batch, backend=backend)
        toks, logps = sampling_lib.sample_tokens(
            logits[:, -1, :], batch["temperature"], batch["top_k"],
            batch["top_p"], batch["seed"], batch["index"] + 1)
        return toks, logps, cache

    # ------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        return attn_lib.init_kv_cache(cfg.num_layers, batch, max_seq,
                                      self.geom.kv_heads,
                                      cfg.resolved_head_dim,
                                      cfg.kv_cache_dtype, self.device)

    def init_paged_cache(self, num_blocks: int, block_size: int) -> dict:
        """``num_blocks`` counts physical blocks, including junk block 0."""
        cfg = self.cfg
        return attn_lib.init_paged_kv_cache(cfg.num_layers, num_blocks,
                                            block_size, self.geom.kv_heads,
                                            cfg.resolved_head_dim,
                                            cfg.kv_cache_dtype, self.device)


def build_model(cfg: ModelConfig, device=None,
                mesh: Optional[object] = None) -> Model:
    """Dense models only; ``device=None`` resolves to the card."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported (ROADMAP.md queue 1, item 14)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP.md queue 1, "
            f"item 13)")
    dev = resolve_device(device)
    geom = Geometry.of(cfg)
    grouping = KVGrouping.build(geom.heads, geom.kv_heads,
                                tf_lib.kv_index_for(cfg, geom), dev)
    return Model(cfg=cfg, geom=geom, device=dev, grouping=grouping)
