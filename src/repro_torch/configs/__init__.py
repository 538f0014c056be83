"""Architecture registry of the port: the dense smollm-135m entry and the
``reduced`` smoke variant the CPU tests use.  Other families of the JAX
package are not ported yet (ROADMAP.md queue 1, item 13)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.model_config import ModelConfig
from repro_torch.configs.smollm_135m import CONFIG as SMOLLM_135M

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (SMOLLM_135M,)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same-family reduced config for CPU smoke tests (the JAX package's
    ``configs.reduced`` restricted to the dense family): 4 layers,
    d_model 128, 3 query heads over 1 kv head, head_dim 32, vocab 256."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"reduced(): family {cfg.family!r} is not ported "
            f"(ROADMAP.md queue 1, item 13)")
    heads = 3 if cfg.num_heads % 2 else 4
    kv = max(1, heads // max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1))
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", num_layers=min(cfg.num_layers, 4),
        d_model=128, vocab_size=257 if cfg.vocab_size % 16 else 256,
        remat="nothing", kv_cache_dtype=cfg.kv_cache_dtype,
        num_heads=heads, num_kv_heads=kv, head_dim=32, d_ff=256)
