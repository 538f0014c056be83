"""Weights of the port: from the JAX parameter tree, or seeded on device.

``from_jax_params`` maps ``repro.models.model.Model.init``'s tree — given
as numpy arrays, so this module needs no JAX — onto the port's tensors.
The port keeps the JAX layout (layer weights stacked along a leading L
dim, ``embed.table``, ``final_norm``, ``head.w``), so the mapping is a
structural copy with a check of every name, shape and dtype.
``init_params`` draws seeded weights directly on the device, for the card
where there is no JAX.

The card's init is GPT-2's (every matrix normal with std 0.02, the
residual output projections ``wo`` and ``w_down`` at 0.02/sqrt(2L), unit
norms), not the JAX package's (1/sqrt(fan_in) on every matrix).  At the
full 30-layer width the JAX scheme is chaotic: on an H100 a relative
perturbation of 1e-6 of the embeddings moved the prompt logits by 4.7,
so any two float32 implementations — HOST and ACCEL included — part ways
after a few tokens.  Under GPT-2's scales the same perturbation moves
them by 3e-6, as in a trained model, and HOST/ACCEL token identity is a
meaningful check.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.model_config import ModelConfig
from repro_torch.models.common import DTYPES, ParamDef, init_params as _init
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import resolve_device
from repro_torch.models.transformer import Geometry, transformer_defs


def _np_to_torch(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def from_jax_params(tree, cfg: ModelConfig, device=None) -> dict:
    """JAX ``Model.init`` tree (nested dicts of numpy arrays) -> the port's
    parameter dict on ``device`` (``None``: the card).  Raises on a
    missing, extra or mis-shaped leaf."""
    dev = resolve_device(device)
    defs = transformer_defs(cfg, Geometry.of(cfg))
    dtype = torch_dtype(cfg.dtype)

    def walk(d, t, path):
        if isinstance(d, ParamDef):
            a = np.asarray(t)
            if tuple(a.shape) != tuple(d.shape):
                raise ValueError(f"{path}: shape {a.shape} != {d.shape}")
            return _np_to_torch(a, DTYPES[d.dtype] if d.dtype else dtype,
                                dev)
        if not isinstance(t, dict) or set(t) != set(d):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"{path or 'params'}: keys {got} != "
                             f"{sorted(d)}")
        return {k: walk(d[k], t[k], f"{path}.{k}" if path else k) for k in d}

    return walk(defs, tree, "")


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, seed: int = 0) -> dict:
    """Seeded weights on ``device`` (``None``: the card).  ``generator``
    must live on that device; without one, a generator seeded with
    ``seed`` is made there."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    return _init(_card_defs(cfg), torch_dtype(cfg.dtype), generator, dev)


def _card_defs(cfg: ModelConfig) -> dict:
    """``transformer_defs`` with GPT-2's init scales (module docstring)."""
    residual_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def walk(d, name):
        if isinstance(d, dict):
            return {k: walk(v, k) for k, v in d.items()}
        if d.init != "scaled":
            return d
        std = residual_std if name in ("wo", "w_down") else 0.02
        return dataclasses.replace(d, init="normal", scale=std)

    return walk(transformer_defs(cfg, Geometry.of(cfg)), "")
