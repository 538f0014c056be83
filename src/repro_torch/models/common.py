"""Common model building blocks (dense subset of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors.  Each model module defines a
parallel tree of ``ParamDef`` (shape + init), from which ``init_params``
materialises seeded tensors with an explicit ``torch.Generator`` and
``device``.  Padded dimensions are zero-masked at init, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise NotImplementedError(
            f"dtype {name!r} is not ported (int8 KV pools: ROADMAP.md "
            f"queue 1, item 8)")
    return DTYPES[name]


@dataclasses.dataclass
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | scaled
    scale: float = 0.02
    # mask_dims: {dim_index: valid_size} -> zero out the padded tail
    mask_dims: dict[int, int] = dataclasses.field(default_factory=dict)
    dtype: Optional[str] = None     # override model dtype (e.g. fp32 norms)


def _init_tensor(d: ParamDef, dtype: torch.dtype, generator, device):
    dt = DTYPES[d.dtype] if d.dtype else dtype
    if d.init == "zeros":
        x = torch.zeros(d.shape, dtype=dt, device=device)
    elif d.init == "ones":
        x = torch.ones(d.shape, dtype=dt, device=device)
    else:
        scale = d.scale
        if d.init == "scaled":  # 1/sqrt(fan_in) on the second-to-last dim
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
        x = (torch.randn(d.shape, generator=generator, dtype=torch.float32,
                         device=device) * scale).to(dt)
    for dim, valid in d.mask_dims.items():
        if valid < d.shape[dim]:
            x.narrow(dim, valid, d.shape[dim] - valid).zero_()
    return x


def init_params(defs, dtype: torch.dtype, generator: torch.Generator,
                device) -> dict:
    """Materialise a nested dict of ParamDef -> tensors, in the dict's
    insertion order, drawing from ``generator`` (which must live on
    ``device``)."""
    if isinstance(defs, ParamDef):
        return _init_tensor(defs, dtype, generator, device)
    return {k: init_params(v, dtype, generator, device)
            for k, v in defs.items()}


# ---------------------------------------------------------------- layers

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", torch.nn.functional.silu(g) * u,
                        w_down)
