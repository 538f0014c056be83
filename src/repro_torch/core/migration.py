"""Run-time state transformation between targets (Popcorn analogue).

The state at a function boundary is an explicit tree of tensors (params,
KV cache); moving it to another target is an ABI check plus
``.to(device)``.  Port of ``repro/core/migration.py``.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from repro_torch.core.binary import AbiMismatch, tree_flatten, tree_map


def check_abi(state: Any, reference: Any) -> None:
    """Both sides must agree on the tree structure and on every tensor's
    shape and dtype; only the device may differ."""
    s_leaves, s_tree = tree_flatten(state)
    r_leaves, r_tree = tree_flatten(reference)
    if s_tree != r_tree:
        raise AbiMismatch(f"state trees differ: {s_tree} vs {r_tree}")
    for a, b in zip(s_leaves, r_leaves):
        if isinstance(a, torch.Tensor) and (a.shape != b.shape
                                            or a.dtype != b.dtype):
            raise AbiMismatch(f"leaf {tuple(a.shape)}/{a.dtype} vs "
                              f"{tuple(b.shape)}/{b.dtype}")


def migrate(state: Any, device, *, measure: bool = False):
    """Move every tensor of ``state`` to ``device``.  With
    ``measure=True`` returns (state, seconds), synchronised."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                   else t, state)
    if measure:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0
    return out


def migration_bytes(state: Any) -> int:
    """Bytes moved by a migration (full state size)."""
    return sum(l.numel() * l.element_size() for l in tree_flatten(state)[0]
               if isinstance(l, torch.Tensor))
