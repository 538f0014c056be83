"""Step B — instrumentation: the MigratableFunction registry.

A MigratableFunction is one *selected function*: a callable with one
implementation ("variant") per execution target, all sharing the same
input/output ABI.  ``setup`` optionally names, per target, what must
happen once before that target's first call — for ACCEL, building the
CUDA kernels.  The instrumentation the paper injects around call sites
lives in ``runtime.XarTrekRuntime.call``.  Port of
``repro/core/function.py``; the ABI check moved to ``binary.py``, which
compares the variants' outputs from their warm-up calls (PyTorch has no
abstract evaluation of a callable that launches custom kernels).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.targets import TargetKind


@dataclasses.dataclass
class MigratableFunction:
    name: str
    app: str
    variants: dict[TargetKind, Callable]        # identical ABI
    setup: dict[TargetKind, Callable[[], None]] = dataclasses.field(
        default_factory=dict)

    def targets(self) -> tuple[TargetKind, ...]:
        return tuple(self.variants)


class FunctionRegistry:
    def __init__(self):
        self._fns: dict[str, MigratableFunction] = {}

    def register(self, fn: MigratableFunction) -> MigratableFunction:
        if fn.name in self._fns:
            raise ValueError(f"duplicate migratable function {fn.name!r}")
        self._fns[fn.name] = fn
        return fn

    def get(self, name: str) -> MigratableFunction:
        return self._fns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._fns

    def names(self) -> list[str]:
        return sorted(self._fns)


GLOBAL_REGISTRY = FunctionRegistry()

