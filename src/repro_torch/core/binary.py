"""Step C/D — multi-target "binaries" of one function (Popcorn analogue).

PyTorch runs eagerly, so a variant needs no ahead-of-time compile.  What
stays of the JAX package's ``MultiTargetBinary``: per shape bucket, each
variant is warmed up once OUTSIDE Algorithm 1's timed region (first-call
costs — library handles, lazy module loading, allocator growth — never
reach the thresholds); before ACCEL's first warm-up its ``setup`` runs
(the CUDA kernel build); the variants' output structure, shapes and
dtypes must agree (the aligned ABI, checked on the warm-up outputs); and
per-target call/warm-up counters feed ``summary()`` and the policy's
per-target step time.

Warm-ups run on clones of the arguments named in ``state_argnums`` (the
KV cache the step updates in place), so a warm-up never writes into live
state — not even from the bank's loader thread while the engine serves.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable

import torch

from repro_torch.core.function import MigratableFunction
from repro_torch.core.policy import ewma
from repro_torch.core.targets import TargetKind


class AbiMismatch(ValueError):
    pass


def tree_flatten(tree) -> tuple[list, Any]:
    """Leaves and a hashable structure of nested dicts/lists/tuples (dict
    keys sorted, as a JAX treedef orders them)."""
    if isinstance(tree, dict):
        leaves, structs = [], []
        for k in sorted(tree):
            lv, st = tree_flatten(tree[k])
            leaves += lv
            structs.append((k, st))
        return leaves, ("dict", tuple(structs))
    if isinstance(tree, (list, tuple)):
        leaves, structs = [], []
        for x in tree:
            lv, st = tree_flatten(x)
            leaves += lv
            structs.append(st)
        return leaves, (type(tree).__name__, tuple(structs))
    return [tree], "*"


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def shape_key(args: tuple) -> tuple:
    """Hashable (structure, leaf shapes/dtypes/devices) signature of a
    call's args.  Tensor leaves key on shape, dtype and device type;
    other leaves on (type, value)."""
    leaves, struct = tree_flatten(args)
    return (struct, tuple(
        (tuple(l.shape), l.dtype, l.device.type)
        if isinstance(l, torch.Tensor) else (type(l), l) for l in leaves))


def output_signature(out) -> tuple:
    leaves, struct = tree_flatten(out)
    return (struct, tuple((tuple(l.shape), l.dtype) for l in leaves
                          if isinstance(l, torch.Tensor)))


def synchronize(tree) -> None:
    """Wait for every CUDA device holding a tensor of ``tree``: kernel
    launches return before the kernels finish."""
    devices = {l.device for l in tree_flatten(tree)[0]
               if isinstance(l, torch.Tensor) and l.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class CompiledVariant:
    kind: TargetKind
    fn: Callable
    compile_seconds: float
    signature: tuple

    def __call__(self, *args):
        return self.fn(*args)


class MultiTargetBinary:
    """All warmed-up variants of one function."""

    def __init__(self, fn: MigratableFunction, state_argnums: tuple = (),
                 max_shape_buckets: int = 8):
        self.fn = fn
        self.state_argnums = tuple(state_argnums)
        self.variants: dict[TargetKind, CompiledVariant] = {}
        self.max_shape_buckets = max_shape_buckets
        self._default_keys: dict[TargetKind, tuple] = {}
        self._shape_cache: dict[TargetKind,
                                OrderedDict[tuple, CompiledVariant]] = {}
        self._setup_done: set[TargetKind] = set()
        self.shape_stats = {"hits": 0, "misses": 0, "evictions": 0}
        self.compile_stats: dict[TargetKind, dict] = {}

    def _scratch(self, args: tuple) -> tuple:
        return tuple(tree_map(lambda t: t.clone()
                              if isinstance(t, torch.Tensor) else t, a)
                     if i in self.state_argnums else a
                     for i, a in enumerate(args))

    def _warm(self, kind: TargetKind, args: tuple,
              check_abi: bool = False) -> CompiledVariant:
        t0 = time.perf_counter()
        if kind not in self._setup_done:
            setup = self.fn.setup.get(kind)
            if setup is not None:
                setup()
            self._setup_done.add(kind)
        fn = self.fn.variants[kind]
        out = fn(*self._scratch(args))
        synchronize(out)
        sig = output_signature(out)
        for other in (self.variants.values() if check_abi else ()):
            if other.signature != sig:
                raise AbiMismatch(
                    f"{self.fn.name}: ABI mismatch between {other.kind} and "
                    f"{kind}: {other.signature} vs {sig}")
        dt = time.perf_counter() - t0
        cs = self.compile_stats.setdefault(
            kind, {"compiles": 0, "compile_seconds": 0.0})
        cs["compiles"] += 1
        cs["compile_seconds"] += dt
        return CompiledVariant(kind=kind, fn=fn, compile_seconds=dt,
                               signature=sig)

    def compile(self, kind: TargetKind, *example_args) -> CompiledVariant:
        """Set up and warm one variant (eagerly at prepare for HOST, by the
        KernelBank for ACCEL)."""
        if kind in self.variants:
            return self.variants[kind]
        cv = self._warm(kind, example_args, check_abi=True)
        self.variants[kind] = cv
        self._default_keys[kind] = shape_key(example_args)
        return cv

    def variant_for(self, kind: TargetKind, args: tuple) -> CompiledVariant:
        """The variant warmed for ``args``' exact shapes: the default when
        the signature matches, else a bounded-LRU shape bucket warmed now
        (ragged prefill widths)."""
        key = shape_key(args)
        if self._default_keys.get(kind) == key:
            return self.variants[kind]
        lru = self._shape_cache.setdefault(kind, OrderedDict())
        cv = lru.get(key)
        if cv is not None:
            lru.move_to_end(key)
            self.shape_stats["hits"] += 1
            return cv
        self.shape_stats["misses"] += 1
        cv = lru[key] = self._warm(kind, args)
        while len(lru) > self.max_shape_buckets:
            lru.popitem(last=False)
            self.shape_stats["evictions"] += 1
        return cv

    def note_exec(self, kind: TargetKind, ms: float) -> None:
        """Record one executed call's time: ``recent_exec_ms`` is the EWMA
        the policy's per-target step-time signal reads."""
        cs = self.compile_stats.setdefault(
            kind, {"compiles": 0, "compile_seconds": 0.0})
        cs["calls"] = cs.get("calls", 0) + 1
        cs["recent_exec_ms"] = ewma(cs.get("recent_exec_ms"), ms)

    def is_compiled(self, kind: TargetKind) -> bool:
        return kind in self.variants
