"""Steps D and F — the KernelBank: residency + async load.

The FPGA holds a bounded number of hardware kernels per configuration
image; swapping one in is a multi-second partial reconfiguration.  The
GPU analogue keeps a bounded bank of ACCEL step builds (CUDA kernels
built and warmed up per shape); loading a non-resident one is an
asynchronous build + warm-up on a background thread.  Algorithm 2's "No
HW Kernel" branches consult ``is_resident``; the latency-hiding
behaviour (keep running on a CPU target until the load completes) falls
out naturally.

A load that FAILS is never mistaken for one still in flight: the loader
thread records the exception, and ``load_sync`` and ``raise_if_failed``
(which the runtime calls on every instrumented call) re-raise it.  The
JAX package's bank lets the thread die silently, so a failed build left
ACCEL non-resident forever and every ACCEL decision ran on HOST; on a
card that would turn a kernel build failure into a silent run on the
plain path.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class BankEntry:
    name: str
    loaded_at: float
    last_used: float
    payload: object = None          # compiled executable (or sim placeholder)


class KernelLoadError(RuntimeError):
    """An ACCEL build failed to load; ``__cause__`` is the original error."""


class KernelBank:
    def __init__(self, slots: int = 4,
                 load_fn: Optional[Callable[[str], object]] = None,
                 min_load_seconds: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        """load_fn(name) -> payload; runs on the loader thread.

        ``min_load_seconds`` simulates reconfiguration latency when the
        real compile is instant (tests / simulator).
        """
        self.slots = slots
        self.load_fn = load_fn or (lambda name: name)
        self.min_load_seconds = min_load_seconds
        self.clock = clock
        self._resident: dict[str, BankEntry] = {}
        self._loading: dict[str, threading.Thread] = {}
        self._failed: dict[str, BaseException] = {}
        self._lock = threading.Lock()
        self.stats = {"loads": 0, "evictions": 0, "hits": 0, "misses": 0,
                      "failures": 0}

    # ------------------------------------------------------------ queries
    def is_resident(self, name: str) -> bool:
        with self._lock:
            hit = name in self._resident
            self.stats["hits" if hit else "misses"] += 1
            if hit:
                self._resident[name].last_used = self.clock()
            return hit

    def is_loading(self, name: str) -> bool:
        with self._lock:
            t = self._loading.get(name)
            return t is not None and t.is_alive()

    def get(self, name: str) -> object:
        with self._lock:
            e = self._resident[name]
            e.last_used = self.clock()
            return e.payload

    def resident_kernels(self) -> list[str]:
        with self._lock:
            return sorted(self._resident)

    def failures(self) -> dict[str, BaseException]:
        with self._lock:
            return dict(self._failed)

    def raise_if_failed(self, name: str) -> None:
        """Re-raise a recorded load failure of ``name`` (no-op otherwise)."""
        with self._lock:
            exc = self._failed.get(name)
        if exc is not None:
            raise KernelLoadError(f"kernel {name!r} failed to load") from exc

    # ------------------------------------------------------------ loading
    def load_async(self, name: str) -> None:
        """Algorithm 2 l.11/16: 'Reconfigure the FPGA' without blocking."""
        with self._lock:
            if name in self._resident or name in self._failed:
                return
            t = self._loading.get(name)
            if t is not None and t.is_alive():
                return
            thread = threading.Thread(target=self._do_load, args=(name,),
                                      daemon=True)
            self._loading[name] = thread
            thread.start()

    def load_sync(self, name: str) -> None:
        """Load and wait; raises ``KernelLoadError`` if the load failed."""
        self.load_async(name)
        with self._lock:
            t = self._loading.get(name)
        if t is not None:
            t.join()
        self.raise_if_failed(name)

    def _do_load(self, name: str) -> None:
        t0 = self.clock()
        try:
            payload = self.load_fn(name)
        except BaseException as exc:   # recorded, re-raised by callers
            with self._lock:
                self._failed[name] = exc
                self.stats["failures"] += 1
                self._loading.pop(name, None)
            return
        elapsed = self.clock() - t0
        if elapsed < self.min_load_seconds:
            time.sleep(self.min_load_seconds - elapsed)
        with self._lock:
            if len(self._resident) >= self.slots:
                victim = min(self._resident.values(),
                             key=lambda e: e.last_used)
                del self._resident[victim.name]
                self.stats["evictions"] += 1
            now = self.clock()
            self._resident[name] = BankEntry(name=name, loaded_at=now,
                                             last_used=now, payload=payload)
            self.stats["loads"] += 1
            self._loading.pop(name, None)
