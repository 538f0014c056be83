"""Load monitor: the paper's "x86 CPU load" (#processes) + Table-3 bands.

The monitor is one SOURCE of scheduling signals, not the policy input
itself any more: ``signals()`` packages the per-target process counts
and the Table-3 band as a ``LoadSignals`` that the scheduler server
merges with engine-published serve telemetry (see ``core.policy``).
"""
from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.targets import Platform, TargetKind


@dataclasses.dataclass
class LoadMonitor:
    platform: Platform

    def __post_init__(self):
        self._active: dict[TargetKind, int] = {k: 0 for k in TargetKind}
        self._lock = threading.Lock()

    def job_started(self, kind: TargetKind) -> None:
        with self._lock:
            self._active[kind] += 1

    def job_finished(self, kind: TargetKind) -> None:
        with self._lock:
            self._active[kind] = max(0, self._active[kind] - 1)

    def active(self, kind: TargetKind) -> int:
        with self._lock:
            return self._active[kind]

    def x86_load(self) -> float:
        """The scheduling signal: processes on (or queued for) the host."""
        return float(self.active(TargetKind.HOST))

    def band(self, total_processes: int) -> str:
        """Table 3: low/medium/high by #processes vs core counts."""
        host = self.platform.host.capacity
        total = self.platform.total_cores
        if total_processes < host:
            return "low"
        if total_processes <= total:
            return "medium"
        return "high"

    def signals(self) -> "LoadSignals":
        """The monitor's contribution to the policy input: per-target
        process counts plus the Table-3 band over the TOTAL processes in
        flight (the banding used to be dead code on the serve path —
        now every published LoadSignals carries it)."""
        from repro_torch.core.policy import LoadSignals
        with self._lock:
            host = float(self._active[TargetKind.HOST])
            aux = float(self._active[TargetKind.AUX])
            accel = float(self._active[TargetKind.ACCEL])
        return LoadSignals(
            x86_load=host, aux_load=aux, accel_load=accel,
            band=self.band(int(host + aux + accel)))
