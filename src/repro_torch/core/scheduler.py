"""Run-time scheduler, in-process half: client/server split (paper §3.2).

The server owns the policy (a pluggable ``SchedulingPolicy``; the
default is Algorithm 2 as ``XarTrekHeuristic``), the threshold table
(Algorithm 1 updates arrive via client reports), the kernel bank(s) and
the load monitor.  A client is bound to each application; it queries the
server before the selected function's call and reports after it returns.
Engines ``publish`` a ``LoadSignals`` snapshot each step; the server
merges the published snapshots with the monitor's process counts.

Port of ``repro/core/scheduler.py:54-232``.  The TCP transport, KV-span
handoff, heartbeats and remote-residency reports serve the cluster and
are not ported yet (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.core.kernel_bank import KernelBank
from repro_torch.core.monitor import LoadMonitor
from repro_torch.core.policy import (
    Decision, LoadSignals, PolicyLike, Residency, resolve_policy,
)
from repro_torch.core.targets import Platform, TargetKind
from repro_torch.core.thresholds import ThresholdTable


class SchedulerServer:
    def __init__(self, platform: Platform, table: ThresholdTable,
                 bank: Optional[KernelBank] = None,
                 monitor: Optional[LoadMonitor] = None,
                 policy: PolicyLike = "xartrek"):
        self.platform = platform
        self.table = table
        self.bank = bank               # default bank (single-runtime case)
        self.monitor = monitor or LoadMonitor(platform)
        self._policy = resolve_policy(policy)
        self._lock = threading.Lock()
        self.decisions = {k: 0 for k in TargetKind}
        self.reconfigs = 0
        # kernel -> owning bank (each runtime registers its functions)
        self._owners: dict[str, KernelBank] = {}
        # engine_id -> latest published serve telemetry
        self._published: dict[str, LoadSignals] = {}

    @property
    def policy(self) -> object:
        return self._policy

    @policy.setter
    def policy(self, value: PolicyLike) -> None:
        self._policy = resolve_policy(value)

    def publish(self, engine_id: str, signals: LoadSignals) -> None:
        """Engine telemetry feed: the latest snapshot per engine."""
        with self._lock:
            self._published[engine_id] = signals

    def signals(self) -> LoadSignals:
        """The policy input: the monitor's process counts merged with the
        aggregate of published serve telemetry.  Queued-but-unadmitted
        requests count into ``x86_load`` (queued host work)."""
        base = self.monitor.signals()
        with self._lock:
            published = list(self._published.values())
        if not published:
            return base
        agg = LoadSignals.aggregate(published)
        return dataclasses.replace(
            agg,
            x86_load=base.x86_load + agg.queue_depth,
            aux_load=base.aux_load,
            accel_load=base.accel_load,
            band=self.monitor.band(
                int(base.x86_load + base.aux_load + base.accel_load
                    + agg.queue_depth)),
        )

    def register_kernel(self, kernel: str, bank: KernelBank) -> None:
        with self._lock:
            self._owners[kernel] = bank

    def residency(self, kernel: str) -> Residency:
        bank = self._owners.get(kernel, self.bank)
        if bank is None:
            return Residency()
        return Residency(resident=bank.is_resident(kernel),
                         loading=bank.is_loading(kernel))

    def request(self, app: str) -> Decision:
        """Handle one client scheduling request (Algorithm 2 l.5-8)."""
        row = self.table.row(app)
        sig = self.signals()
        res = self.residency(row.hw_kernel)
        bank = None
        with self._lock:
            d = self._policy.decide(sig, row, res)
            self.decisions[d.target] += 1
            if d.reconfigure:
                self.reconfigs += 1
                bank = self._owners.get(row.hw_kernel, self.bank)
        if d.reconfigure and bank is not None:
            bank.load_async(row.hw_kernel)      # async; outside the lock
        return d

    def report(self, app: str, executed_on: TargetKind, exec_time: float,
               cpu_load: Optional[float] = None) -> None:
        """Client post-return report -> Algorithm 1 threshold update."""
        load = self.monitor.x86_load() if cpu_load is None else cpu_load
        with self._lock:
            self.table.update(app, executed_on, exec_time, load)


@dataclasses.dataclass
class SchedulerClient:
    """Instrumented into each application (step B)."""

    app: str
    server: SchedulerServer

    def before_call(self) -> Decision:
        return self.server.request(self.app)

    def after_call(self, executed_on: TargetKind, exec_time: float,
                   cpu_load: Optional[float] = None) -> None:
        self.server.report(self.app, executed_on, exec_time, cpu_load)

    def publish(self, engine_id: str, signals: LoadSignals) -> None:
        self.server.publish(engine_id, signals)
