"""XarTrekRuntime — compiler + run-time integration for PyTorch steps.

* ``prepare`` is the instrumentation the paper injects at main() start:
  warm the HOST variant now, start the ACCEL variant's load (kernel
  build + warm-up; the FPGA pre-configuration) asynchronously or, with
  ``eager_accel=True``, wait for it; seed the threshold table.
* ``call`` is the instrumented call site: scheduler-client query ->
  run the chosen variant -> synchronise the card -> report (Alg. 1).

Port of ``repro/core/runtime.py``.  Two deliberate differences:

* The timed region ends with ``torch.cuda.synchronize`` on every CUDA
  device the output lives on, so Algorithm 1 times the kernels, not
  their launches.
* ACCEL not resident YET (load in flight) still runs the step on HOST —
  the paper's latency hiding — but a load that FAILED re-raises at the
  next call (``KernelBank.raise_if_failed``): a kernel build error never
  turns into a silent run on the plain path.
"""
from __future__ import annotations

import time
from typing import Any, Optional

from repro_torch.core.binary import MultiTargetBinary, synchronize
from repro_torch.core.function import GLOBAL_REGISTRY, FunctionRegistry
from repro_torch.core.kernel_bank import KernelBank
from repro_torch.core.migration import migrate
from repro_torch.core.monitor import LoadMonitor
from repro_torch.core.policy import LoadSignals, PolicyLike
from repro_torch.core.scheduler import SchedulerClient, SchedulerServer
from repro_torch.core.targets import H100_PLATFORM, Platform, TargetKind
from repro_torch.core.thresholds import ThresholdTable


class XarTrekRuntime:
    def __init__(self, platform: Platform = H100_PLATFORM,
                 registry: FunctionRegistry = GLOBAL_REGISTRY,
                 table: Optional[ThresholdTable] = None,
                 policy: Optional[PolicyLike] = None,
                 bank_slots: Optional[int] = None,
                 min_reconfig_seconds: float = 0.0,
                 server: Optional[SchedulerServer] = None,
                 scheduler_address: Optional[tuple] = None):
        """``server`` shares an external scheduler (its policy and table
        are then the server's).  ``scheduler_address`` (the TCP
        transport) is not ported yet."""
        if scheduler_address is not None:
            raise NotImplementedError(
                "scheduler_address= (TCP scheduler transport) is not "
                "ported (ROADMAP.md queue 1, item 11)")
        self.platform = platform
        self.registry = registry
        self.binaries: dict[str, MultiTargetBinary] = {}
        self._examples: dict[str, tuple] = {}
        self.bank = KernelBank(
            slots=bank_slots or platform.accel_slots,
            load_fn=self._load_accel,
            min_load_seconds=min_reconfig_seconds)
        if server is not None:
            if policy is not None or table is not None:
                raise ValueError(
                    "policy=/table= conflict with server=: the shared "
                    "scheduler already owns both (set them there)")
            self.server = server
            self.table = server.table
            self.monitor = server.monitor
        else:
            self.table = table or ThresholdTable()
            self.monitor = LoadMonitor(platform)
            self.server = SchedulerServer(platform, self.table, self.bank,
                                          self.monitor,
                                          policy=policy or "xartrek")
        self._clients: dict[str, SchedulerClient] = {}
        self.call_log: list[dict] = []

    # ----------------------------------------------------------- prepare
    def prepare(self, fn_name: str, *example_args,
                table_row: Optional[dict] = None,
                state_argnums: tuple = (),
                eager_accel: bool = False) -> None:
        """main()-start instrumentation.  ``state_argnums`` names the
        arguments the step updates in place (the KV cache): warm-ups run
        on clones of them.  ``eager_accel=True`` blocks until the ACCEL
        build is resident and raises if it failed."""
        fn = self.registry.get(fn_name)
        self._examples[fn_name] = example_args
        binary = MultiTargetBinary(fn, state_argnums=state_argnums)
        self.binaries[fn_name] = binary
        binary.compile(TargetKind.HOST, *example_args)
        if TargetKind.AUX in fn.variants:
            binary.compile(TargetKind.AUX, *example_args)
        row = self.table.row(fn.app, hw_kernel=fn_name)
        if table_row:
            for k, v in table_row.items():
                setattr(row, k, v)
        if TargetKind.ACCEL in fn.variants:
            self.server.register_kernel(fn_name, self.bank)
            if eager_accel:
                self.bank.load_sync(fn_name)
            else:
                self.bank.load_async(fn_name)   # pre-configuration

    def _load_accel(self, fn_name: str):
        return self.binaries[fn_name].compile(TargetKind.ACCEL,
                                              *self._examples[fn_name])

    # -------------------------------------------------------------- call
    def _client(self, app: str) -> SchedulerClient:
        if app not in self._clients:
            self._clients[app] = SchedulerClient(app, self.server)
        return self._clients[app]

    def publish_signals(self, engine_id: str, signals: LoadSignals) -> None:
        self.server.publish(engine_id, signals)

    def call(self, fn_name: str, *args,
             state_devices: Optional[dict] = None) -> Any:
        """The instrumented call site.  Args may differ in shape from the
        ``prepare`` examples (ragged prefill widths): the binary then warms
        a shape bucket before the timed region.  ``state_devices`` maps a
        target to the device its variant wants the args on."""
        fn = self.registry.get(fn_name)
        binary = self.binaries[fn_name]
        client = self._client(fn.app)
        if TargetKind.ACCEL in fn.variants:
            self.bank.raise_if_failed(fn_name)

        decision = client.before_call()
        kind = decision.target
        if kind == TargetKind.ACCEL and not binary.is_compiled(kind):
            self.bank.raise_if_failed(fn_name)
            kind = TargetKind.HOST      # load still in flight: hide it
        if kind not in fn.variants:
            kind = TargetKind.HOST

        if state_devices and kind in state_devices:
            args = migrate(args, state_devices[kind])

        variant = binary.variant_for(kind, args)

        self.monitor.job_started(kind)
        t0 = time.perf_counter()
        try:
            out = variant(*args)
            synchronize(out)
        finally:
            self.monitor.job_finished(kind)
        dt = time.perf_counter() - t0
        binary.note_exec(kind, dt * 1e3)
        client.after_call(kind, dt * 1e3)
        self.call_log.append({"fn": fn_name, "target": kind.value,
                              "ms": dt * 1e3,
                              "reconfigure": decision.reconfigure})
        return out

    # ------------------------------------------------------------- stats
    def summary(self) -> dict:
        """Aggregate call/warm-up/migration accounting: per target, the
        calls each variant served; per function, how many times
        consecutive calls switched target (run-time migrations)."""
        per_target = {k.value: 0 for k in TargetKind}
        per_fn_calls: dict[str, dict[str, int]] = {}
        migrations: dict[str, int] = {}
        last: dict[str, str] = {}
        for rec in self.call_log:
            per_target[rec["target"]] += 1
            d = per_fn_calls.setdefault(rec["fn"], {})
            d[rec["target"]] = d.get(rec["target"], 0) + 1
            prev = last.get(rec["fn"])
            if prev is not None and prev != rec["target"]:
                migrations[rec["fn"]] = migrations.get(rec["fn"], 0) + 1
            last[rec["fn"]] = rec["target"]
        per_function = {}
        for name, binary in self.binaries.items():
            per_function[name] = {
                "calls": per_fn_calls.get(name, {}),
                "compiles": {k.value: dict(v)
                             for k, v in binary.compile_stats.items()},
                "migrations": migrations.get(name, 0),
            }
        return {"calls": len(self.call_log), "per_target": per_target,
                "per_function": per_function,
                "migrations": sum(migrations.values()),
                "bank": dict(self.bank.stats),
                "load_failures": sorted(self.bank.failures()),
                "shape_buckets": {name: dict(b.shape_stats)
                                  for name, b in self.binaries.items()
                                  if sum(b.shape_stats.values())},
                "decisions": {k.value: v
                              for k, v in self.server.decisions.items()}}
