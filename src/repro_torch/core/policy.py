"""Scheduling policies: the pluggable placement surface of the run-time.

The paper's run-time splits *mechanism* (compiled multi-target variants,
the kernel bank, migration) from *decision* (Algorithm 2).  This module
is the decision side, redesigned as a first-class protocol so the
decision can be swapped without touching the mechanism:

  ``SchedulingPolicy.decide(signals, row, residency) -> Decision``

* ``LoadSignals`` is everything a placement decision may consult — the
  paper's synthetic x86 process count PLUS real serve-engine telemetry
  (queue depth, free KV-block fraction, per-target recent decode
  milliseconds, TTFT/TPOT percentiles).  Engines publish one per step;
  the scheduler server aggregates across engines, so one engine's load
  pressure is visible to every co-tenant's decision.
* ``ThresholdRow`` is the compiler's Table-2 artifact for the function
  being placed (Algorithm 1 keeps refining it).
* ``Residency`` is the accelerator state for that function's hardware
  kernel (bank-resident / reconfiguration in flight).

Built-ins:

* ``XarTrekHeuristic`` — Algorithm 2, numerics unchanged (it delegates
  to the legacy ``schedule`` free function, which remains the
  line-annotated faithful port).
* ``PinHost`` / ``PinAux`` / ``PinAccel`` — the static placements that
  used to be the scheduler's ``"always_*"`` strings and the serve
  engine's ``backend="host"/"accel"`` special cases.
* ``LatencyAwarePolicy`` — decides from serve-level signals instead of
  the process counter: offloads decode to ACCEL under queue/KV/TTFT
  pressure (kicking an async reconfiguration first when the kernel is
  cold — the paper's §3.4 latency-hiding), returns to HOST when the
  pressure drains.

Policies move *placement only*: every target serves the same math (the
sampling transform is traced identically into each build), so outputs
are byte-identical across policies — the serve analogue of "migration
is transparent to the application".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Union, runtime_checkable

from repro_torch.core.targets import TargetKind
from repro_torch.core.thresholds import ThresholdRow


@dataclasses.dataclass(frozen=True)
class Decision:
    target: TargetKind
    reconfigure: bool = False      # start async ACCEL load of this kernel

    @property
    def flag(self) -> int:
        return self.target.flag


@dataclasses.dataclass(frozen=True)
class Residency:
    """Accelerator state of the function's hardware kernel."""

    resident: bool = False         # bank-resident, callable right now
    loading: bool = False          # async reconfiguration in flight


@dataclasses.dataclass(frozen=True)
class LoadSignals:
    """One policy input: real engine telemetry + the paper's load counter.

    ``x86_load`` is Algorithm 2's signal — processes on (or queued for)
    the host.  The serve-level fields come from the engines themselves
    (``ContinuousBatchingEngine.signals()``); ``None`` means "no
    observation yet" so policies can distinguish cold-start from zero.
    ``engines`` counts how many engines contributed (1 for a lone
    engine; N after ``LoadSignals.aggregate``).
    """

    x86_load: float = 0.0              # host processes (Algorithm 2's input)
    aux_load: float = 0.0
    accel_load: float = 0.0
    band: str = "low"                  # Table-3 low/medium/high band
    queue_depth: int = 0               # requests arrived but not admitted
    active_slots: int = 0              # in-flight decode rows
    free_kv_frac: float = 1.0          # free fraction of KV capacity
    host_decode_ms: Optional[float] = None   # recent decode step ms / target
    accel_decode_ms: Optional[float] = None
    ttft_p50_s: Optional[float] = None
    tpot_p50_s: Optional[float] = None
    # EWMA of per-step decode stall caused by interleaved prefill chunks
    # (ms decode had to wait while a chunk ran); decays toward 0 on
    # chunk-free steps.  The stall-feedback prefill_budget controller's
    # input.  None until an engine with chunking enabled reports.
    decode_stall_ms: Optional[float] = None
    engines: int = 1

    @staticmethod
    def aggregate(signals: list["LoadSignals"]) -> "LoadSignals":
        """Cross-engine aggregate: pressure sums (queue depth, active
        slots, loads), capacity takes the worst engine (min free KV),
        latency observations average over the engines that have any.
        This is the scheduler server's cluster-wide view — one engine's
        pressure raises the aggregate every co-tenant's decision sees."""
        if not signals:
            return LoadSignals(engines=0)

        def mean(vals):
            vals = [v for v in vals if v is not None]
            return sum(vals) / len(vals) if vals else None

        bands = [s.band for s in signals]
        band = ("high" if "high" in bands
                else "medium" if "medium" in bands else "low")
        return LoadSignals(
            x86_load=sum(s.x86_load for s in signals),
            aux_load=sum(s.aux_load for s in signals),
            accel_load=sum(s.accel_load for s in signals),
            band=band,
            queue_depth=sum(s.queue_depth for s in signals),
            active_slots=sum(s.active_slots for s in signals),
            free_kv_frac=min(s.free_kv_frac for s in signals),
            host_decode_ms=mean([s.host_decode_ms for s in signals]),
            accel_decode_ms=mean([s.accel_decode_ms for s in signals]),
            ttft_p50_s=mean([s.ttft_p50_s for s in signals]),
            tpot_p50_s=mean([s.tpot_p50_s for s in signals]),
            decode_stall_ms=mean([s.decode_stall_ms for s in signals]),
            engines=sum(s.engines for s in signals),
        )


def ewma(prev: Optional[float], value: float,
         alpha: float = 0.2) -> float:
    """The telemetry smoother every decode-ms signal source shares
    (binary.note_exec for runtime-dispatched steps, the engine's direct
    path): first observation seeds, later ones blend at ``alpha``."""
    return value if prev is None else (1.0 - alpha) * prev + alpha * value


# --------------------------------------------------------------- protocol

@runtime_checkable
class SchedulingPolicy(Protocol):
    """One placement decision per instrumented call.

    ``decide`` must be pure in the signals/row/residency inputs up to
    the policy's own internal state (a scripted policy may keep a step
    counter) and must never block: it runs under the scheduler server's
    lock on every client request.

    Policies may additionally expose an optional hook

        ``prefill_budget(signals, default) -> Optional[int]``

    consulted by chunked-prefill engines once per scheduler step: return
    the number of prompt tokens admission may prefill this step (``None``
    disables chunking for the step — finish monolithically).  Engines
    fall back to their static ``prefill_tokens_per_step`` when the
    policy has no hook.

    Speculative-decoding engines likewise consult an optional hook

        ``draft_len(signals, default) -> int``

    once per scheduler step: return the number of tokens the draft
    model may propose this round (``0`` disables speculation for the
    step — the engine falls back to plain decode), clamped by the
    engine to its compiled draft width.  Engines use ``default``
    (their configured ``spec_draft_len``) when the policy has no hook.
    Mirrors ``prefill_budget``: both let load shrink work the engine
    would otherwise do optimistically.
    """

    name: str

    def decide(self, signals: LoadSignals, row: ThresholdRow,
               residency: Residency) -> Decision:
        ...


def schedule(cpu_load: float, row: ThresholdRow,
             kernel_resident: bool) -> Decision:
    """One Algorithm-2 evaluation (lines annotated) — the paper's
    heuristic, kept as a free function so its numerics stay auditable
    against the paper; ``XarTrekHeuristic`` is its protocol wrapper."""
    arm_thr, fpga_thr = row.arm_thr, row.fpga_thr

    if (cpu_load <= arm_thr) and (cpu_load > fpga_thr) and not kernel_resident:
        # l.9-13: stay on x86, reconfigure FPGA in the background
        return Decision(TargetKind.HOST, reconfigure=True)
    if (cpu_load > arm_thr) and (cpu_load > fpga_thr) and not kernel_resident:
        # l.14-18: migrate to ARM, reconfigure FPGA in the background
        return Decision(TargetKind.AUX, reconfigure=True)
    if (cpu_load <= arm_thr) and (cpu_load <= fpga_thr):
        # l.19-21: low load -> stay on x86
        return Decision(TargetKind.HOST)
    if (cpu_load > arm_thr) and (cpu_load <= fpga_thr):
        # l.22-24: only ARM profitable
        return Decision(TargetKind.AUX)
    if (cpu_load > fpga_thr) and kernel_resident:
        # l.25-31: smaller threshold implies smaller execution time
        if fpga_thr < arm_thr:                                  # l.26-27
            return Decision(TargetKind.ACCEL)
        return Decision(TargetKind.AUX)                         # l.29-30
    # unreachable given the four exhaustive load/residency cases above,
    # but the paper's default is "continue on x86"
    return Decision(TargetKind.HOST)


# --------------------------------------------------------------- built-ins

class XarTrekHeuristic:
    """Algorithm 2 behind the protocol — numerics identical to
    ``schedule`` (regression-tested branch by branch)."""

    name = "xartrek"

    def decide(self, signals: LoadSignals, row: ThresholdRow,
               residency: Residency) -> Decision:
        return schedule(signals.x86_load, row, residency.resident)


class _Pin:
    """Static placement; absorbs the old ``"always_*"`` policy strings
    and the serve engine's ``backend="host"/"accel"`` escape hatches."""

    target: TargetKind

    def decide(self, signals: LoadSignals, row: ThresholdRow,
               residency: Residency) -> Decision:
        reconf = (self.target == TargetKind.ACCEL
                  and not residency.resident and not residency.loading)
        return Decision(self.target, reconfigure=reconf)


class PinHost(_Pin):
    name = "always_host"
    target = TargetKind.HOST


class PinAux(_Pin):
    name = "always_aux"
    target = TargetKind.AUX


class PinAccel(_Pin):
    """Pin to ACCEL.  While the kernel is still cold the decision keeps
    requesting an async reconfiguration; the runtime's mechanism layer
    falls back to HOST for the calls in between (latency hiding), so
    pinning never blocks on a compile."""

    name = "always_accel"
    target = TargetKind.ACCEL


@dataclasses.dataclass
class LatencyAwarePolicy:
    """Serve-signal-driven placement (no synthetic process counter).

    Pressure is any of: queue depth at/above ``queue_depth_hi``, free KV
    capacity at/below ``free_kv_lo``, or TTFT p50 above ``ttft_slo_s``.
    Under pressure the decode offloads to ACCEL — freeing the contended
    host for co-tenants, exactly Algorithm 2's rationale — kicking an
    async reconfiguration first if the kernel is cold.  Without
    pressure it serves on HOST, unless the measured ACCEL step time is
    strictly faster than HOST's (then ACCEL is simply the better
    device and there is no reason to come back).

    When ``prefill_tokens_per_step`` is set the policy also implements
    the chunked-prefill budget hook: the budget applies only while
    decodes are actually in flight (``active_slots > 0``) — an idle
    engine prefills monolithically, since there is nothing to stall.
    The budget is stall-feedback controlled: when the engines report a
    ``decode_stall_ms`` EWMA above ``stall_target_ms``, the budget
    contracts proportionally (``target / stall``, floored at one
    token) so decode stops paying for oversized chunks; at or below
    target the full configured budget applies.  Set
    ``stall_target_ms=None`` for the old static knob.

    ``draft_len`` implements the speculative-decoding hook the same
    way: draft length is an optimism dial, so queue pressure halves it
    and hard pressure (``pressured``) disables speculation outright —
    under load, guaranteed-progress plain decode beats speculative
    work that may be thrown away.
    """

    queue_depth_hi: int = 4
    free_kv_lo: float = 0.125
    ttft_slo_s: Optional[float] = None
    prefill_tokens_per_step: Optional[int] = None
    stall_target_ms: Optional[float] = 50.0
    name: str = "latency_aware"

    def pressured(self, s: LoadSignals) -> bool:
        return (s.queue_depth >= self.queue_depth_hi
                or s.free_kv_frac <= self.free_kv_lo
                or (self.ttft_slo_s is not None
                    and s.ttft_p50_s is not None
                    and s.ttft_p50_s > self.ttft_slo_s))

    def decide(self, signals: LoadSignals, row: ThresholdRow,
               residency: Residency) -> Decision:
        accel_strictly_faster = (
            signals.accel_decode_ms is not None
            and signals.host_decode_ms is not None
            and signals.accel_decode_ms < signals.host_decode_ms)
        want_accel = self.pressured(signals) or accel_strictly_faster
        if not want_accel:
            return Decision(TargetKind.HOST)
        if residency.resident:
            return Decision(TargetKind.ACCEL)
        # cold kernel: stay on HOST while the bank loads (§3.4)
        return Decision(TargetKind.HOST, reconfigure=not residency.loading)

    def prefill_budget(self, signals: LoadSignals,
                       default: Optional[int] = None) -> Optional[int]:
        budget = self.prefill_tokens_per_step or default
        if budget is None or signals.active_slots == 0:
            return None        # nothing to stall: prefill monolithically
        stall = signals.decode_stall_ms
        if (self.stall_target_ms is not None and stall is not None
                and stall > self.stall_target_ms):
            # stall-feedback contraction: chunk cost is ~linear in chunk
            # tokens, so scaling by target/stall steers the EWMA back to
            # the target; the floor keeps prefill from starving outright
            return max(int(budget * self.stall_target_ms / stall), 1)
        return budget

    def draft_len(self, signals: LoadSignals, default: int = 4) -> int:
        if self.pressured(signals):
            return 0           # hard pressure: no speculative work
        if signals.queue_depth >= max(self.queue_depth_hi // 2, 1):
            return max(default // 2, 1)
        return default


# legacy policy strings -> protocol instances (the scheduler server and
# the simulator accept either form)
POLICY_ALIASES = {
    "xartrek": XarTrekHeuristic,
    "always_host": PinHost,
    "always_aux": PinAux,
    "always_accel": PinAccel,
    "latency_aware": LatencyAwarePolicy,
}

PolicyLike = Union[str, SchedulingPolicy]


def resolve_policy(policy: PolicyLike) -> SchedulingPolicy:
    """Accepts a SchedulingPolicy instance or a legacy string alias."""
    if isinstance(policy, str):
        try:
            return POLICY_ALIASES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown policy {policy!r}; expected one of "
                f"{sorted(POLICY_ALIASES)} or a SchedulingPolicy") from None
    if isinstance(policy, type):           # a policy CLASS: instantiate
        policy = policy()
    if callable(getattr(policy, "decide", None)):
        return policy
    raise TypeError(f"not a SchedulingPolicy: {policy!r}")
