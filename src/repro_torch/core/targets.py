"""Execution targets: the x86 / ARM / FPGA triad mapped to one GPU.

A target is (device-pool class, kernel-implementation set, capacity).
``HOST`` is the default contended pool (paper: x86 Xeon, 6 cores);
``AUX`` a larger but per-unit-slower pool (paper: ThunderX ARM, 96
cores); ``ACCEL`` the hardware-kernel path (paper: Alveo FPGA; here: the
step variants on the hand-written CUDA kernels behind the KernelBank).
Copy of ``repro/core/targets.py`` plus ``H100_PLATFORM``.
"""
from __future__ import annotations

import dataclasses
import enum


class TargetKind(enum.Enum):
    HOST = "host"    # paper: x86 (flag 0: do not migrate)
    AUX = "aux"      # paper: ARM (flag 1: software migration)
    ACCEL = "accel"  # paper: FPGA (flag 2: hardware migration)

    @property
    def flag(self) -> int:
        return {"host": 0, "aux": 1, "accel": 2}[self.value]


@dataclasses.dataclass(frozen=True)
class ExecutionTarget:
    name: str
    kind: TargetKind
    capacity: int                  # concurrent job slots ("cores")
    kernel_impl: str               # "ref" | "pallas" | "cuda"
    speed_factor: float = 1.0      # per-slot relative speed vs HOST slot
    migrate_overhead_s: float = 0.0  # in-locus measured xfer cost (estimator refines)


@dataclasses.dataclass(frozen=True)
class Platform:
    """A heterogeneous server: one target per kind (paper's Figure 2)."""

    host: ExecutionTarget
    aux: ExecutionTarget
    accel: ExecutionTarget
    accel_slots: int = 4           # XCLBIN kernel slots ("FPGA area")
    reconfig_latency_s: float = 4.0  # Alveo partial-reconfig order of magnitude

    def by_kind(self, kind: TargetKind) -> ExecutionTarget:
        return {TargetKind.HOST: self.host, TargetKind.AUX: self.aux,
                TargetKind.ACCEL: self.accel}[kind]

    @property
    def total_cores(self) -> int:
        return self.host.capacity + self.aux.capacity


# The paper's evaluation platform (Table 3: 6 x86 + 96 ARM cores).
DEFAULT_PLATFORM = Platform(
    host=ExecutionTarget("xeon-x86", TargetKind.HOST, capacity=6,
                         kernel_impl="ref", speed_factor=1.0),
    aux=ExecutionTarget("thunderx-arm", TargetKind.AUX, capacity=96,
                        kernel_impl="ref", speed_factor=0.26,
                        migrate_overhead_s=0.05),
    accel=ExecutionTarget("alveo-fpga", TargetKind.ACCEL, capacity=1,
                          kernel_impl="pallas", speed_factor=1.0,
                          migrate_overhead_s=0.02),
)

# The H100 flavour used by the port: HOST is plain eager PyTorch (the
# reference math), ACCEL the step variants on the hand-written CUDA
# kernels.  The AUX row keeps the paper's shape for Algorithm 2; the serve
# engine registers no AUX variant, so an AUX decision runs on HOST.
H100_PLATFORM = Platform(
    host=ExecutionTarget("torch-eager", TargetKind.HOST, capacity=6,
                         kernel_impl="ref"),
    aux=ExecutionTarget("torch-eager-aux", TargetKind.AUX, capacity=96,
                        kernel_impl="ref", speed_factor=0.26,
                        migrate_overhead_s=0.02),
    accel=ExecutionTarget("cuda-kernels", TargetKind.ACCEL, capacity=1,
                          kernel_impl="cuda", migrate_overhead_s=0.01),
)
