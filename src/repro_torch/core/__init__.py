"""Xar-Trek core of the port: run-time execution migration between the
HOST (plain PyTorch) and ACCEL (hand-written CUDA kernels) builds of each
step function.  Port of ``repro.core``'s in-process run-time.
"""
from repro_torch.core.targets import (
    DEFAULT_PLATFORM, H100_PLATFORM, ExecutionTarget, TargetKind,
)
from repro_torch.core.thresholds import ThresholdRow, ThresholdTable
from repro_torch.core.policy import Decision, schedule
from repro_torch.core.scheduler import SchedulerClient, SchedulerServer
