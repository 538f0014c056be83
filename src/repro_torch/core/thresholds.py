"""Threshold table + Algorithm 1 (dynamic threshold update) — faithful port.

The table is the compiler's Table-2 artifact: per application, the
hardware-kernel name and the x86-load thresholds above which migration
to ACCEL ("FPGA_THR") / AUX ("ARM_THR") is profitable.  The run-time
client refines it after every function return with the observed
execution time and load, exactly as the paper's Algorithm 1.
"""
from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.core.targets import TargetKind

INF = math.inf


@dataclasses.dataclass
class ThresholdRow:
    app: str
    hw_kernel: str
    fpga_thr: float = INF          # load above which ACCEL wins
    arm_thr: float = INF           # load above which AUX wins
    # last observed execution times per target (paper: recorded data)
    x86_exec: float = INF
    arm_exec: float = INF
    fpga_exec: float = INF

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ThresholdTable:
    rows: dict[str, ThresholdRow] = dataclasses.field(default_factory=dict)
    increase_step: float = 1.0     # "Increase THR" granularity (Alg.1 l.16/21)

    def row(self, app: str, hw_kernel: str = "") -> ThresholdRow:
        if app not in self.rows:
            self.rows[app] = ThresholdRow(app=app, hw_kernel=hw_kernel
                                          or f"KNL_HW_{app.upper()}")
        return self.rows[app]

    # ------------------------------------------------ Algorithm 1 (verbatim)
    def update(self, app: str, executed_on: TargetKind, exec_time: float,
               cpu_load: float) -> None:
        """One dynamic-threshold-update step after a function returns.

        Paper Algorithm 1: lines annotated.
        """
        r = self.row(app)
        # l.1-2: record application execution time + CPU load
        if executed_on == TargetKind.HOST:                      # l.3
            r.x86_exec = exec_time
            if (r.x86_exec > r.fpga_exec) and (cpu_load < r.fpga_thr):  # l.4
                r.fpga_thr = cpu_load                           # l.5
            elif (r.x86_exec > r.arm_exec) and (cpu_load < r.arm_thr):  # l.7
                r.arm_thr = cpu_load                            # l.8
            # else: only x86_exec recorded                      # l.10
        elif executed_on == TargetKind.AUX:                     # l.14
            r.arm_exec = exec_time
            if r.arm_exec > r.x86_exec:                         # l.15
                r.arm_thr += self.increase_step                 # l.16
        elif executed_on == TargetKind.ACCEL:                   # l.19
            r.fpga_exec = exec_time
            if r.fpga_exec > r.x86_exec:                        # l.20
                r.fpga_thr += self.increase_step                # l.21

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        def enc(v):
            return "inf" if v == INF else v

        data = {a: {k: enc(v) for k, v in r.to_dict().items()}
                for a, r in self.rows.items()}
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ThresholdTable":
        def dec(v):
            return INF if v == "inf" else v

        with open(path) as f:
            data = json.load(f)
        table = cls()
        for app, row in data.items():
            table.rows[app] = ThresholdRow(
                **{k: dec(v) for k, v in row.items()})
        return table

    def as_table2(self) -> list[dict]:
        """Paper Table-2 shaped report."""
        return [{"Benchmark": r.app, "HW Kernel": r.hw_kernel,
                 "FPGA_THR": r.fpga_thr, "ARM_THR": r.arm_thr}
                for r in self.rows.values()]
