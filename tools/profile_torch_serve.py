"""Where the time goes when the PyTorch port serves on the card.

    python3 tools/profile_torch_serve.py

Serves the same 8 requests as ``chip_smoke.py``'s main path (full-width
smollm-135m, bfloat16, paged pool, ACCEL-pinned under the Xar-Trek
runtime) once to warm up, then again under ``torch.profiler``.  Prints,
as one JSON line (also written to ``chiprun_out/profile_torch_serve.json``):
wall time, the summed device time of every kernel, the device's busy and
idle shares of the wall time, the device time per kernel class (the
port's two kernels, matrix products, everything else) and the top
kernels by device time.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def classify(name: str) -> str:
    low = name.lower()
    if "flash_prefill_kernel" in low:
        return "kernel A flash_prefill"
    if "paged_decode_kernel" in low:
        return "kernel B paged_decode"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "sm90")):
        return "matrix products (cuBLAS)"
    if any(s in low for s in ("sort", "scan", "cumsum", "radix")):
        return "sort / scan (sampling)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import PinAccel
    from repro_torch.weights import init_params

    cfg = get_arch("smollm-135m")
    params = init_params(cfg, device="cuda", seed=0)
    eng, _ = cs.new_engine(cfg, params, PinAccel())
    cs.serve(eng, cs.make_requests(cfg.vocab_size))           # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        outs, _, _ = cs.serve(eng, cs.make_requests(cfg.vocab_size))
        wall = time.perf_counter() - t0
    kernels: dict[str, float] = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    device_ms = sum(kernels.values())
    classes: dict[str, float] = {}
    for name, ms in kernels.items():
        classes[classify(name)] = classes.get(classify(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    res = {
        "device": torch.cuda.get_device_name(0),
        "requests": len(outs),
        "tokens": sum(o.n_tokens for o in outs.values()),
        "wall_ms": wall * 1e3,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / (wall * 1e3),
        "device_idle_share": 1.0 - device_ms / (wall * 1e3),
        "class_ms": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [[n[:120], ms] for n, ms in top],
        "distinct_kernels": len(kernels),
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_torch_serve.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
