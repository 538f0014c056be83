"""Checks and ctypes plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def placement(*tensors: torch.Tensor) -> str:
    """"cpu" when every tensor lies on the CPU (the wrapper then runs the
    plain version), "cuda" when every tensor lies on one CUDA device (the
    wrapper launches the kernel).  Anything else raises: a kernel never
    silently runs elsewhere than where its inputs are."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs span devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type in ("cpu", "cuda"):
        return dev.type
    raise ValueError(f"no kernel for device {dev}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        require(t.is_contiguous(), f"{name} must be contiguous")


def dtype_code(name: str, t: torch.Tensor) -> int:
    code = DTYPE_CODE.get(t.dtype)
    require(code is not None,
            f"{name} dtype {t.dtype} not supported (float32 or bfloat16)")
    return code


def c_function(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(_build.library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_rc(rc: int, what: str) -> None:
    """Raise on a refused launch: a launch that never ran is invisible to
    ``torch.cuda.synchronize``."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
