"""Build the CUDA sources in ``csrc/`` on first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (``extern "C"`` launchers that
return ``cudaGetLastError()``), loaded through ``ctypes``.  No PyTorch
header is included, so a source builds in seconds.  All sources compile
in parallel (one ``nvcc`` process each, started together).

Libraries land in ``kernels/_build/`` (listed in ``.gitignore``) under a
file name carrying a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  A failed ``nvcc``
run raises with its stderr; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]
SOURCES = ("flash_prefill", "paged_decode")


class BuildError(RuntimeError):
    pass


class _Builder:
    """Owns the loaded libraries of one process (built at most once)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.libs: dict[str, ctypes.CDLL] = {}
        self.ptxas_log: dict[str, str] = {}

    @staticmethod
    def nvcc() -> str:
        for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
            if cand and os.path.exists(cand):
                return cand
        raise BuildError("nvcc not found (PATH or /usr/local/cuda/bin)")

    @staticmethod
    def _target(name: str) -> str:
        with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
            src = f.read()
        common = os.path.join(CSRC, "common.cuh")
        with open(common, "rb") as f:
            src += f.read()
        digest = hashlib.sha256(
            src + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")

    def load_all(self) -> dict[str, ctypes.CDLL]:
        with self._lock:
            if len(self.libs) == len(SOURCES):
                return self.libs
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = {}
            for name in SOURCES:
                out = self._target(name)
                if os.path.exists(out):
                    continue
                tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
                cmd = [self.nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC, name + ".cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True), tmp, out)
            errors = []
            for name, (proc, tmp, out) in procs.items():
                stdout, stderr = proc.communicate()
                self.ptxas_log[name] = stdout + stderr
                if proc.returncode != 0:
                    errors.append(f"nvcc {name}.cu failed "
                                  f"(rc {proc.returncode}):\n{stderr}")
                else:
                    os.replace(tmp, out)
            if errors:
                raise BuildError("\n".join(errors))
            for name in SOURCES:
                self.libs[name] = ctypes.CDLL(self._target(name))
            return self.libs


BUILDER = _Builder()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (builds every source on
    the first call)."""
    return BUILDER.load_all()[name]
