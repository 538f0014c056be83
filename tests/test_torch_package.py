"""Package-level rules of the PyTorch port: it imports neither JAX nor the
JAX package, its entry points never drop to the CPU on their own, options
outside the ported slice raise, and ``chip_smoke.py`` refuses to run
without a card or outside the repository."""
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.models.model import build_model
from repro_torch.serve import (
    ClusterFrontEnd, ContinuousBatchingEngine, ProcClusterFrontEnd,
    ServeEngine,
)
from repro_torch.weights import from_jax_params, init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(repro_torch.__file__)
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{i}: {line}")
    assert not bad, "".join(bad)
    assert len(list(_port_sources())) > 20


def test_kernel_wrappers_call_no_library_attention():
    """Kernels A and B are the hand-written CUDA launches: their wrappers
    and launch plumbing call no library matmul or fused attention."""
    library = re.compile(r"matmul|scaled_dot_product_attention|cublas|"
                         r"cudnn|torch\.compile|einsum|bmm")
    for name in ("flash_attention.py", "gqa_decode.py", "_launch.py",
                 "_build.py"):
        with open(os.path.join(PKG, "kernels", name)) as fh:
            code = [ln for ln in fh if not ln.lstrip().startswith("#")]
        body = "".join(code).split('"""')[2::2]   # code between docstrings
        assert not library.search("".join(body)), name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    cfg = reduced(get_arch("smollm-135m"))
    for call in (lambda: build_model(cfg),
                 lambda: init_params(cfg),
                 lambda: from_jax_params({}, cfg),
                 lambda: ContinuousBatchingEngine(cfg, max_slots=1,
                                                  max_seq=16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    eng = ContinuousBatchingEngine(cfg, max_slots=1, max_seq=16,
                                   device="cpu")
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("option,value,item", [
    ("prefix_cache", True, "item 9"),
    ("allow_lossy_prefix_cache", True, "item 9"),
    ("prefill_tokens_per_step", 4, "item 9"),
    ("spec_decode", True, "item 10"),
    ("mesh", object(), "item 14"),
    ("lane_align", True, "lane_align"),
])
def test_out_of_slice_engine_options_raise(option, value, item):
    cfg = reduced(get_arch("smollm-135m"))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md .*{item}"):
        ContinuousBatchingEngine(cfg, paged=True, device="cpu",
                                 **{option: value})


def test_out_of_slice_configs_and_classes_raise():
    cfg = reduced(get_arch("smollm-135m"))
    with pytest.raises(NotImplementedError, match="item 8"):
        ContinuousBatchingEngine(
            dataclasses.replace(cfg, kv_cache_dtype="int8"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        ContinuousBatchingEngine(dataclasses.replace(cfg, family="moe"),
                                 device="cpu")
    for cls, item in ((ServeEngine, "item 12"), (ClusterFrontEnd, "item 11"),
                      (ProcClusterFrontEnd, "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            cls(cfg)
    eng = ContinuousBatchingEngine(cfg, paged=True, device="cpu",
                                   max_slots=1, max_seq=16)
    for call in (eng.prefill_to_span, eng.submit_span):
        with pytest.raises(NotImplementedError, match="item 9"):
            call(None)


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_card_and_outside_the_repo(tmp_path):
    """No card (this machine): non-zero exit, no result line.  Alone in a
    directory: non-zero exit too (the port is not importable there)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    here = _run_smoke(ROOT, env)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = _run_smoke(tmp_path, {**env, "CUDA_VISIBLE_DEVICES": "0"})
    for res in (here, alone):
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
