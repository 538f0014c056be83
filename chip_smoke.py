"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card (at fixed
shapes and at every shape the serve paths below launch it at), then
serves full-width smollm-135m (random seeded weights) through
``ContinuousBatchingEngine`` under the Xar-Trek runtime: ACCEL-pinned in
bfloat16 (the main path), HOST against ACCEL against forced migration in
float32, the dense pool against the paged one, and Algorithm 2 migrating
under synthetic host load.  Each path runs with both launch counters set
to 0 and is checked to have launched each kernel once per layer per ACCEL
step it ran.  Every failed check raises, so the exit code is non-zero and
the result lines are not printed.  Without CUDA it exits non-zero at
once.

The last two lines are a ``{"kernels": [...]}`` JSON object (per kernel:
launches on the main path, error against the plain version, kernel /
plain / library time in ms, and the bound the card's peak rates give) and
``{"ok": true, "device": {...}}``.  Every number measured here is also
written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

RESULTS: dict = {"phases": {}}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ card

def phase_card():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.BUILDER.load_all()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {name} | nvidia-smi: {smi} | kernel build "
          f"{build_s:.1f} s", flush=True)
    regs = [ln.strip() for log in _build.BUILDER.ptxas_log.values()
            for ln in log.splitlines() if "registers" in ln]
    RESULTS["phases"]["card"] = {"device": name, "nvidia_smi": smi,
                                 "build_s": build_s, "ptxas": regs}
    return name, smi


# --------------------------------------------------------------- kernels

PROMPT_LENS = (16, 37, 64, 100, 200, 333, 480, 600)
N_NEW = 32
MAX_SEQ = 1024


def key_a(q, k) -> tuple:
    """Shape key of one kernel A call: (B, S, T, H, KV, hd, dtype)."""
    B, S, H, hd = q.shape
    return (B, S, k.shape[1], H, k.shape[2], hd, str(q.dtype))


def key_b(q, k_pages, tables) -> tuple:
    """Shape key of one kernel B call: (B, KV, G, hd, NP, BS, NBT, q dtype,
    pool dtype)."""
    return (*q.shape, *k_pages.shape[:2], tables.shape[1], str(q.dtype),
            str(k_pages.dtype))


class ShapeLog:
    """Records the shape key of every kernel call the serve paths make, by
    wrapping the two names ``kernels/ops.py`` launches through.  The
    wrappers' launch counters are untouched.  ``main`` checks that phase 2
    held the kernels against their plain versions at every key seen."""

    def __init__(self):
        self.seen = {"flash_prefill": set(), "paged_decode": set()}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._real = real_a, real_b = ops.flash_prefill, ops.paged_decode

        def a(q, k, v, kv_map):
            self.seen["flash_prefill"].add(key_a(q, k))
            return real_a(q, k, v, kv_map)

        def b(q, kp, vp, kn, vn, tables, lengths):
            self.seen["paged_decode"].add(key_b(q, kp, tables))
            return real_b(q, kp, vp, kn, vn, tables, lengths)

        ops.flash_prefill, ops.paged_decode = a, b
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_prefill, ops.paged_decode = self._real


def cases_a() -> list[tuple[int, int]]:
    """(B, S) of the kernel A checks: the fixed set (B=4, one S that is not
    a power of two) and the main path's own, one request per prefill at
    each prompt bucket of ``make_requests`` plus the engine's minimum
    bucket, at which the ACCEL build is warmed."""
    from repro_torch.serve.engine import prompt_bucket
    main = sorted({prompt_bucket(n) for n in PROMPT_LENS} | {8})
    return [(4, S) for S in (8, 200, 512)] + [(1, S) for S in main]


def cases_b() -> list[dict]:
    """Kernel B checks: the fixed set (NBT 16) and the serve paths' own.
    The paged engine has 8 slots over 256 blocks of 32 (NBT = 1024 / 32,
    lengths up to a 600-token prompt plus 31 new tokens); the dense engine
    of phase 4 (4 slots, ``max_seq`` 1024) views its cache as 128-position
    blocks under an identity table.  Each has a 0-length row and a full
    table."""
    bf, f32 = torch.bfloat16, torch.float32
    fixed = [0, 1, 31, 32, 100, 257, 400, 16 * 32]
    paged = [0, 16, 37, 100, 333, 512, 631, 32 * 32]
    return [
        dict(B=8, BS=32, NBT=16, NP=8 * 16 + 1, lengths=fixed, pool=bf,
             q=(bf, f32), table="perm"),
        dict(B=8, BS=32, NBT=16, NP=8 * 16 + 1, lengths=fixed, pool=f32,
             q=(f32,), table="perm"),
        dict(B=8, BS=32, NBT=32, NP=8 * 32 + 1, lengths=paged, pool=bf,
             q=(bf, f32), table="perm"),
        dict(B=4, BS=128, NBT=8, NP=4 * 8, lengths=[0, 47, 631, 1024],
             pool=bf, q=(f32,), table="identity"),
    ]


def phase_kernels():
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_prefill, flash_prefill_plain)
    from repro_torch.kernels.gqa_decode import paged_decode, paged_decode_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {"flash_prefill": [], "paged_decode": []}

    # kernel A: H=9 over KV=3, hd=64
    H, KV, hd = 9, 3, 64
    kv_map = torch.arange(H, device=dev, dtype=torch.int32) // (H // KV)
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in cases_a():
            q = torch.randn(B, S, H, hd, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, S, KV, hd, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, S, KV, hd, device=dev, generator=gen).to(dtype)
            got = flash_prefill(q, k, v, kv_map)
            want = flash_prefill_plain(q, k, v, kv_map)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"flash_prefill B={B} S={S} {dtype}: max|err| {err} > "
                  f"{TOL[dtype]}")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            ms = time_ms(lambda: flash_prefill(q, k, v, kv_map))
            plain = time_ms(lambda: flash_prefill_plain(q, k, v, kv_map))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            esz = q.element_size()
            nbytes = esz * B * S * hd * (2 * H + 2 * KV)
            flops = 4.0 * B * H * hd * S * (S + 1) / 2
            bms, by = bound_ms(nbytes, flops, dtype)
            rows["flash_prefill"].append(dict(
                key=key_a(q, k), B=B, S=S, dtype=str(dtype),
                max_abs_err=err, tol=TOL[dtype], ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by))
            print(f"kernel A flash_prefill B={B} S={S} H={H} KV={KV} "
                  f"hd={hd} {dtype}: max|err| {err:.2e} (tol "
                  f"{TOL[dtype]:.0e}) kernel {ms:.4f} ms plain "
                  f"{plain:.4f} ms sdpa {lib:.4f} ms bound {bms:.4f} ms "
                  f"({by})", flush=True)

    # kernel B: KV=3 kv heads, G=3 query heads each, hd=64
    KV, G = 3, 3
    perm_rng = np.random.RandomState(0)
    for case in cases_b():
        B, BS, NBT, NP = case["B"], case["BS"], case["NBT"], case["NP"]
        lengths_np = np.array(case["lengths"], np.int32)
        if case["table"] == "perm":
            ids = perm_rng.permutation(np.arange(1, NP))[:B * NBT]
        else:
            ids = np.arange(B * NBT)
        tables = torch.as_tensor(ids.reshape(B, NBT).astype(np.int32),
                                 device=dev)
        lengths = torch.as_tensor(lengths_np, device=dev)
        kp = torch.randn(NP, BS, KV, hd, device=dev,
                         generator=gen).to(case["pool"])
        vp = torch.randn(NP, BS, KV, hd, device=dev,
                         generator=gen).to(case["pool"])
        T = NBT * BS
        kc = kp[tables.long()].reshape(B, T, KV, hd)
        vc = vp[tables.long()].reshape(B, T, KV, hd)
        for qdt in case["q"]:
            q = torch.randn(B, KV, G, hd, device=dev, generator=gen).to(qdt)
            kn = torch.randn(B, KV, 1, hd, device=dev, generator=gen).to(qdt)
            vn = torch.randn(B, KV, 1, hd, device=dev, generator=gen).to(qdt)
            got = paged_decode(q, kp, vp, kn, vn, tables, lengths)
            want = paged_decode_plain(q, kp, vp, kn, vn, tables, lengths)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            desc = (f"B={B} BS={BS} NBT={NBT} NP={NP} q {qdt} pool "
                    f"{case['pool']} ({case['table']} table)")
            check(math.isfinite(err) and err <= TOL[qdt],
                  f"paged_decode {desc}: max|err| {err} > {TOL[qdt]}")
            zero_row = (got[0].float() - vn[0].float().expand(KV, G, hd)) \
                .abs().max().item()
            check(zero_row <= TOL[qdt],
                  f"paged_decode {desc}: len 0 row is not v_new ({zero_row})")
            # library yardstick: SDPA over the gathered cache plus the token
            qs = q.reshape(B, KV * G, 1, hd)
            ks = torch.cat([kc.to(qdt), kn.transpose(1, 2)], 1).transpose(1, 2)
            vs = torch.cat([vc.to(qdt), vn.transpose(1, 2)], 1).transpose(1, 2)
            pos = torch.arange(T + 1, device=dev)
            mask = ((pos[None, :] < lengths[:, None]) | (pos[None, :] == T))
            mask = mask[:, None, None, :]
            ms = time_ms(lambda: paged_decode(q, kp, vp, kn, vn, tables,
                                              lengths))
            plain = time_ms(lambda: paged_decode_plain(q, kp, vp, kn, vn,
                                                       tables, lengths))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True))
            live = int(lengths_np.sum())
            qsz = q.element_size()
            nbytes = (2 * live * KV * hd * kp.element_size()
                      + qsz * (2 * B * KV * G * hd + 2 * B * KV * hd)
                      + 4 * (B * NBT + B))
            flops = 4.0 * G * hd * KV * (live + B)
            bms, by = bound_ms(nbytes, flops, qdt)
            rows["paged_decode"].append(dict(
                key=key_b(q, kp, tables), q_dtype=str(qdt),
                pool_dtype=str(case["pool"]), BS=BS, NBT=NBT, NP=NP,
                table=case["table"], lengths=lengths_np.tolist(),
                max_abs_err=err, tol=TOL[qdt], ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by))
            print(f"kernel B paged_decode {desc} KV={KV} G={G} hd={hd}: "
                  f"max|err| {err:.2e} (tol {TOL[qdt]:.0e}) kernel "
                  f"{ms:.4f} ms plain {plain:.4f} ms sdpa {lib:.4f} ms "
                  f"bound {bms:.4f} ms ({by})", flush=True)
    RESULTS["phases"]["kernels"] = rows
    return rows


# ----------------------------------------------------------------- serve

def make_requests(vocab: int, stop_token=None, n_new: int = N_NEW):
    from repro_torch.serve import GenerationRequest, SamplingParams
    rng = np.random.RandomState(1234)
    reqs = []
    for i, n in enumerate(PROMPT_LENS):
        sp = (SamplingParams(logprobs=True) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                             seed=100 + i, logprobs=True))
        stop = (stop_token,) if (i == 0 and stop_token is not None) else ()
        reqs.append(GenerationRequest(rng.randint(0, vocab, size=n),
                                      max_new_tokens=n_new, sampling=sp,
                                      stop_tokens=stop))
    return reqs


def serve(engine, reqs):
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(outs) == len(reqs), "not every request finished")
    toks = [outs[r.req_id].tokens.tolist() for r in reqs]
    return outs, toks, wall


def new_engine(cfg, params, policy, paged=True, eager=True, reconfig=0.0,
               max_slots=8):
    from repro_torch.core.function import FunctionRegistry
    from repro_torch.core.runtime import XarTrekRuntime
    from repro_torch.core.targets import H100_PLATFORM
    from repro_torch.serve import ContinuousBatchingEngine
    rt = XarTrekRuntime(H100_PLATFORM, registry=FunctionRegistry(),
                        min_reconfig_seconds=reconfig)
    eng = ContinuousBatchingEngine(
        cfg, paged=paged, max_slots=max_slots, max_seq=MAX_SEQ, runtime=rt,
        params=params, policy=policy, eager_accel=eager, device="cuda")
    return eng, rt


def zero_launches() -> None:
    from repro_torch.kernels.flash_attention import flash_prefill
    from repro_torch.kernels.gqa_decode import paged_decode
    flash_prefill.launches = 0
    paged_decode.launches = 0


def accel_runs(summ, fn: str) -> int:
    """ACCEL executions of step ``fn`` in a runtime summary: the calls it
    served plus its warm-ups (a warm-up runs the step once)."""
    pf = summ["per_function"].get(fn)
    if pf is None:
        return 0
    return (pf["calls"].get("accel", 0)
            + pf["compiles"].get("accel", {}).get("compiles", 0))


def read_launches(path: str, rt, L: int, before=None,
                  kernels: bool = True) -> dict:
    """Read both launch counters after one path ran (they were set to 0
    just before it) and check them against that path's runtime: kernel A
    once per layer per ACCEL prefill execution, kernel B once per layer
    per ACCEL decode execution.  ``before`` is the runtime's summary when
    the counters were zeroed (None for a runtime made after it).  With
    ``kernels=False`` (a PinHost engine, whose ACCEL build reuses the
    HOST functions) neither kernel may have launched at all."""
    from repro_torch.kernels.flash_attention import flash_prefill
    from repro_torch.kernels.gqa_decode import paged_decode
    got = {"flash_prefill": flash_prefill.launches,
           "paged_decode": paged_decode.launches}
    after = rt.summary()

    def delta(fn):
        return accel_runs(after, fn) - (accel_runs(before, fn)
                                        if before is not None else 0)

    n_pre, n_dec = delta("cb_prefill"), delta("cb_decode")
    if not kernels:
        n_pre = n_dec = 0
    check(got["flash_prefill"] == L * n_pre,
          f"{path}: kernel A launches {got['flash_prefill']} != {L} x "
          f"{n_pre} ACCEL prefill executions")
    check(got["paged_decode"] == L * n_dec,
          f"{path}: kernel B launches {got['paged_decode']} != {L} x "
          f"{n_dec} ACCEL decode executions")
    print(f"{path}: launches {got} = {L} x ({n_pre} prefill, {n_dec} "
          f"decode) ACCEL executions", flush=True)
    return dict(launches=got, accel_prefills=n_pre, accel_decodes=n_dec)


def phase_serve_accel(cfg, params, shapes: ShapeLog):
    from repro_torch.core.policy import PinAccel
    L = cfg.num_layers
    eng, rt = new_engine(cfg, params, PinAccel())
    # warm pass: every prompt bucket is warmed, and request 0 (greedy)
    # shows which token the measured pass can stop on
    with shapes:
        _, warm_toks, _ = serve(eng, make_requests(cfg.vocab_size))
    stop_tok = warm_toks[0][3]
    reqs = make_requests(cfg.vocab_size, stop_token=stop_tok)
    before = rt.summary()
    eng.reset_stats()
    zero_launches()
    outs, toks, wall = serve(eng, reqs)
    counts = read_launches("serve ACCEL bf16 paged", rt, L, before)
    after = rt.summary()

    def calls(fn, tgt):
        return (after["per_function"][fn]["calls"].get(tgt, 0)
                - before["per_function"][fn]["calls"].get(tgt, 0))

    n_pre, n_dec = calls("cb_prefill", "accel"), calls("cb_decode", "accel")
    check(calls("cb_prefill", "host") == 0 and calls("cb_decode", "host")
          == 0, "a step ran on HOST under PinAccel")
    check(n_pre == eng.stats["prefills"] and n_dec ==
          eng.stats["decode_steps"], "runtime/engine step counts differ")
    check(counts["accel_prefills"] == n_pre > 0
          and counts["accel_decodes"] == n_dec > 0,
          "the measured run warmed an ACCEL step or ran none")

    def misses(summ):
        return {k: v["misses"] for k, v in summ["shape_buckets"].items()}
    check(misses(after) == misses(before),
          "a shape bucket was warmed inside the measured run")
    check(outs[reqs[0].req_id].finish_reason == "stop",
          "the stop-token request did not stop")
    check(all(o.finish_reason == "length" for r, o in
              ((r, outs[r.req_id]) for r in reqs[1:])),
          "a request without stop tokens did not run its budget")
    for o in outs.values():
        check(o.logprobs is not None and np.isfinite(o.logprobs).all()
              and (o.tokens >= 0).all() and (o.tokens < cfg.vocab_size).all(),
              "non-finite logprob or out-of-vocab token")
    n_tok = sum(o.n_tokens for o in outs.values())
    ttft = float(np.median([o.ttft_s for o in outs.values()]))
    tpot = float(np.median([o.tpot_s for o in outs.values()]))
    launches = counts["launches"]
    res = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
               tok_per_s=n_tok / wall, ttft_p50_s=ttft, tpot_p50_s=tpot,
               prefills=n_pre, decode_steps=n_dec, launches=launches)
    print(f"serve ACCEL bf16 paged: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tok/s, TTFT p50 {ttft * 1e3:.1f} ms, TPOT "
          f"p50 {tpot * 1e3:.2f} ms, {n_pre} prefills, {n_dec} decode "
          f"steps, launches {launches}", flush=True)
    RESULTS["phases"]["serve_accel"] = res
    del eng, rt
    torch.cuda.empty_cache()
    return launches, stop_tok


@dataclasses.dataclass
class FlipEvery:
    """Scripted policy: HOST, then ACCEL, switching every ``n`` decisions
    of each step function (forced mid-stream migration)."""

    n: int = 3
    name: str = "flip_every"

    def __post_init__(self):
        self.count: dict[str, int] = {}

    def decide(self, signals, row, residency):
        from repro_torch.core.policy import Decision
        from repro_torch.core.targets import TargetKind
        c = self.count.get(row.app, 0)
        self.count[row.app] = c + 1
        accel = (c // self.n) % 2 == 1 and residency.resident
        return Decision(TargetKind.ACCEL if accel else TargetKind.HOST)


def phase_host_vs_accel(cfg, params, stop_tok, shapes: ShapeLog):
    from repro_torch.core.policy import PinAccel, PinHost
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    L = cfg32.num_layers
    p32 = {k: _float(v) for k, v in params.items()}
    results, counts = {}, {}
    for name, policy, paged, n_req in (
            ("host", PinHost(), True, 8), ("accel", PinAccel(), True, 8),
            ("flip", FlipEvery(3), True, 8),
            ("dense_accel", PinAccel(), False, 4)):
        zero_launches()
        with shapes:
            eng, rt = new_engine(cfg32, p32, policy, paged=paged,
                                 max_slots=n_req)
            _, toks, wall = serve(
                eng, make_requests(cfg32.vocab_size, stop_tok)[:n_req])
        path = f"float32 {'paged' if paged else 'dense'} {name}"
        c = counts[name] = read_launches(
            path, rt, L, kernels=not isinstance(policy, PinHost))
        results[name] = toks
        summ = rt.summary()
        print(f"{path}: {wall:.2f} s, per target {summ['per_target']}, "
              f"migrations {summ['migrations']}", flush=True)
        if isinstance(policy, PinHost):
            check(summ["per_target"]["accel"] == 0,
                  f"{path}: a step ran on ACCEL under PinHost")
        if isinstance(policy, PinAccel):
            check(summ["per_target"]["host"] == 0,
                  f"{path}: a step ran on HOST under PinAccel")
            check(c["launches"]["flash_prefill"] > 0
                  and c["launches"]["paged_decode"] > 0,
                  f"{path}: a kernel was never launched")
        if name == "flip":
            calls = summ["per_function"]["cb_decode"]["calls"]
            check(calls.get("host", 0) > 0 and calls.get("accel", 0) > 0
                  and summ["migrations"] >= 2
                  and c["launches"]["paged_decode"] > 0,
                  "flip policy did not migrate")
        del eng, rt
        torch.cuda.empty_cache()
    check(results["host"] == results["accel"],
          "HOST and ACCEL tokens differ (float32, paged) at "
          + first_difference(results["host"], results["accel"]))
    check(results["flip"] == results["host"],
          "tokens under forced migration differ from HOST at "
          + first_difference(results["host"], results["flip"]))
    check(results["dense_accel"] == results["accel"][:4],
          "dense-pool tokens differ from the paged pool's at "
          + first_difference(results["dense_accel"], results["accel"][:4]))
    print("float32 HOST == ACCEL == forced migration (paged); dense == "
          "paged: identical greedy and seeded tokens", flush=True)
    RESULTS["phases"]["host_vs_accel"] = {
        "identical": True, "requests": len(results["host"]),
        "launches": counts}


def first_difference(a, b) -> str:
    """Where two runs' token lists first differ (for failure messages)."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return f"request {i} position {j}: {u} vs {v}"
        if len(x) != len(y):
            return f"request {i}: lengths {len(x)} vs {len(y)}"
    return "none"


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


def phase_migration(cfg, params, shapes: ShapeLog):
    from repro_torch.core.policy import XarTrekHeuristic
    from repro_torch.core.targets import TargetKind
    zero_launches()
    with shapes:
        eng, rt = new_engine(cfg, params, XarTrekHeuristic(), eager=False,
                             reconfig=1.0)
        row = rt.table.row("cb_decode")
        row.fpga_thr, row.arm_thr = 6.0, 1e9
        phases = {}
        for pi, load in enumerate((0, 8)):
            if pi == 1:
                deadline = time.time() + 300.0
                while (not rt.bank.is_resident("cb_decode")
                       and time.time() < deadline):
                    rt.bank.raise_if_failed("cb_decode")
                    time.sleep(0.05)
                check(rt.bank.is_resident("cb_decode"),
                      "ACCEL decode never became resident")
            for _ in range(load):
                rt.monitor.job_started(TargetKind.HOST)
            mark = len(rt.call_log)
            try:
                _, _, wall = serve(eng, make_requests(cfg.vocab_size,
                                                      n_new=16))
            finally:
                for _ in range(load):
                    rt.monitor.job_finished(TargetKind.HOST)
            targets = [r["target"] for r in rt.call_log[mark:]
                       if r["fn"] == "cb_decode"]
            phases[f"load_{load}"] = {t: targets.count(t)
                                      for t in set(targets)}
        # a background ACCEL load still warming would launch after the read
        deadline = time.time() + 300.0
        while (any(rt.bank.is_loading(f) for f in ("cb_prefill", "cb_decode"))
               and time.time() < deadline):
            time.sleep(0.05)
        check(not any(rt.bank.is_loading(f)
                      for f in ("cb_prefill", "cb_decode")),
              "an ACCEL load never finished")
    counts = read_launches("migration bf16 paged", rt, cfg.num_layers)
    summ = rt.summary()
    check(summ["migrations"] >= 1, "Algorithm 2 never migrated")
    check(counts["accel_decodes"] > 0
          and counts["launches"]["paged_decode"] > 0,
          "no decode step ran on ACCEL under load")
    check(not summ["load_failures"], f"ACCEL load failed: "
          f"{summ['load_failures']}")
    print(f"migration under load (XarTrekHeuristic): decode targets "
          f"{phases}, migrations {summ['migrations']}, bank "
          f"{summ['bank']}", flush=True)
    RESULTS["phases"]["migration"] = {"decode_targets": phases,
                                      "migrations": summ["migrations"],
                                      "launches": counts}
    del eng, rt
    torch.cuda.empty_cache()


def check_coverage(rows, shapes: ShapeLog) -> None:
    """Every shape key a serve path launched a kernel at was held against
    the plain version in phase 2."""
    for kname in ("flash_prefill", "paged_decode"):
        checked = {tuple(r["key"]) for r in rows[kname]}
        missing = shapes.seen[kname] - checked
        check(not missing, f"{kname} ran at shapes phase 2 never checked: "
              f"{sorted(missing)}")
        print(f"{kname}: serve paths launched it at {len(shapes.seen[kname])}"
              f" shape keys, all checked in phase 2: "
              f"{sorted(shapes.seen[kname])}", flush=True)
    RESULTS["phases"]["shape_keys"] = {
        k: sorted(map(list, v)) for k, v in shapes.seen.items()}


# ------------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.weights import init_params
    check(os.path.dirname(repro_torch.__file__)
          == os.path.join(ROOT, "src", "repro_torch"),
          f"repro_torch imported from {repro_torch.__file__}, not from "
          f"this checkout's src/")

    t_start = time.perf_counter()
    name, smi = phase_card()
    rows = phase_kernels()
    cfg = get_arch("smollm-135m")
    params = init_params(cfg, device="cuda", seed=0)
    shapes = ShapeLog()
    launches, stop_tok = phase_serve_accel(cfg, params, shapes)
    phase_host_vs_accel(cfg, params, stop_tok, shapes)
    phase_migration(cfg, params, shapes)
    check_coverage(rows, shapes)

    # the line's times are at the main path's own shapes: kernel A at its
    # largest prompt bucket (one 600-token request, S = 1024), kernel B
    # over the paged engine's 8 x 32-entry tables, both in bfloat16
    main_a = next(r for r in rows["flash_prefill"]
                  if (r["B"], r["S"]) == (1, MAX_SEQ)
                  and r["dtype"] == "torch.bfloat16")
    main_b = next(r for r in rows["paged_decode"]
                  if r["NBT"] == MAX_SEQ // 32 and r["table"] == "perm"
                  and r["q_dtype"] == "torch.bfloat16")
    kernels = []
    for kname, src, replaces, r in (
            ("flash_prefill", "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_attention.py:82", main_a),
            ("paged_decode", "src/repro_torch/kernels/csrc/paged_decode.cu",
             "src/repro/kernels/gqa_decode.py:247", main_b)):
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(x["max_abs_err"] for x in rows[kname]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    RESULTS["kernels"] = kernels
    RESULTS["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(f"total {RESULTS['total_s']:.1f} s | {name} | {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
