"""Continuous-batching serve engine of the port.

Port of ``repro/serve/engine.py``'s ``ContinuousBatchingEngine`` for the
default engine: dense (``paged=False``) or paged (``paged=True``) KV, the
v2 request API (``submit`` -> streaming ``RequestHandle``, ``run``,
``generate``, ``abort``, stop tokens), preempt/resume when the block pool
runs dry, serve telemetry (``signals``), and every prefill/decode step
dispatched through the Xar-Trek runtime when one is given.

Requests are admitted into per-request KV slots; each loop iteration
admits arrived requests (one bucketed prefill each) and then advances
every in-flight request by one token (one ragged decode across all
slots).  Sampling runs inside the step functions (``models/sampling``),
so HOST, ACCEL and any mid-stream migration between them give the same
tokens.

With a ``runtime``, the engine registers ``{fn_prefix}_prefill`` and
``{fn_prefix}_decode`` as migratable functions: HOST is the plain PyTorch
math (the JAX ``xla`` build), ACCEL the same ABI on kernels A (flash
prefill) and B (paged decode; the dense cache reaches it through an
identity block table).  ``eager_accel=True`` (the default) waits at
construction until the ACCEL build — kernel build plus warm-up — is
resident, and raises if it failed; ``eager_accel=False`` keeps the
paper's asynchronous pre-configuration (steps run on HOST until the
build lands; a failed build re-raises at the next step).

The KV cache is updated in place by the decode step (the JAX engine
donated it to XLA).  Options of the JAX engine outside this slice raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.configs.model_config import ModelConfig
from repro_torch.core.function import MigratableFunction
from repro_torch.core.policy import (
    LoadSignals, PinAccel, PinHost, SchedulingPolicy, ewma, resolve_policy,
)
from repro_torch.core.runtime import XarTrekRuntime
from repro_torch.core.targets import TargetKind
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import build_model
from repro_torch.models.sampling import sampling_leaves
from repro_torch.serve.api import (
    FINISH_ABORTED, FINISH_LENGTH, FINISH_STOP, GenerationRequest,
    RequestHandle, RequestOutput, SamplingParams,
)
from repro_torch.serve.batch import PagedSlotManager, Slot, SlotManager
from repro_torch.serve.scheduler import RequestQueue

# options of the JAX engine outside this slice -> the ROADMAP.md item
# that ports them
_NOT_PORTED = {
    "prefix_cache": "queue 1, item 9 (paged chunk prefill + prefix cache, "
                    "kernel E)",
    "allow_lossy_prefix_cache": "queue 1, item 9 (prefix cache)",
    "prefill_tokens_per_step": "queue 1, item 9 (chunked prefill, kernel E)",
    "spec_decode": "queue 1, item 10 (speculative decoding)",
    "mesh": "queue 1, item 14 (parallel/ onto torch DeviceMesh)",
    "lane_align": "queue 2 note on lane_align (TPU lane padding; the CUDA "
                  "kernels take the real head_dim)",
}


def prompt_bucket(n: int, min_bucket: int = 8) -> int:
    """Next power-of-two prefill width >= n (bounds warm-ups to
    O(log max_prompt) shape buckets)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _not_ported(option: str):
    return NotImplementedError(
        f"{option} is not ported; see ROADMAP.md {_NOT_PORTED[option]}")


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one shared KV cache.

    ``max_slots`` is the decode width; ``max_seq`` bounds prompt +
    generation per slot.  ``paged=True`` replaces the dense rows with a
    block pool (``block_size`` positions per block, ``num_blocks`` usable
    blocks, default the dense footprint): admission takes the prompt's
    blocks plus a one-block watermark, decode allocates on demand, and the
    youngest slot is preempted and later resumed by re-prefill when the
    pool runs dry.  ``policy`` is a ``SchedulingPolicy`` (or alias):
    ``PinHost``/``PinAccel`` can drive the direct path, every other policy
    needs ``runtime``.  ``device=None`` means the card (``RuntimeError``
    without CUDA); tests pass ``device="cpu"``.
    """

    def __init__(self, cfg: ModelConfig, max_slots: int = 8,
                 max_seq: int = 128, params=None, seed: int = 0,
                 runtime: Optional[XarTrekRuntime] = None,
                 fn_prefix: str = "cb", min_bucket: int = 8,
                 paged: bool = False, block_size: int = 32,
                 num_blocks: Optional[int] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 eager_accel: bool = True, device=None, *,
                 mesh=None, prefix_cache: bool = False,
                 allow_lossy_prefix_cache: bool = False,
                 lane_align: Optional[bool] = None,
                 prefill_tokens_per_step: Optional[int] = None,
                 spec_decode: bool = False):
        for option, value in (("mesh", mesh), ("lane_align", lane_align),
                              ("prefill_tokens_per_step",
                               prefill_tokens_per_step)):
            if value is not None:
                raise _not_ported(option)
        for option, value in (("prefix_cache", prefix_cache),
                              ("allow_lossy_prefix_cache",
                               allow_lossy_prefix_cache),
                              ("spec_decode", spec_decode)):
            if value:
                raise _not_ported(option)
        if cfg.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "kv_cache_dtype='int8' is not ported; see ROADMAP.md "
                "queue 1, item 8 (int8 KV pool, kernels D and F)")
        self.cfg = cfg
        self.model = build_model(cfg, device)
        self.device = self.model.device
        self.runtime = runtime
        self.min_bucket = min_bucket
        self.paged = paged
        self.policy = resolve_policy(policy) if policy is not None else None
        if (self.policy is not None and runtime is None
                and not isinstance(self.policy, (PinHost, PinAccel))):
            raise ValueError(
                f"policy {getattr(self.policy, 'name', self.policy)!r} "
                f"decides per step and needs a runtime=; only "
                f"PinHost/PinAccel can drive the direct path")
        if runtime is not None and self.policy is not None:
            runtime.server.policy = self.policy
        if params is None:
            from repro_torch.weights import init_params
            params = init_params(cfg, device=self.device, seed=seed)
        self.params = params
        self.queue = RequestQueue()
        if paged:
            self.block_size = block_size
            nb = num_blocks or max_slots * (-(-max_seq // block_size))
            self.slots: SlotManager = PagedSlotManager(
                max_slots, block_size, nb, max_seq=max_seq)
            self.cache = self.model.init_paged_cache(nb + 1, block_size)
        else:
            self.slots = SlotManager(max_slots, max_seq)
            self.cache = self.model.init_cache(max_slots, max_seq)
        # direct (no-runtime) path: PinAccel serves on the kernels, no
        # policy or PinHost on the plain math
        self._direct_impl = ("cuda" if isinstance(self.policy, PinAccel)
                             else "ref")
        if runtime is None and self._direct_impl == "cuda":
            kernel_ops.build(self.device)
        self._prefill_name = f"{fn_prefix}_prefill"
        self._decode_name = f"{fn_prefix}_decode"
        self.engine_id = fn_prefix
        self.results: dict[int, RequestOutput] = {}
        # req_id -> (tokens, logprobs) generated before preemption
        self._resume: dict[int, tuple[list[int], list[float]]] = {}
        self._handles: dict[int, RequestHandle] = {}
        self._abort_pending: set[int] = set()
        self._abort_lock = threading.Lock()
        self._clock0: Optional[float] = None
        self._direct_step_ms: dict[str, Optional[float]] = {
            "host": None, "accel": None}
        self._latency_window: collections.deque = collections.deque(
            maxlen=64)
        self.reset_stats()
        if runtime is not None:
            self._prepare_runtime(runtime, eager_accel)

    def reset_stats(self) -> None:
        """Zero the per-serve counters.  ``prefill_tokens`` counts real
        prompt positions computed by prefill (not bucket padding)."""
        self.stats = {"prefills": 0, "decode_steps": 0,
                      "decode_row_util": 0.0, "prefill_tokens": 0}

    def _now(self) -> float:
        """Engine-loop clock (seconds since the current run() started)."""
        if self._clock0 is None:
            return 0.0
        return time.perf_counter() - self._clock0

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _tensors(self, leaves: dict) -> dict:
        return {k: self._tensor(v) for k, v in leaves.items()}

    # ---------------------------------------------------------- telemetry
    def signals(self) -> LoadSignals:
        """Serve-telemetry snapshot: queue depth, in-flight rows, free KV
        capacity, per-target recent decode step ms and TTFT/TPOT p50."""
        if self.paged:
            free = (self.slots.pool.free_blocks()
                    / max(self.slots.pool.num_blocks, 1))
        else:
            cap = self.slots.max_slots
            free = (cap - len(self.slots.active)) / max(cap, 1)
        host_ms = self._direct_step_ms["host"]
        accel_ms = self._direct_step_ms["accel"]
        if self.runtime is not None:
            binary = self.runtime.binaries.get(self._decode_name)
            if binary is not None:
                cs = binary.compile_stats
                host_ms = cs.get(TargetKind.HOST, {}).get(
                    "recent_exec_ms", host_ms)
                accel_ms = cs.get(TargetKind.ACCEL, {}).get(
                    "recent_exec_ms", accel_ms)
        ttft = sorted(t for t, _ in self._latency_window)
        tpot = sorted(t for _, t in self._latency_window)
        return LoadSignals(
            queue_depth=self.queue.arrived_len(self._now()),
            active_slots=len(self.slots.active),
            free_kv_frac=free,
            host_decode_ms=host_ms,
            accel_decode_ms=accel_ms,
            ttft_p50_s=ttft[len(ttft) // 2] if ttft else None,
            tpot_p50_s=tpot[len(tpot) // 2] if tpot else None,
        )

    def _publish_signals(self) -> None:
        if self.runtime is not None:
            self.runtime.publish_signals(self.engine_id, self.signals())

    # ------------------------------------------------- runtime plumbing
    def _prepare_runtime(self, rt: XarTrekRuntime,
                         eager_accel: bool) -> None:
        model = self.model

        def step_fns(impl: str):
            def prefill_fn(params, batch):
                return model.prefill_at_sampled(params, batch, backend=impl)

            def decode_fn(params, cache, batch):
                return model.decode_sampled(params, cache, batch,
                                            backend=impl)
            return prefill_fn, decode_fn

        host_prefill, host_decode = step_fns("ref")
        setup = {}
        if isinstance(self.policy, PinHost):
            # pinned to HOST: ACCEL reuses the HOST functions and loads
            # asynchronously (a blocking build would buy nothing)
            accel_prefill, accel_decode = host_prefill, host_decode
            eager_accel = False
        else:
            accel_prefill, accel_decode = step_fns("cuda")
            device = self.device
            setup = {TargetKind.ACCEL: lambda: kernel_ops.build(device)}
        # one app (= one threshold row) per step function
        for name, host_fn, accel_fn in (
                (self._prefill_name, host_prefill, accel_prefill),
                (self._decode_name, host_decode, accel_decode)):
            if name not in rt.registry:
                rt.registry.register(MigratableFunction(
                    name, name,
                    {TargetKind.HOST: host_fn, TargetKind.ACCEL: accel_fn},
                    setup=dict(setup)))
        greedy = SamplingParams()
        B = self.slots.max_slots
        ex_prefill = (self.params, {
            "tokens": self._tensor(np.zeros((1, self.min_bucket), np.int32)),
            "length": self._tensor(np.ones((1,), np.int32)),
            **self._tensors(sampling_leaves(greedy, 1))})
        dec_batch = {"tokens": self._tensor(np.zeros((B, 1), np.int32)),
                     "index": self._tensor(np.zeros((B,), np.int32)),
                     **self._tensors(sampling_leaves(greedy, B))}
        if self.paged:
            dec_batch["block_table"] = self._tensor(
                np.zeros((B, self.slots.table_width), np.int32))
        rt.prepare(self._prefill_name, *ex_prefill, eager_accel=eager_accel)
        rt.prepare(self._decode_name, self.params, self.cache, dec_batch,
                   state_argnums=(1,), eager_accel=eager_accel)

    # -------------------------------------------------------- admission
    def submit(self, request, max_new_tokens: int = 16,
               arrival_s: float = 0.0, stop_tokens: tuple = (),
               sampling: Optional[SamplingParams] = None,
               on_token=None) -> RequestHandle:
        """Enqueue one request (a ``GenerationRequest``, or a bare prompt
        plus the request fields); returns its streaming handle.
        Validates at submission."""
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(
                np.asarray(request), max_new_tokens=max_new_tokens,
                arrival_s=arrival_s, stop_tokens=stop_tokens,
                sampling=sampling or SamplingParams())
        self.queue.submit(self.slots.validate(request))
        return self._handle_for(request, on_token=on_token)

    def prefill_to_span(self, *args, **kwargs):
        raise NotImplementedError(
            "prefill_to_span (disaggregated prefill) is not ported; see "
            "ROADMAP.md queue 1, item 9")

    def submit_span(self, *args, **kwargs):
        raise NotImplementedError(
            "submit_span (disaggregated prefill) is not ported; see "
            "ROADMAP.md queue 1, item 9")

    def _handle_for(self, req: GenerationRequest,
                    on_token=None) -> RequestHandle:
        h = self._handles.get(req.req_id)
        if h is None:
            h = self._handles[req.req_id] = RequestHandle(
                req, engine=self, on_token=on_token)
        elif on_token is not None:
            h.on_token = on_token
        return h

    def abort(self, req_id: int) -> bool:
        """Cancel a queued or in-flight request; its handle finishes
        ``aborted`` with the tokens generated so far.  Thread-safe: the
        loop thread services the mark (inline when no loop runs)."""
        handle = self._handles.get(req_id)
        if handle is None or handle.finished or req_id in self.results:
            return False
        with self._abort_lock:
            self._abort_pending.add(req_id)
        if self._clock0 is None:
            self._service_aborts(self._now())
        return True

    def _service_aborts(self, now: float) -> None:
        with self._abort_lock:
            pending = set(self._abort_pending)
        for req_id in pending:
            done = False
            for slot in list(self.slots.active.values()):
                if slot.request.req_id == req_id:
                    self._sync_handle(slot, now)
                    self._finalize(self._handle_for(slot.request),
                                   FINISH_ABORTED, now)
                    self.slots.release(slot)   # paged: frees blocks too
                    done = True
                    break
            if not done:
                req = self.queue.remove(req_id)
                if req is not None:
                    self._resume.pop(req_id, None)
                    self._finalize(self._handle_for(req), FINISH_ABORTED,
                                   now)
                    done = True
            if done or req_id in self.results:
                with self._abort_lock:
                    self._abort_pending.discard(req_id)

    def _can_admit(self, req: GenerationRequest) -> bool:
        """Paged pools gate admission on the prefill's blocks plus a
        growth watermark; dense rows only on a free slot."""
        if not self.paged:
            return True
        resume = self._resume.get(req.req_id)
        plen = req.prompt_len + (len(resume[0]) - 1 if resume else 0)
        return self.slots.can_admit(plen, req)

    def _admit(self, req: GenerationRequest, now: float = 0.0) -> None:
        # a preempted request resumes by re-prefilling prompt + generated
        # (minus the pending token); its sampled tokens replay from the
        # stash, so only the KV is rebuilt
        resume = self._resume.pop(req.req_id, None)
        if resume is None:
            feed = req.prompt
        else:
            feed = np.concatenate(
                [req.prompt, np.asarray(resume[0][:-1], np.int32)])
        S = len(feed)
        Sb = prompt_bucket(S, self.min_bucket)
        toks = np.zeros((1, Sb), np.int32)
        toks[0, :S] = feed
        batch = {"tokens": self._tensor(toks),
                 "length": self._tensor(np.full((1,), S, np.int32)),
                 **self._tensors(sampling_leaves(req.sampling, 1))}
        if self.runtime is not None:
            tok0, lp0, pc = self.runtime.call(self._prefill_name,
                                              self.params, batch)
        else:
            tok0, lp0, pc = self.model.prefill_at_sampled(
                self.params, batch, backend=self._direct_impl)
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += S
        if resume is None:
            first, tokens, logprobs = int(tok0[0]), None, None
            first_lp = float(lp0[0])
        else:
            first, (tokens, logprobs) = resume[0][-1], resume
            first_lp = 0.0
        if self.paged:
            blocks = self.slots.pool.alloc(self.slots.blocks_for(S))
            slot = self.slots.admit(req, first, blocks=blocks,
                                    tokens=tokens, logprobs=logprobs,
                                    first_logprob=first_lp, pos=S)
            self._scatter(pc, blocks)
        else:
            slot = self.slots.admit(req, first, tokens=tokens,
                                    logprobs=logprobs,
                                    first_logprob=first_lp, pos=S)
            # positions [S, S_bucket) carry pad KV, overwritten before any
            # read; a bucket overhanging the row is clamped
            n = min(Sb, self.slots.max_seq)
            for k in self.cache:
                self.cache[k][:, slot.index, :n] = pc[k][:, 0, :n]
        self._post_admit(slot, req, now)

    def _scatter(self, part: dict, blocks: list[int]) -> None:
        """Write a prefill's bucketed KV (L, 1, S_bucket, KV, hd) into the
        slot's physical blocks; the last block's tail carries pad KV,
        which decode overwrites before reading."""
        bs = self.block_size
        phys = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        tgt = len(blocks) * bs
        for k in self.cache:
            p = part[k][:, 0]
            if p.shape[1] > tgt:
                p = p[:, :tgt]
            elif p.shape[1] < tgt:
                p = torch.nn.functional.pad(
                    p, (0, 0, 0, 0, 0, tgt - p.shape[1]))
            self.cache[k][:, phys] = p.reshape(
                p.shape[0], len(blocks), bs, *p.shape[2:]).to(
                    self.cache[k].dtype)

    def _post_admit(self, slot: Slot, req: GenerationRequest,
                    now: float) -> None:
        slot.t_admit = now
        handle = self._handle_for(req)
        if handle.t_admit is None:     # first admission only (not resume)
            handle.t_admit = now
        t_tok = self._now()            # after the prefill: TTFT includes it
        slot.t_last_token = t_tok
        self._sync_handle(slot, t_tok)
        if slot.done:
            self._finish(slot, t_tok)

    def _sync_handle(self, slot: Slot, now: float) -> None:
        """Stream not-yet-emitted tokens to the handle (resume replays are
        skipped by the handle's already-pushed count)."""
        handle = self._handles.get(slot.request.req_id)
        if handle is None:
            return
        start = len(handle.tokens)
        for tok, lp in zip(slot.tokens[start:], slot.logprobs[start:]):
            handle._push(int(tok), now, lp)

    def _finalize(self, handle: RequestHandle, reason: str,
                  now: float) -> None:
        out = handle._finish(reason, now)
        self.results[handle.req_id] = out
        self._latency_window.append((out.ttft_s, out.tpot_s))

    def _finish(self, slot: Slot, now: float = 0.0) -> None:
        self._sync_handle(slot, now)
        reason = (FINISH_STOP
                  if slot.tokens and slot.request.stops(slot.tokens[-1])
                  and len(slot.tokens) <= slot.request.max_new_tokens
                  else FINISH_LENGTH)
        self._finalize(self._handle_for(slot.request), reason, now)
        self.slots.release(slot)

    # ----------------------------------------------------------- decode
    def _preempt(self, slot: Slot) -> None:
        """Evict a live slot to relieve pool pressure: stash its tokens,
        free its blocks, requeue the request at the front."""
        self._resume[slot.request.req_id] = (list(slot.tokens),
                                             list(slot.logprobs))
        self.slots.preempt(slot)
        self.queue.requeue(slot.request)

    def _ensure_decode_blocks(self) -> None:
        """Every active slot whose next write crosses into a new block
        gets one, oldest first; when the pool is dry the youngest other
        slot is preempted (validate() bounds a lone slot to the pool)."""
        for slot in sorted(self.slots.active.values(), key=lambda s: s.seq):
            if self.slots.active.get(slot.index) is not slot:
                continue                   # preempted earlier this pass
            if self.slots.needs_block(slot):
                while not self.slots.pool.free_blocks():
                    victims = [s for s in self.slots.active.values()
                               if s is not slot]
                    if not victims:
                        raise RuntimeError(
                            "block pool exhausted by a lone slot")
                    self._preempt(max(victims, key=lambda s: s.seq))
                slot.blocks.extend(self.slots.pool.alloc(1))

    def _decode_step(self) -> None:
        if self.paged:
            self._ensure_decode_blocks()
        active = self.slots.active_slots()
        if not active:                     # everything was preempted
            return
        batch = {"tokens": self._tensor(self.slots.token_vector()),
                 "index": self._tensor(self.slots.index_vector()),
                 **self._tensors(self.slots.sampling_vectors())}
        if self.paged:
            batch["block_table"] = self._tensor(self.slots.block_table())
        if self.runtime is not None:
            toks, logps, self.cache = self.runtime.call(
                self._decode_name, self.params, self.cache, batch)
            toks = toks.cpu().numpy()
        else:
            t0 = time.perf_counter()
            toks, logps, self.cache = self.model.decode_sampled(
                self.params, self.cache, batch, backend=self._direct_impl)
            toks = toks.cpu().numpy()      # waits for the step
            ms = (time.perf_counter() - t0) * 1e3
            tgt = "accel" if self._direct_impl == "cuda" else "host"
            self._direct_step_ms[tgt] = ewma(self._direct_step_ms[tgt], ms)
        self.stats["decode_steps"] += 1
        self.stats["decode_row_util"] += len(active) / self.slots.max_slots
        logps = logps.cpu().numpy()
        now = self._now()
        for slot in active:
            t = int(toks[slot.index])
            slot.tokens.append(t)
            slot.logprobs.append(float(logps[slot.index]))
            slot.last_token = t
            slot.pos += 1
            slot.t_last_token = now
            self._sync_handle(slot, now)
            if slot.done:
                self._finish(slot, now)

    # ------------------------------------------------------- serve loop
    def run(self, requests: Iterable[GenerationRequest] = (),
            poll_s: float = 0.002) -> dict[int, RequestOutput]:
        """Drain ``requests`` plus anything already submitted; returns
        {req_id: RequestOutput} for the requests completed by this call.
        Arrival times are relative to this call's start.  If the loop
        raises, every unfinished handle finishes ``aborted`` before the
        error propagates, so streaming consumers never hang."""
        try:
            for r in requests:
                self.queue.submit(self.slots.validate(r))
                self._handle_for(r)
            self._clock0 = time.perf_counter()
            while len(self.queue) or self.slots.active:
                now = self._now()
                self._service_aborts(now)
                self._publish_signals()
                while self.slots.has_free():
                    req = self.queue.pop_arrived(now)
                    if req is None:
                        break
                    if not self._can_admit(req):
                        self.queue.requeue(req)
                        break
                    self._admit(req, now)
                if self.slots.active:
                    self._decode_step()
                else:
                    nxt = self.queue.next_arrival()
                    if nxt is None:
                        break
                    time.sleep(min(max(nxt - now, 0.0), 0.05) + poll_s)
        except BaseException:
            for h in list(self._handles.values()):
                if not h.finished:
                    self._finalize(h, FINISH_ABORTED, self._now())
            raise
        finally:
            self._clock0 = None
            self._publish_signals()
        out, self.results = self.results, {}
        for rid in out:
            self._handles.pop(rid, None)
        return out

    def generate(self, prompts, max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None) -> np.ndarray:
        """All prompts arrive at t=0; returns (B, max_new_tokens) tokens
        in order (stop-token requests can be ragged — use run())."""
        reqs = [GenerationRequest(np.asarray(p), max_new_tokens,
                                  sampling=sampling or SamplingParams())
                for p in np.asarray(prompts)]
        out = self.run(reqs)
        return np.stack([out[r.req_id].tokens for r in reqs])
