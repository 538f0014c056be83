"""Serve API v2: the application-facing request/response types.

Copy of ``repro/serve/api.py`` (numpy only).

Xar-Trek serves socket-connected applications whose functions migrate
between targets at run time; the application-facing contract must stay
stable while the backend moves.  These types ARE that contract for the
serving front-end:

* ``SamplingParams`` — the per-request decoding spec (temperature /
  top-k / top-p / seed).  ``temperature == 0.0`` (the default) is
  greedy argmax, byte-identical to the pre-v2 engines.  Sampling runs
  *inside* the decode step (see ``models/sampling.py``) with a
  per-row PRNG key built as ``fold_in(PRNGKey(seed), position)``, so a
  seeded request reproduces the same tokens on the HOST (plain PyTorch)
  and ACCEL (CUDA kernel) builds, under mid-stream migration, and across
  preempt/resume.

* ``GenerationRequest`` — one generation job: prompt + SamplingParams +
  stop/budget + arrival time.  Supersedes the v1 ``Request``
  (``serve.scheduler.Request`` remains as a thin deprecated shim).

* ``RequestOutput`` — the finished result: tokens, a finish reason
  (``stop`` | ``length`` | ``aborted``) and per-request latency
  metrics (queue wait, TTFT, TPOT).

* ``RequestHandle`` — returned by ``ContinuousBatchingEngine.submit``:
  a streaming surface over one in-flight request.  Tokens can be
  consumed as they are emitted (blocking iterator, or an ``on_token``
  callback fired from the engine loop), ``result()`` blocks for the
  final ``RequestOutput``, and ``abort()`` cancels the request
  mid-stream (its slot and KV blocks free immediately).
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as queue_lib
import threading
import time
from typing import Callable, Optional

import numpy as np

FINISH_STOP = "stop"          # a stop token was emitted
FINISH_LENGTH = "length"      # max_new_tokens budget exhausted
FINISH_ABORTED = "aborted"    # caller cancelled mid-stream
FINISH_REASONS = (FINISH_STOP, FINISH_LENGTH, FINISH_ABORTED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding spec.

    ``temperature == 0.0`` (default) is exact greedy argmax — the
    sampled path is bypassed entirely, so greedy outputs are
    byte-identical to the pre-sampling engines.  ``top_k <= 0`` and
    ``top_p >= 1.0`` disable the respective filters.  ``seed`` fully
    determines the draw for a given token position: the in-graph key is
    ``fold_in(PRNGKey(seed), absolute_position)``, independent of slot
    index, batch composition, backend, and preemption history.

    ``logprobs=True`` surfaces each emitted token's logprob in
    ``RequestOutput.logprobs`` (and streams it via the handle's
    ``logprobs`` list).  The logprob is the chosen token's log-mass
    under the RAW model distribution (before temperature/top-k/top-p),
    so it is well-defined for greedy requests too and identical on
    every backend.  The step always computes it — opting in
    changes what is *returned to the caller*, never the compile
    signature.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0: {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1]: {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off): {self.top_k}")
        if not isinstance(self.seed, (int, np.integer)):
            raise ValueError(f"seed must be an int: {self.seed!r}")
        if not isinstance(self.logprobs, bool):
            raise ValueError(f"logprobs must be a bool: {self.logprobs!r}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


@dataclasses.dataclass
class GenerationRequest:
    """One generation job.  ``prompt``: (S,) int32 token ids.

    ``stop_tokens``: generation ends the step any of these ids is
    emitted (the stop token is included in the output), freeing the
    request's slot — and, under paging, its KV blocks — immediately
    instead of running out the full ``max_new_tokens`` budget.

    ``sampling`` is the per-request decoding spec; the default is
    greedy (temperature 0.0).
    """

    prompt: np.ndarray
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    stop_tokens: tuple = ()
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    req_id: int = dataclasses.field(
        default_factory=itertools.count().__next__)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.stop_tokens = tuple(int(t) for t in (self.stop_tokens or ()))
        if self.sampling is None:
            self.sampling = SamplingParams()

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def stops(self, token: int) -> bool:
        return token in self.stop_tokens


@dataclasses.dataclass
class RequestOutput:
    """Finished (or aborted) request: tokens + finish reason + metrics.

    ``queue_wait_s``: submission/arrival to first admission (slot + KV
    capacity granted).  ``ttft_s``: arrival to first emitted token
    (includes the queue wait and the prefill).  ``tpot_s``: mean
    inter-token time over the decode steps (0 for single-token
    outputs).  Aborted requests carry whatever tokens were generated
    before the abort.

    ``logprobs``: (n_generated,) f32 chosen-token logprobs, aligned
    with ``tokens``, when the request set ``SamplingParams.logprobs``;
    ``None`` otherwise.
    """

    req_id: int
    tokens: np.ndarray                  # (n_generated,) int32
    finish_reason: str                  # stop | length | aborted
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    logprobs: Optional[np.ndarray] = None

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)
        if self.logprobs is not None:
            self.logprobs = np.asarray(self.logprobs,
                                       np.float32).reshape(-1)
            if self.logprobs.shape != self.tokens.shape:
                raise ValueError(
                    f"logprobs/tokens length mismatch: "
                    f"{self.logprobs.shape} vs {self.tokens.shape}")
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(f"finish_reason must be one of {FINISH_REASONS}:"
                             f" {self.finish_reason!r}")

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


_SENTINEL = object()


class RequestHandle:
    """Streaming view of one submitted request.

    The engine pushes tokens into the handle the step they are sampled;
    consumers either iterate (``for tok in handle`` — blocks until the
    next token or end-of-stream; run the engine loop in another thread)
    or attach an ``on_token`` callback (fired synchronously from the
    engine loop).  ``result()`` blocks until the final
    ``RequestOutput``; ``abort()`` cancels the request mid-stream.

    Tokens survive preemption: a preempted-and-resumed request replays
    its stashed tokens into the slot, and the handle's already-pushed
    count ensures nothing is re-emitted.

    A handle can also be REMOTE: the engine serving the request lives in
    another OS process and streams line-JSON events over the process
    cluster's result plane.  ``apply_event`` rehydrates the handle from
    those events — per-token events carry an absolute index so replays
    (a dead worker's requests resumed on a survivor re-emit their
    stashed prefix) dedup instead of double-pushing, and the finish
    event closes the stream.  ``_engine`` then only needs an
    ``abort(req_id)`` method, which the front-end proxies to the
    owning worker.
    """

    def __init__(self, request: GenerationRequest, engine=None,
                 on_token: Optional[Callable[[int], None]] = None):
        self.request = request
        self.req_id = request.req_id
        self.on_token = on_token
        self.tokens: list[int] = []          # emitted so far
        self.logprobs: list[float] = []      # aligned with tokens
        self._engine = engine
        self._stream: queue_lib.Queue = queue_lib.Queue()
        self._done = threading.Event()
        self._output: Optional[RequestOutput] = None
        # latency bookkeeping (engine-loop clock, seconds)
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        # wall-clock submit time (monotonic): remote handles compute
        # TTFT/TPOT parent-side from event receipt times against this,
        # so the reported numbers include IPC, routing and any
        # failure-re-route delay — the honest end-to-end latency
        self.t_created: float = time.monotonic()

    # ------------------------------------------------------ engine side
    def _push(self, token: int, now: float,
              logprob: float = 0.0) -> None:
        if self.t_first_token is None:
            self.t_first_token = now
        self.t_last_token = now
        self.tokens.append(token)
        self.logprobs.append(float(logprob))
        self._stream.put(token)
        if self.on_token is not None:
            self.on_token(token)

    def _finish(self, finish_reason: str, now: float) -> RequestOutput:
        n = len(self.tokens)
        t_first = self.t_first_token
        t_last = self.t_last_token if self.t_last_token is not None else now
        arrival = self.request.arrival_s
        self._output = RequestOutput(
            req_id=self.req_id,
            tokens=np.asarray(self.tokens, np.int32),
            logprobs=(np.asarray(self.logprobs, np.float32)
                      if self.request.sampling.logprobs else None),
            finish_reason=finish_reason,
            queue_wait_s=max((self.t_admit if self.t_admit is not None
                              else now) - arrival, 0.0),
            ttft_s=max((t_first if t_first is not None else now) - arrival,
                       0.0),
            tpot_s=((t_last - t_first) / (n - 1)
                    if n > 1 and t_first is not None else 0.0),
        )
        self._done.set()
        self._stream.put(_SENTINEL)
        return self._output

    # ------------------------------------------------- remote (IPC) side
    def apply_event(self, ev: dict) -> None:
        """Rehydrate from one result-plane event (process cluster).

        ``token`` events: ``{"ev": "token", "i": abs_index, "t": token,
        "lp": logprob}`` — an index below the already-pushed count is a
        replay (resume-by-re-prefill after a worker failure re-emits
        the stashed prefix) and is dropped, which is exactly what makes
        re-routed streams byte-identical instead of duplicated.

        ``finish`` events carry the authoritative token/logprob lists
        (any tokens that beat the per-token events to the wire are
        pushed first), the finish reason and the WORKER-side queue
        wait; TTFT/TPOT are computed here from parent-side receipt
        times against ``t_created``."""
        if self._done.is_set():
            return                       # late event after abort/finish
        kind = ev.get("ev")
        now = time.monotonic()
        if kind == "token":
            if int(ev["i"]) < len(self.tokens):
                return                   # replayed prefix: already seen
            self._push(int(ev["t"]), now, float(ev.get("lp", 0.0)))
        elif kind == "finish":
            toks = [int(t) for t in ev.get("tokens", ())]
            lps = [float(x) for x in ev.get("logprobs", ())]
            if len(lps) != len(toks):
                lps = [0.0] * len(toks)
            for i in range(len(self.tokens), len(toks)):
                self._push(toks[i], now, lps[i])
            n = len(self.tokens)
            t_first = self.t_first_token
            t_last = (self.t_last_token
                      if self.t_last_token is not None else now)
            self._output = RequestOutput(
                req_id=self.req_id,
                tokens=np.asarray(self.tokens, np.int32),
                logprobs=(np.asarray(self.logprobs, np.float32)
                          if self.request.sampling.logprobs else None),
                finish_reason=ev["finish_reason"],
                queue_wait_s=float(ev.get("queue_wait_s", 0.0)),
                ttft_s=max((t_first if t_first is not None else now)
                           - self.t_created, 0.0),
                tpot_s=((t_last - t_first) / (n - 1)
                        if n > 1 and t_first is not None else 0.0),
            )
            self._done.set()
            self._stream.put(_SENTINEL)
        else:
            raise ValueError(f"unknown result-plane event {kind!r}")

    # ------------------------------------------------------ caller side
    @property
    def finished(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestOutput:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.req_id} not finished "
                               f"within {timeout}s")
        return self._output

    def abort(self) -> bool:
        if self._engine is None:
            return False
        return self._engine.abort(self.req_id)

    def __iter__(self):
        while True:
            tok = self._stream.get()
            if tok is _SENTINEL:
                # re-arm so a second iteration over a finished handle
                # terminates instead of blocking forever
                self._stream.put(_SENTINEL)
                return
            yield tok
