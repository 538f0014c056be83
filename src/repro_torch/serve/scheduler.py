"""Request admission for continuous-batching serving.

A ``GenerationRequest`` (see ``serve.api``) is one generation job
(prompt + sampling spec + token budget) with an arrival time; the
``RequestQueue`` is the multi-tenant arrival stream of the paper's
Figure-6 throughput experiment — requests become visible to the engine
only once the serving clock passes their ``arrival_s``, and are
admitted FIFO among the arrived.

The queue is thread-safe so a driver thread can keep submitting while
the engine loop drains (the single-process analogue of the paper's
socket-connected applications).

Copy of ``repro/serve/scheduler.py`` without the removed v1 ``Request``.
"""
from __future__ import annotations

import heapq
import itertools
import random
import threading
from typing import Iterable, Optional

from repro_torch.serve.api import GenerationRequest


class RequestQueue:
    """Arrival-time-ordered FIFO of pending requests."""

    def __init__(self, requests: Iterable[GenerationRequest] = ()):
        self._lock = threading.Lock()
        self._heap: list[tuple[float, int, GenerationRequest]] = []
        self._seq = itertools.count()     # FIFO tie-break among same-time
        self._front = itertools.count(start=-1, step=-1)
        for r in requests:
            self.submit(r)

    def submit(self, request: GenerationRequest) -> int:
        with self._lock:
            heapq.heappush(self._heap,
                           (request.arrival_s, next(self._seq), request))
        return request.req_id

    def requeue(self, request: GenerationRequest) -> int:
        """Put a popped request back at the FRONT of its arrival cohort
        (engine backpressure: admission was attempted but capacity — e.g.
        the KV block pool — was not available, or the request was
        preempted and must resume before newer work)."""
        with self._lock:
            heapq.heappush(self._heap,
                           (request.arrival_s, next(self._front), request))
        return request.req_id

    def pop_arrived(self, now: float) -> Optional[GenerationRequest]:
        """Earliest-arrived request with arrival_s <= now, else None."""
        with self._lock:
            if self._heap and self._heap[0][0] <= now:
                return heapq.heappop(self._heap)[2]
            return None

    def remove(self, req_id: int) -> Optional[GenerationRequest]:
        """Pull a pending request out of the queue (abort before
        admission).  Returns it, or None if not queued."""
        with self._lock:
            for i, (_, _, r) in enumerate(self._heap):
                if r.req_id == req_id:
                    entry = self._heap.pop(i)
                    heapq.heapify(self._heap)
                    return entry[2]
            return None

    def next_arrival(self) -> Optional[float]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def arrived_len(self, now: float) -> int:
        """Requests with ``arrival_s <= now`` — the queue depth that is
        actually LOAD.  ``len(queue)`` is the whole arrival heap, which
        for a pre-scheduled stream (e.g. Poisson benchmark arrivals)
        counts requests that do not exist yet; publishing that as
        ``LoadSignals.queue_depth`` inflated ``x86_load`` and tripped
        queue-depth policy thresholds before any real pressure."""
        with self._lock:
            return sum(1 for a, _, _ in self._heap if a <= now)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


def poisson_arrivals(n: int, rate_per_s: float,
                     rng: random.Random | int = 0) -> list[float]:
    """n arrival times of a Poisson process with the given rate (exp(rate)
    inter-arrival gaps) — the Figure-6 style multi-tenant stream."""
    if not isinstance(rng, random.Random):
        rng = random.Random(rng)
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_per_s)
        out.append(t)
    return out
