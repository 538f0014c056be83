"""Per-request KV-cache slot management for continuous batching.

Two cache layouts share one slot abstraction:

* ``SlotManager`` (dense): the engine owns one batched KV cache of
  fixed width ``max_slots`` (the decode batch) and length ``max_seq``.
  Each in-flight request occupies one row ("slot"): admission writes
  its prefilled KV into the row, decode steps advance the row's
  position independently of its neighbours, and completion frees the
  row for the next arrival.  A request reserves the FULL row for its
  lifetime, so capacity = max_slots regardless of actual lengths.

* ``PagedSlotManager`` (paged, vLLM-style): the cache is a pool of
  fixed-size blocks of ``block_size`` positions; each slot holds a
  *block table* mapping its logical positions [j*bs, (j+1)*bs) to a
  physical block.  Admission only needs the prompt's blocks, decode
  allocates one block at a time on demand, so capacity is bounded by
  the POOL (total positions in flight), not by rows x max_seq — short
  requests no longer reserve space they never use.

Stale KV beyond a slot's current position is never cleared: decode is
write-then-attend (the new token's KV lands at ``pos`` before any later
step reads it) and attention masks positions beyond ``pos``, so a fresh
request only ever reads positions its own prefill/decode wrote.  Under
paging, physical block 0 is reserved as the junk block: inactive decode
rows carry an all-zero block table and position 0, so their masked
writes land in block 0 and can never corrupt a live request's blocks.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json

import numpy as np

from repro_torch.serve.api import GenerationRequest


def _np_dtype(name: str) -> np.dtype:
    """Resolve a dtype by name, covering the ml_dtypes extended floats
    (bfloat16 etc.) that ``np.dtype`` alone does not know."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


@dataclasses.dataclass
class KVSpan:
    """A finished prefill's KV, lifted out of one engine's block pool.

    This is the disaggregation handoff unit: a prefill-role engine
    fills scratch blocks, gathers them into per-leaf ``(L, nblk,
    block_size, ...)`` arrays IN POOL DTYPE (int8 pools ship quantised
    codes + scale planes untouched, so the handoff adds zero rounding),
    and a decode-role engine scatters them into its own pool and starts
    decoding from ``first_token``.  ``to_bytes``/``from_bytes`` give a
    self-describing wire format (one JSON header line — scalars +
    per-leaf name/shape/dtype — then the raw leaf bytes) for the TCP
    control plane.
    """

    prompt: np.ndarray                 # (S,) int32
    first_token: int
    first_logprob: float
    block_size: int
    kv: dict[str, np.ndarray]          # leaf -> (L, nblk, block_size, ...)

    def to_bytes(self) -> bytes:
        prompt = np.ascontiguousarray(self.prompt, np.int32)
        names = sorted(self.kv)
        header = {
            "first_token": int(self.first_token),
            "first_logprob": float(self.first_logprob),
            "block_size": int(self.block_size),
            "prompt_len": int(prompt.shape[0]),
            "leaves": [[k, list(self.kv[k].shape), self.kv[k].dtype.name]
                       for k in names],
        }
        parts = [json.dumps(header).encode() + b"\n", prompt.tobytes()]
        parts += [np.ascontiguousarray(self.kv[k]).tobytes() for k in names]
        return b"".join(parts)

    @staticmethod
    def from_bytes(data: bytes) -> "KVSpan":
        nl = data.index(b"\n")
        header = json.loads(data[:nl].decode())
        off = nl + 1
        S = header["prompt_len"]
        prompt = np.frombuffer(data, np.int32, count=S, offset=off).copy()
        off += prompt.nbytes
        kv = {}
        for name, shape, dtype_name in header["leaves"]:
            dt = _np_dtype(dtype_name)
            n = int(np.prod(shape))
            kv[name] = np.frombuffer(
                data, dt, count=n, offset=off).reshape(shape).copy()
            off += n * dt.itemsize
        return KVSpan(prompt=prompt, first_token=header["first_token"],
                      first_logprob=header["first_logprob"],
                      block_size=header["block_size"], kv=kv)


def chain_hashes(tokens, block_size: int) -> list[int]:
    """Content hash chain over the FULL blocks of a token sequence.

    ``out[j] = hash((out[j-1], tuple(tokens[j*bs:(j+1)*bs])))`` — block j's
    key commits to every token before it, so two sequences share block j's
    hash iff they agree on the whole prefix ``[0, (j+1)*bs)``.  Only full
    blocks are keyed: a partial tail block is private by construction
    (its content is still growing).  This is the prefix-cache index key
    (vLLM-style hash-chain block keying)."""
    out: list[int] = []
    h = None
    for j in range(len(tokens) // block_size):
        blk = tuple(int(t) for t in tokens[j * block_size:(j + 1) * block_size])
        h = hash((h, blk))
        out.append(h)
    return out


@dataclasses.dataclass
class PartialPrefill:
    """Chunked-prefill progress of a slot that is not decode-ready yet.

    ``feed`` is the FULL admission feed (prompt, plus replayed generated
    tokens when a decode-preempted request resumes by re-prefill); the
    slot's ``pos`` tracks how many of its positions have KV in the pool.
    ``resume`` carries the stashed (tokens, logprobs) of that earlier
    decode preemption, if any — it must survive a SECOND preemption that
    lands mid-prefill, so the engine re-stashes it from here rather
    than from the slot's (still empty) token list.
    """

    feed: np.ndarray
    resume: tuple[list[int], list[float]] | None = None


@dataclasses.dataclass
class Slot:
    """One occupied row of the batched decode.

    Besides the KV-addressing state, a slot carries the request's RNG
    state implicitly (the sampling seed rides in ``request.sampling``;
    the per-token key is a pure function of (seed, position), so
    nothing mutable needs checkpointing across preemption) and the
    metrics timestamps of its CURRENT occupancy (engine-loop clock;
    the streaming handle keeps the across-preemption aggregate).

    A slot admitted under chunked prefill starts with ``prefill`` set
    (and ``tokens`` empty): it holds its blocks and is visible to
    preemption, but every per-step decode vector presents it as an
    inactive row until the final chunk samples its first token and
    clears ``prefill``.
    """

    index: int                 # row in the batched cache / decode batch
    request: GenerationRequest
    pos: int                   # next cache write position (= tokens cached)
    last_token: int            # token to feed at the next decode step
    tokens: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    blocks: list[int] = dataclasses.field(default_factory=list)  # paged only
    # hash-chain keys of this slot's FULL blocks that are registered in
    # the pool's prefix index (paged + prefix_cache only); always a
    # prefix of ``blocks`` — the partial tail block is never keyed
    block_hashes: list[int] = dataclasses.field(default_factory=list)
    seq: int = 0               # admission order (preemption picks youngest)
    t_admit: float = 0.0       # when this occupancy was admitted
    t_last_token: float = 0.0  # when its latest token was sampled
    prefill: PartialPrefill | None = None   # chunked prefill in progress

    @property
    def prefilling(self) -> bool:
        return self.prefill is not None

    @property
    def done(self) -> bool:
        if self.prefilling:
            return False
        if len(self.tokens) >= self.request.max_new_tokens:
            return True
        return bool(self.tokens) and self.request.stops(self.tokens[-1])


class SlotManager:
    """Free-list of cache rows + the per-step index/token vectors."""

    def __init__(self, max_slots: int, max_seq: int):
        self.max_slots = max_slots
        self.max_seq = max_seq
        self._free: list[int] = list(range(max_slots))[::-1]  # pop() -> 0 first
        self.active: dict[int, Slot] = {}
        self._stats = {"admitted": 0, "released": 0, "peak_active": 0}
        self.slot_uses = [0] * max_slots
        self._seq = itertools.count()

    @property
    def stats(self) -> dict:
        """Counters plus live fragmentation accounting: ``reserved_positions``
        is what the active requests HOLD (dense: a full row each),
        ``used_positions`` what they have actually written — the gap is
        the waste paging exists to reclaim."""
        out = dict(self._stats)
        out.update(self.fragmentation())
        return out

    def fragmentation(self) -> dict:
        reserved = len(self.active) * self.max_seq
        used = sum(s.pos for s in self.active.values())
        return {"reserved_positions": reserved, "used_positions": used,
                "frag_positions": reserved - used}

    def has_free(self) -> bool:
        return bool(self._free)

    def validate(self, request: GenerationRequest) -> GenerationRequest:
        """Reject a request that cannot fit one cache row (the engine
        calls this at submission so callers fail fast, before a prefill
        or a slot is spent on it)."""
        if request.prompt_len + request.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {request.req_id} needs "
                f"{request.prompt_len + request.max_new_tokens} positions, "
                f"cache rows hold {self.max_seq}")
        return request

    def admit(self, request: GenerationRequest, first_token: int, *,
              blocks: list[int] | None = None,
              tokens: list[int] | None = None,
              logprobs: list[float] | None = None,
              first_logprob: float = 0.0,
              pos: int | None = None) -> Slot:
        """Claim a row for ``request`` whose prefill emitted ``first_token``
        (with chosen-token logprob ``first_logprob``).  ``tokens`` /
        ``logprobs`` / ``pos`` override the fresh-admission defaults when
        a preempted request resumes with generation already under way."""
        if not self._free:
            raise RuntimeError("no free slot")
        self.validate(request)
        idx = self._free.pop()
        slot = Slot(index=idx, request=request,
                    pos=request.prompt_len if pos is None else pos,
                    last_token=first_token,
                    tokens=[first_token] if tokens is None else list(tokens),
                    logprobs=([first_logprob] if logprobs is None
                              else list(logprobs)),
                    blocks=blocks or [], seq=next(self._seq))
        self.active[idx] = slot
        self.slot_uses[idx] += 1
        self._stats["admitted"] += 1
        self._stats["peak_active"] = max(self._stats["peak_active"],
                                         len(self.active))
        return slot

    def release(self, slot: Slot) -> None:
        del self.active[slot.index]
        self._free.append(slot.index)
        self._stats["released"] += 1

    # ------------------------------------------------- per-step vectors
    # Slots still mid-chunked-prefill present as INACTIVE rows in every
    # decode-step vector (token/index 0, greedy sampling, zero table):
    # their junk decode write lands in the junk block, and their real
    # state advances only through the chunk-prefill path.

    def token_vector(self) -> np.ndarray:
        """(max_slots, 1) int32: each active slot's pending token."""
        toks = np.zeros((self.max_slots, 1), np.int32)
        for idx, slot in self.active.items():
            if slot.prefilling:
                continue
            toks[idx, 0] = slot.last_token
        return toks

    def index_vector(self) -> np.ndarray:
        """(max_slots,) int32 per-row cache positions.  Inactive rows pin
        to 0: their junk write lands below any future request's prefill
        (dense) or in the reserved junk block 0 (paged), which nothing
        ever reads (see module docstring)."""
        idx = np.zeros((self.max_slots,), np.int32)
        for i, slot in self.active.items():
            if slot.prefilling:
                continue
            idx[i] = slot.pos
        return idx

    def sampling_vectors(self) -> dict[str, np.ndarray]:
        """(max_slots,)-vector sampling leaves for the in-graph sampler
        (models/sampling.sample_tokens): each active row carries its
        request's spec; inactive rows pin to greedy/neutral values (their
        sampled junk token is never read).  Always the same shapes and
        dtypes, so the decode step's compile signature is static across
        any request mix."""
        temp = np.zeros((self.max_slots,), np.float32)
        top_k = np.zeros((self.max_slots,), np.int32)
        top_p = np.ones((self.max_slots,), np.float32)
        seed = np.zeros((self.max_slots,), np.int32)
        for i, slot in self.active.items():
            if slot.prefilling:
                continue
            sp = slot.request.sampling
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            seed[i] = sp.seed
        return {"temperature": temp, "top_k": top_k, "top_p": top_p,
                "seed": seed}

    def active_slots(self) -> list[Slot]:
        """Decode-ready slots (rows mid-chunked-prefill are excluded —
        the decode step must not append tokens to them)."""
        return [self.active[i] for i in sorted(self.active)
                if not self.active[i].prefilling]

    def prefilling_slots(self) -> list[Slot]:
        """Slots with a chunked prefill in flight, admission order."""
        return [self.active[i] for i in sorted(self.active)
                if self.active[i].prefilling]


# ------------------------------------------------------------ paged layout

class BlockPool:
    """Reference-counted free-list of fixed-size KV blocks.

    Manages physical block ids ``1..num_blocks``; id 0 is the reserved
    junk block (inactive decode rows write there — never allocated, never
    read).  The backing cache array therefore has ``num_blocks + 1``
    physical blocks; ``num_blocks * block_size`` is the usable capacity.

    Every allocated block carries a refcount: ``alloc`` hands out blocks
    at refcount 1, ``ref`` adds a holder (prefix sharing), and ``free``
    drops one reference per listed block.  A block whose refcount hits 0
    returns to the free list UNLESS it is registered in the content-hash
    index — then it parks in the CACHED set: its KV stays resident and a
    later ``match`` on its hash revives it for free, but it is evictable
    (LRU, least-recently-cached first) whenever ``alloc`` outruns the
    free list.  ``free_blocks()`` therefore counts free + cached: cached
    blocks are allocatable capacity, just lazily reclaimed.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("need at least one block of one position")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(1, num_blocks + 1))[::-1]
        self.refcount: dict[int, int] = {}
        self._hash_of: dict[int, int] = {}   # block id -> chain hash
        self._by_hash: dict[int, int] = {}   # chain hash -> block id
        self._cached: collections.OrderedDict[int, None] = \
            collections.OrderedDict()        # refcount-0 registered, LRU order
        self.stats = {"allocated": 0, "freed": 0, "peak_in_use": 0,
                      "cache_hits": 0, "evicted": 0}

    def free_blocks(self) -> int:
        """Allocatable blocks: the free list plus refcount-0 cached
        blocks (their KV is kept opportunistically; eviction is free)."""
        return len(self._free) + len(self._cached)

    def blocks_in_use(self) -> int:
        """Referenced (refcount >= 1) blocks — PHYSICAL, i.e. a block
        shared by N slots counts once."""
        return self.num_blocks - self.free_blocks()

    def cached_blocks(self) -> int:
        return len(self._cached)

    def is_cached(self, block: int) -> bool:
        """True for a refcount-0 block parked in the cached set (a match
        would revive it — consuming allocatable capacity — rather than
        share a live block for free)."""
        return block in self._cached

    def alloc(self, n: int = 1) -> list[int]:
        if n > self.free_blocks():
            raise RuntimeError(
                f"block pool exhausted: need {n}, have {self.free_blocks()}")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # evict the least-recently-cached block: drop its hash
                # (its KV is about to be overwritten by the new owner)
                b, _ = self._cached.popitem(last=False)
                self._unregister(b)
                self.stats["evicted"] += 1
            self.refcount[b] = 1
            out.append(b)
        self.stats["allocated"] += n
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.blocks_in_use())
        return out

    def free(self, blocks: list[int]) -> None:
        """Drop ONE reference per listed block.  A block reaching
        refcount 0 returns to the free list, or to the cached set when
        its content hash is registered (prefix cache keeps the KV warm).
        Raises ValueError on the reserved junk block 0, out-of-range
        ids, and double-frees — silent acceptance of those used to
        corrupt the free list (the same id handed to two slots)."""
        freed = 0
        for b in blocks:
            b = int(b)
            if b == 0:
                raise ValueError("cannot free the reserved junk block 0")
            if not 1 <= b <= self.num_blocks:
                raise ValueError(
                    f"block id {b} out of range 1..{self.num_blocks}")
            if self.refcount.get(b, 0) < 1:
                raise ValueError(f"double free of block {b} "
                                 "(refcount already 0)")
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                del self.refcount[b]
                freed += 1
                if b in self._hash_of:
                    self._cached[b] = None     # newest at the MRU end
                else:
                    self._free.append(b)
        self.stats["freed"] += freed

    def ref(self, block: int) -> None:
        """Add a holder to an allocated block (prefix sharing)."""
        if self.refcount.get(block, 0) < 1:
            raise ValueError(f"block {block} is not allocated")
        self.refcount[block] += 1

    # --------------------------------------------------- prefix hash index
    def lookup(self, h: int) -> int | None:
        """Block registered under hash ``h`` (live or cached), or None."""
        return self._by_hash.get(h)

    def match(self, h: int) -> int | None:
        """Claim a reference on the block registered under ``h``: a live
        shared block gains a holder, a cached one is revived (counted as
        an allocation — it leaves allocatable capacity).  None on miss."""
        b = self._by_hash.get(h)
        if b is None:
            return None
        if b in self._cached:
            del self._cached[b]
            self.refcount[b] = 1
            self.stats["allocated"] += 1
            self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                            self.blocks_in_use())
        else:
            self.refcount[b] += 1
        self.stats["cache_hits"] += 1
        return b

    def is_registered(self, block: int) -> bool:
        return block in self._hash_of

    def register(self, block: int, h: int) -> bool:
        """Key ``block`` under chain hash ``h``.  First writer wins: if
        ``h`` is already taken (two requests with the same prefix filled
        private blocks concurrently) or the block already has a hash,
        this is a no-op returning False — the duplicate block stays
        unregistered and is reclaimed normally when freed."""
        if h in self._by_hash or block in self._hash_of:
            return False
        self._hash_of[block] = h
        self._by_hash[h] = block
        return True

    def unregister(self, block: int) -> None:
        """Drop a block's hash-index entry (sole-owner in-place rewrite:
        the content is about to change, so the key would be stale).  An
        unregistered cached block is unreachable, so it goes straight
        back to the free list."""
        self._unregister(block)
        if block in self._cached:
            del self._cached[block]
            self._free.append(block)

    def _unregister(self, block: int) -> None:
        h = self._hash_of.pop(block, None)
        if h is not None:
            self._by_hash.pop(h, None)


class PagedSlotManager(SlotManager):
    """SlotManager over a BlockPool instead of full cache rows.

    ``max_seq`` bounds the block-TABLE width (the attention span a slot
    can reach, ``table_width * block_size`` positions); pass ``None`` to
    let a single request grow to the whole pool.  Admission and growth
    are pool-level: a request is admitted when its PROMPT blocks (plus a
    one-block growth watermark so in-flight slots can still grow) are
    free, and decode allocates one block at a time on demand — the
    engine preempts the youngest slot if the pool runs dry mid-decode.

    With ``prefix_cache=True``, admission first matches the prompt's
    full-block prefix against the pool's hash-chain index
    (``chain_hashes``): matched blocks are SHARED (refcounted) across
    slots, only the uncached tail is allocated, and the engine skips
    re-prefill of the matched span.  Shared blocks are immutable to
    their sharers — any write is gated by ``ensure_writable`` which
    forks the block copy-on-write first.
    """

    def __init__(self, max_slots: int, block_size: int, num_blocks: int,
                 max_seq: int | None = None, prefix_cache: bool = False):
        self.pool = BlockPool(num_blocks, block_size)
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        if max_seq is None:
            self.table_width = num_blocks
        else:
            self.table_width = -(-max_seq // block_size)
        super().__init__(max_slots, self.table_width * block_size)
        self._stats["preempted"] = 0
        self._stats["cow_forks"] = 0
        self._stats["prefix_block_hits"] = 0

    def blocks_for(self, n_positions: int) -> int:
        return -(-n_positions // self.block_size)

    def fragmentation(self) -> dict:
        """Internal fragmentation only: held blocks vs. written positions.
        (There is no external fragmentation — any free block serves any
        slot, tables need not be physically contiguous.)

        Blocks are counted PHYSICALLY (deduped): a block shared by N
        slots contributes block_size positions once to
        ``reserved_positions``, and its extra N-1 logical appearances
        are reported as ``shared_positions`` — the naive per-slot sum
        used to double-count them once prefix sharing landed.  Slot
        positions (``used_positions``) stay logical, so
        ``frag_positions = reserved + shared - used`` remains the true
        held-but-unwritten gap and degenerates to the old
        ``reserved - used`` when nothing is shared."""
        physical = self.pool.blocks_in_use()
        logical = sum(len(s.blocks) for s in self.active.values())
        reserved = physical * self.block_size
        shared = (logical - physical) * self.block_size
        used = sum(s.pos for s in self.active.values())
        return {"reserved_positions": reserved, "used_positions": used,
                "shared_positions": shared,
                "frag_positions": reserved + shared - used,
                "cached_blocks": self.pool.cached_blocks()}

    def validate(self, request: GenerationRequest) -> GenerationRequest:
        """Pool-level bound: the request's worst-case block count must fit
        the pool and the block table (NOT a per-row max_seq reservation —
        blocks are only taken as generation actually reaches them)."""
        total = self.blocks_for(request.prompt_len + request.max_new_tokens)
        limit = min(self.pool.num_blocks, self.table_width)
        if total > limit:
            raise ValueError(
                f"request {request.req_id} needs {total} blocks "
                f"({request.prompt_len + request.max_new_tokens} positions "
                f"/ {self.block_size}), pool+table allow {limit}")
        return request

    def can_admit(self, prefill_len: int, request: GenerationRequest,
                  feed=None) -> bool:
        """Block-exhaustion backpressure: admit when the prefill's NEW
        blocks plus a one-block growth watermark are free.  Capped at
        the request's worst-case total so a pool-sized request is still
        admissible on an idle pool (no livelock).

        With the prefix cache on, pass the actual ``feed`` tokens: the
        accounting is exact — LIVE matched blocks (another slot holds
        them) cost nothing, matched blocks in the cached set will be
        REVIVED (each consumes one unit of allocatable capacity, since
        ``free_blocks()`` still counts them), the uncached span needs
        fresh blocks, and a fully-cached feed whose tail block is live
        needs one more for the copy-on-write fork (a revived tail is
        sole-owned and rewritten in place instead)."""
        total = self.blocks_for(request.prompt_len + request.max_new_tokens)
        if feed is not None and self.prefix_cache:
            prefill_len = len(feed)
            revived = live = 0
            tail_live = False
            for h in chain_hashes(feed, self.block_size):
                b = self.pool.lookup(h)
                if b is None:
                    break
                if self.pool.is_cached(b):
                    revived += 1
                    tail_live = False
                else:
                    live += 1
                    tail_live = True
            matched = revived + live
            fresh = self.blocks_for(prefill_len) - matched
            fully_cached = matched * self.block_size >= prefill_len
            fork = 1 if (fully_cached and tail_live) else 0
            need_cap = fresh + revived + fork
            need = min(need_cap + 1, max(need_cap, total - live))
            return self.pool.free_blocks() >= need
        need = min(self.blocks_for(prefill_len) + 1, total)
        return self.pool.free_blocks() >= need

    def needs_block(self, slot: Slot) -> bool:
        """True when the next decode write (at ``slot.pos``) falls in a
        block the slot does not hold yet."""
        return slot.pos // self.block_size >= len(slot.blocks)

    def fanout_blocks(self, slot: Slot, n_positions: int) -> int:
        """Blocks the slot must ADD so positions
        ``[pos, pos + n_positions)`` are all backed — the speculative
        fan-out reservation: a spec round may write up to k candidate
        positions of KV before knowing how many survive verification.
        The engine allocates these onto ``slot.blocks`` BEFORE the
        round; rejected tails simply leave the last block(s) partly
        unwritten (stale-beyond-pos, masked like any other), so
        rollback never frees — and can never corrupt — shared or
        prefix-cached blocks."""
        return max(self.blocks_for(slot.pos + n_positions)
                   - len(slot.blocks), 0)

    # ------------------------------------------------------ prefix caching
    def matchable_blocks(self, tokens) -> int:
        """Non-mutating probe: how many consecutive full blocks of
        ``tokens`` are resident in the hash index right now."""
        if not self.prefix_cache:
            return 0
        n = 0
        for h in chain_hashes(tokens, self.block_size):
            if self.pool.lookup(h) is None:
                break
            n += 1
        return n

    def match_prefix(self, tokens) -> tuple[list[int], list[int]]:
        """Claim the longest cached full-block prefix of ``tokens``:
        each hit takes a reference on the physical block (reviving it
        from the cached set if no live slot holds it).  Returns
        (blocks, hashes); stops at the first miss — hash-chain keying
        means later blocks cannot match once one misses."""
        blocks: list[int] = []
        hashes: list[int] = []
        if not self.prefix_cache:
            return blocks, hashes
        for h in chain_hashes(tokens, self.block_size):
            b = self.pool.match(h)
            if b is None:
                break
            blocks.append(b)
            hashes.append(h)
        self._stats["prefix_block_hits"] += len(blocks)
        return blocks, hashes

    def ensure_writable(self, blocks: list[int],
                        blk_idx: int) -> tuple[list[int], tuple | None]:
        """Copy-on-write gate before any KV write into ``blocks[blk_idx]``.

        Shared (refcount > 1): allocate a private block, hand back our
        reference on the shared one, and return the updated table plus a
        ``(src, dst)`` physical copy pair — the CALLER must copy the
        pool data (the manager only does accounting).  Sole-owner but
        hash-registered: the content is about to diverge from its key,
        so drop the index entry and write in place.  Private: no-op."""
        b = blocks[blk_idx]
        if self.pool.refcount.get(b, 0) > 1:
            [new] = self.pool.alloc(1)
            self.pool.free([b])          # our ref only; sharers keep it
            blocks = list(blocks)
            blocks[blk_idx] = new
            self._stats["cow_forks"] += 1
            return blocks, (b, new)
        if self.pool.is_registered(b):
            self.pool.unregister(b)
        return blocks, None

    def register_full_blocks(self, slot: Slot, kv_tokens) -> None:
        """Extend ``slot.block_hashes`` over newly-FULL blocks and key
        them in the pool's hash index.  ``kv_tokens`` is the token
        sequence whose KV the slot's blocks hold (prompt + generated so
        far); called after admission's scatter and whenever decode fills
        a block.  First-writer-wins on hash collisions with concurrent
        private fills (``BlockPool.register``)."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        n_full = min(len(kv_tokens) // bs, len(slot.blocks))
        h = slot.block_hashes[-1] if slot.block_hashes else None
        for j in range(len(slot.block_hashes), n_full):
            blk = tuple(int(t) for t in kv_tokens[j * bs:(j + 1) * bs])
            h = hash((h, blk))
            slot.block_hashes.append(h)
            self.pool.register(slot.blocks[j], h)

    def release(self, slot: Slot) -> None:
        super().release(slot)
        self.pool.free(slot.blocks)
        slot.blocks = []
        slot.block_hashes = []

    def preempt(self, slot: Slot) -> None:
        """Release a slot mid-generation (pool pressure).  The engine
        stashes the generated tokens and requeues the request; resume
        re-prefills prompt+generated, so greedy output is unchanged."""
        self.release(slot)
        self._stats["preempted"] += 1
        self._stats["admitted"] -= 1     # resume will re-admit
        self._stats["released"] -= 1

    def block_table(self) -> np.ndarray:
        """(max_slots, table_width) int32 physical block ids.  Unassigned
        entries are 0 = the junk block: gathered but always masked (they
        only cover positions >= the slot's pos), and the only writes that
        target them are inactive rows' (index 0, table row 0)."""
        table = np.zeros((self.max_slots, self.table_width), np.int32)
        for i, slot in self.active.items():
            if slot.prefilling:
                continue
            table[i, :len(slot.blocks)] = slot.blocks
        return table
