"""In-step per-request token sampling, bit-compatible with the JAX package.

Port of ``repro/models/sampling.py``: temperature, then top-k, then top-p,
then a Gumbel-max draw, plus the chosen token's logprob under the raw
logits.  The per-row key is ``fold_in(PRNGKey(seed), position)``, and the
Gumbel noise is drawn from it exactly as ``jax.random.gumbel`` draws it:
the threefry2x32 counter hash (20 rounds, JAX's rotation and key-schedule
constants), the partitionable bit layout (``jax_threefry_partitionable``,
the default of jax 0.9.0: counter i hashes as the 64-bit pair (0, i) and
the two output words are xor-ed), the mantissa trick for uniforms in
[tiny, 1), and ``-log(-log(u))``.  So a seeded request draws the same
tokens here as in the JAX engine, on every target and across preemption.

The 32-bit words are held in int64 tensors and masked, since PyTorch has
no full set of uint32 operations; the batch dimension is written out (the
JAX ``vmap``).
"""
from __future__ import annotations

import numpy as np
import torch

# keys of a serve batch dict that feed sampling, not the model forward
SAMPLING_KEYS = ("temperature", "top_k", "top_p", "seed")

NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def sampling_leaves(params, batch_size: int = 1) -> dict:
    """(B,)-vector numpy leaves for one SamplingParams broadcast over a
    batch (the prefill path's B=1 case)."""
    return {
        "temperature": np.full((batch_size,), params.temperature, np.float32),
        "top_k": np.full((batch_size,), params.top_k, np.int32),
        "top_p": np.full((batch_size,), params.top_p, np.float32),
        "seed": np.full((batch_size,), params.seed, np.int32),
    }


# ------------------------------------------------------------- threefry

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash of counters (x1, x2) under key (k1, k2).

    All arguments are int64 tensors holding uint32 values (broadcastable);
    returns the two uint32 output words as int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK32
    x2 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x1, x2


def prng_key(seed: torch.Tensor) -> torch.Tensor:
    """``jax.random.PRNGKey`` of (B,) int32 seeds -> (B, 2) int64 keys:
    (0, seed as uint32)."""
    s = seed.long() & _MASK32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of (B, 2) keys with (B,) data -> (B, 2)."""
    d = data.long() & _MASK32
    y1, y2 = threefry2x32(key[:, 0], key[:, 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each of (B, 2) keys ->
    (B, n) int64 words, partitionable layout."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)[None, :]
    b1, b2 = threefry2x32(key[:, 0:1], key[:, 1:2],
                          torch.zeros_like(counts), counts)
    return b1 ^ b2


def _as_float32(words: torch.Tensor) -> torch.Tensor:
    """Bit-cast uint32 words (int64 tensor) to float32."""
    signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return signed.to(torch.int32).view(torch.float32)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key."""
    bits = random_bits(key, n)
    floats = _as_float32((bits >> 9) | 0x3F800000) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key -> (B, n)."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


# ------------------------------------------------------------- sampling

def sample_tokens(logits, temperature, top_k, top_p, seed, pos):
    """Batched sampling.

    logits: (B, V); temperature/top_p: (B,) float32; top_k/seed/pos: (B,)
    int32 — ``pos`` is each row's absolute position of the token being
    sampled.  Returns ((B,) int32 tokens, (B,) float32 chosen-token
    logprobs under the raw model distribution).  Greedy rows
    (temperature 0) take the argmax of the raw logits."""
    logits = logits.float()
    B, V = logits.shape
    greedy = logits.argmax(dim=-1)
    tok = greedy
    if bool((temperature > 0).any()):
        tok = torch.where(temperature <= 0, greedy,
                          _sampled(logits, temperature, top_k, top_p, seed,
                                   pos))
    logp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok.to(torch.int32), logp


def _sampled(logits, temperature, top_k, top_p, seed, pos):
    """Filtered Gumbel-max draw of every row (``_sample_row`` of the JAX
    package with the row dimension written out)."""
    B, V = logits.shape
    temperature = temperature.float()[:, None]
    top_p = top_p.float()[:, None]
    z = logits / torch.clamp(temperature, min=1e-6)
    probs = torch.softmax(z, dim=-1)
    sp = probs.sort(dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k.long(),
                                    torch.full_like(top_k.long(), V)), 1, V)
    pk = sp.gather(1, (k_eff - 1)[:, None])                    # (B, 1)
    spk = torch.where(sp >= pk, sp, torch.zeros_like(sp))
    mass = spk.sum(dim=-1, keepdim=True)
    csum = spk.cumsum(dim=-1)
    keep = ((top_p >= 1.0) | ((csum - spk) < top_p * mass)) & (spk > 0)
    thr = torch.where(keep, spk, torch.full_like(spk, float("inf"))) \
        .amin(dim=-1, keepdim=True)
    z = torch.where((probs >= thr) & (probs >= pk), z,
                    torch.full_like(z, NEG_INF))
    key = fold_in(prng_key(seed), pos)
    return (z + gumbel(key, V)).argmax(dim=-1)
