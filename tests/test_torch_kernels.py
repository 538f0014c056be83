"""The port's kernels A (flash prefill) and B (paged decode) held against
the JAX package: the plain versions (what the wrappers run on CPU tensors)
against ``repro.kernels.ref`` and against the Pallas kernels in interpret
mode, on the same numpy-seeded inputs.  Tolerance 1e-5 (float32; only the
order of summation differs).  The CUDA kernels themselves run only on the
card: the ``gpu``-marked cases compare them with their plain versions and
skip here."""
import os
import stat

import numpy as np
import pytest
import torch

try:        # the reference; the card's machine has no JAX, and there only
    import jax.numpy as jnp                          # the gpu case runs
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as j_flash
    from repro.kernels.gqa_decode import paged_gqa_decode as j_paged
except ImportError:
    jnp = None

from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    flash_prefill, flash_prefill_plain)
from repro_torch.kernels.gqa_decode import paged_decode, paged_decode_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: intra-op threads only contend (the suite
    runs several pytest workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs JAX and the repro package (the reference)")


# ----------------------------------------------------------- kernel A

@pytest.mark.parametrize("S,T", [(8, 8), (13, 13), (40, 40), (5, 12)])
def test_attention_ref_matches_jax_oracle(S, T):
    """Ragged S (not a tile multiple) and a causal offset T - S > 0."""
    rng = np.random.RandomState(S * 100 + T)
    q, k, v = (rng.randn(6, n, 32).astype(np.float32) for n in (S, T, T))
    want = np.asarray(jref.attention_ref(_j(q), _j(k), _j(v)))
    got = tref.attention_ref(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S,H,KV", [(8, 3, 1), (13, 9, 3), (24, 4, 4)])
def test_flash_prefill_matches_pallas_kernel(S, H, KV):
    """The wrapper's plain route (CPU tensors) against the Pallas flash
    kernel run in interpret mode through the JAX model-facing wrapper,
    GQA head expansion included."""
    rng = np.random.RandomState(S + H)
    B, hd = 2, 32
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, KV, hd).astype(np.float32)
    v = rng.randn(B, S, KV, hd).astype(np.float32)
    kv_map = (np.arange(H) // (H // KV)).astype(np.int32)
    want = np.asarray(jops.flash_attention(
        _j(q), _j(k), _j(v), kv_index=tuple(int(i) for i in kv_map),
        interpret=True))
    got = flash_prefill(_t(q), _t(k), _t(v), _t(kv_map)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    raw = np.asarray(j_flash(
        _j(q).transpose(0, 2, 1, 3).reshape(B * H, S, hd),
        _j(k)[:, :, kv_map].transpose(0, 2, 1, 3).reshape(B * H, S, hd),
        _j(v)[:, :, kv_map].transpose(0, 2, 1, 3).reshape(B * H, S, hd),
        interpret=True)).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, raw, atol=TOL, rtol=TOL)


# ----------------------------------------------------------- kernel B

def _pool(seed, B, KV, G, hd, NP, BS, NBT, lengths, pool_dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, KV, G, hd).astype(np.float32)
    kp = rng.randn(NP, BS, KV, hd).astype(np.float32)
    vp = rng.randn(NP, BS, KV, hd).astype(np.float32)
    if pool_dtype == "bfloat16":      # round once, feed both sides alike
        kp = np.asarray(_j(kp, "bfloat16").astype("float32"))
        vp = np.asarray(_j(vp, "bfloat16").astype("float32"))
    kn = rng.randn(B, KV, 1, hd).astype(np.float32)
    vn = rng.randn(B, KV, 1, hd).astype(np.float32)
    tables = np.stack([rng.permutation(NP)[:NBT] for _ in range(B)])
    return (q, kp, vp, kn, vn, tables.astype(np.int32),
            np.asarray(lengths, np.int32))


# lengths: an empty row (len 0 -> v_new), mid-block, block edge, and a
# full table (NBT * BS)
CASES = [
    dict(B=4, KV=1, G=3, hd=32, NP=9, BS=8, NBT=4, lengths=[0, 5, 8, 32]),
    dict(B=3, KV=3, G=3, hd=32, NP=12, BS=4, NBT=3, lengths=[12, 0, 7]),
    dict(B=2, KV=2, G=1, hd=64, NP=5, BS=16, NBT=2, lengths=[32, 17]),
]


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_paged_decode_matches_ref_and_pallas(case, pool_dtype):
    """Plain paged decode vs ``ref.paged_decode_attention_ref`` and the
    Pallas kernel (interpret); float32 q over a bfloat16 pool reads the
    pool in its own dtype on the port side."""
    c = CASES[case]
    q, kp, vp, kn, vn, tables, lengths = _pool(case, **c,
                                               pool_dtype=pool_dtype)
    want_ref = np.asarray(jref.paged_decode_attention_ref(
        _j(q), _j(kp), _j(vp), _j(kn), _j(vn), jnp.asarray(tables),
        jnp.asarray(lengths)))
    want_pallas = np.asarray(j_paged(
        _j(q), _j(kp, pool_dtype), _j(vp, pool_dtype),
        _j(kn), _j(vn), jnp.asarray(tables), jnp.asarray(lengths),
        interpret=True))
    tdt = getattr(torch, pool_dtype)
    got = paged_decode(_t(q), _t(kp).to(tdt), _t(vp).to(tdt), _t(kn),
                       _t(vn), _t(tables), _t(lengths)).numpy()
    np.testing.assert_allclose(got, want_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want_pallas, atol=TOL, rtol=TOL)
    for b in np.nonzero(lengths == 0)[0]:       # empty rows give v_new
        np.testing.assert_allclose(got[b], np.broadcast_to(
            vn[b], got[b].shape), atol=TOL)


def test_model_facing_paged_and_ragged_decode_match_jax_wrappers():
    """GQA grouping (q heads -> (KV, G) slots and back) and the dense
    cache's identity-table view, against the JAX ``ops`` wrappers."""
    rng = np.random.RandomState(7)
    B, H, KV, hd, NP, BS, NBT = 3, 9, 3, 32, 10, 8, 3
    kv_index = np.arange(H) // 3
    q = rng.randn(B, 1, H, hd).astype(np.float32)
    kp = rng.randn(NP, BS, KV, hd).astype(np.float32)
    vp = rng.randn(NP, BS, KV, hd).astype(np.float32)
    kn = rng.randn(B, 1, KV, hd).astype(np.float32)
    vn = rng.randn(B, 1, KV, hd).astype(np.float32)
    tables = np.stack([rng.permutation(NP)[:NBT] for _ in range(B)]) \
        .astype(np.int32)
    index = np.array([0, 11, 24], np.int32)
    grouping = tops.KVGrouping.build(H, KV, kv_index, "cpu")
    kvt = tuple(int(i) for i in kv_index)
    want = np.asarray(jops.paged_gqa_decode(
        _j(q), _j(kp), _j(vp), _j(kn), _j(vn), jnp.asarray(tables),
        jnp.asarray(index), kv_index=kvt, interpret=True))
    got = tops.paged_gqa_decode(_t(q), _t(kp), _t(vp), _t(kn), _t(vn),
                                _t(tables), _t(index), grouping).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    kc = rng.randn(B, 48, KV, hd).astype(np.float32)
    vc = rng.randn(B, 48, KV, hd).astype(np.float32)
    want = np.asarray(jops.gqa_decode_ragged(
        _j(q), _j(kc), _j(vc), jnp.asarray(index), _j(kn), _j(vn),
        kv_index=kvt, interpret=True))
    got = tops.gqa_decode_ragged(_t(q), _t(kc), _t(vc), _t(index), _t(kn),
                                 _t(vn), grouping).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_kv_grouping_matches_jax():
    for H, KV, idx in ((9, 3, np.arange(9) // 3), (3, 1, np.zeros(3, int)),
                       (4, 4, None)):
        want = jops._kv_grouping(H, KV, None if idx is None else tuple(idx))
        got = tops.kv_grouping(H, KV, idx)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------- no device fallback paths

def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor neither on the CPU nor on a card raises — the wrappers
    never pick a route other than where their inputs live."""
    q = torch.empty(1, 8, 3, 32, device="meta")
    k = torch.empty(1, 8, 1, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_prefill(q, k, k, torch.zeros(3, dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError, match="span devices"):
        flash_prefill(torch.zeros(1, 8, 3, 32), k, k,
                      torch.zeros(3, dtype=torch.int32))


def test_failed_nvcc_build_raises_with_its_stderr(tmp_path, monkeypatch):
    """A compiler error surfaces as BuildError carrying nvcc's stderr."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\n"
                    "exit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.BuildError, match="fake compiler refused"):
        _build._Builder().load_all()
    assert not [p for p in os.listdir(tmp_path / "build")
                if p.endswith(".so") and ".tmp" not in p]


# ---------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """Kernels A and B on the card against their plain versions (float32
    1e-4: summation order; bfloat16 2e-2: output rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with `-m gpu` on the H100)")
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    kv_map = torch.arange(9, device="cuda", dtype=torch.int32) // 3
    for S in (8, 200):
        q = torch.randn(2, S, 9, 64, device="cuda", generator=g).to(dt)
        k = torch.randn(2, S, 3, 64, device="cuda", generator=g).to(dt)
        v = torch.randn(2, S, 3, 64, device="cuda", generator=g).to(dt)
        err = (flash_prefill(q, k, v, kv_map).float()
               - flash_prefill_plain(q, k, v, kv_map).float()).abs().max()
        assert err.item() <= tol
    lengths = torch.tensor([0, 1, 33, 128], dtype=torch.int32, device="cuda")
    tables = torch.arange(1, 17, dtype=torch.int32,
                          device="cuda").view(4, 4)
    kp = torch.randn(17, 32, 3, 64, device="cuda", generator=g).bfloat16()
    vp = torch.randn(17, 32, 3, 64, device="cuda", generator=g).bfloat16()
    q = torch.randn(4, 3, 3, 64, device="cuda", generator=g).to(dt)
    kn = torch.randn(4, 3, 1, 64, device="cuda", generator=g).to(dt)
    vn = torch.randn(4, 3, 1, 64, device="cuda", generator=g).to(dt)
    err = (paged_decode(q, kp, vp, kn, vn, tables, lengths).float()
           - paged_decode_plain(q, kp, vp, kn, vn, tables, lengths).float())
    assert err.abs().max().item() <= tol
