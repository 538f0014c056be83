"""The port's dense model against ``repro.models.model`` on the same
weights (``Model.init`` -> numpy -> ``weights.from_jax_params``) and the
same numpy-seeded inputs, at ``reduced(smollm-135m)`` with float32
compute over the bfloat16 KV pool (the serve tests' config).  HOST
(``ref``) is held against the JAX ``xla`` build and ACCEL (``cuda``, whose
wrappers run the kernels' plain versions on CPU tensors) against the JAX
``pallas`` build in interpret mode.  Logits within 1e-4 (float32 products
summed in another order), sampled tokens identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models.attention import flash_attention_hybrid as j_hybrid
from repro.models.model import build_model as j_build
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced
from repro_torch.models.attention import flash_attention_hybrid
from repro_torch.models.model import build_model
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: intra-op threads only contend (the suite
    runs several pytest workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BACKENDS = [("xla", "ref"), ("pallas", "cuda")]
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced(ARCHS["smollm-135m"]), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(T_ARCHS["smollm-135m"]),
                               dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    jm = j_build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    return cfg, jm, params, build_model(tcfg, device="cpu"), tparams


SAMPLING = {"temperature": np.array([0.0, 0.8, 1.0], np.float32),
            "top_k": np.array([0, 40, 0], np.int32),
            "top_p": np.array([1.0, 0.95, 0.9], np.float32),
            "seed": np.array([0, 1234, 7], np.int32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v, copy=True))
             for k, v in batch.items()})


@pytest.mark.parametrize("jbe,tbe", BACKENDS)
def test_prefill_matches_jax(setup, jbe, tbe):
    cfg, jm, params, tm, tparams = setup
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    batch = {"tokens": toks, "length": np.array([16, 11, 3], np.int32),
             **SAMPLING}
    jb, tb = _both(batch)
    jfwd = {k: v for k, v in jb.items() if k in ("tokens", "length")}
    tfwd = {k: v for k, v in tb.items() if k in ("tokens", "length")}
    jl, jc = jm.prefill_at(params, jfwd, backend=jbe)
    tl, tc = tm.prefill_at(tparams, tfwd, backend=tbe)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(
            tc[k].float().numpy(), np.asarray(jc[k]).astype(np.float32),
            atol=2 ** -7, rtol=2 ** -7)    # one bf16 rounding step apart
    jt, jlp, _ = jm.prefill_at_sampled(params, jb, backend=jbe)
    tt, tlp, _ = tm.prefill_at_sampled(tparams, tb, backend=tbe)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("jbe,tbe", BACKENDS)
def test_decode_matches_jax(setup, jbe, tbe, paged):
    """One ragged decode step over a random pool (an empty row, a row in
    mid-block, a row at a block edge); the in-place cache write lands
    exactly where the JAX step writes."""
    cfg, jm, params, tm, tparams = setup
    rng = np.random.RandomState(1)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (L, 10, 8, KV, hd) if paged else (L, 3, 32, KV, hd)
    kv = {k: np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16)
                        .astype(jnp.float32)) for k in ("k", "v")}
    jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in kv.items()}
    tcache = {k: torch.from_numpy(v.copy()).bfloat16() for k, v in kv.items()}
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32),
             "index": np.array([0, 13, 24], np.int32), **SAMPLING}
    if paged:
        batch["block_table"] = np.array([[0, 0, 0, 0], [3, 1, 0, 0],
                                         [2, 5, 7, 9]], np.int32)
    jb, tb = _both(batch)
    jfwd = {k: v for k, v in jb.items() if k not in SAMPLING}
    tfwd = {k: v for k, v in tb.items() if k not in SAMPLING}
    jl, jc = jm.decode(params, jcache, jfwd, backend=jbe)
    tl, tc = tm.decode(tparams, {k: v.clone() for k, v in tcache.items()},
                       tfwd, backend=tbe)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(
            tc[k].float().numpy(), np.asarray(jc[k]).astype(np.float32),
            atol=2 ** -7, rtol=2 ** -7)
    jt, jlp, _ = jm.decode_sampled(params, jcache, jb, backend=jbe)
    tt, tlp, _ = tm.decode_sampled(tparams, tcache, tb, backend=tbe)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=TOL)


def test_flash_hybrid_gradients_match_jax():
    """Kernel-forward / reference-backward pairing as an autograd
    Function: gradients equal the JAX custom_vjp's."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 8, 3, 32).astype(np.float32)
    k = rng.randn(2, 8, 1, 32).astype(np.float32)
    v = rng.randn(2, 8, 1, 32).astype(np.float32)
    g = rng.randn(2, 8, 3, 32).astype(np.float32)
    idx = np.zeros(3, np.int64)

    def jloss(a, b, c):
        return jnp.sum(j_hybrid(a, b[:, :, idx], c[:, :, idx])
                       * jnp.asarray(g))
    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    from repro_torch.kernels.ops import KVGrouping
    grouping = KVGrouping.build(3, 1, idx, "cpu")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention_hybrid(tq, tk, tv, grouping)
     * torch.from_numpy(g)).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_from_jax_params_checks_every_leaf(setup):
    cfg, jm, params, tm, tparams = setup
    tcfg = tm.cfg
    tree = jax.tree.map(np.asarray, params)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :, :2]
    with pytest.raises(ValueError, match="wq: shape"):
        from_jax_params(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, params)
    del tree["head"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, tcfg, device="cpu")
