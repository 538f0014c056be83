"""The port's sampler against ``jax.random`` and ``repro.models.sampling``.

Threefry bits, ``fold_in`` keys and uniforms equal jax 0.9.0's bit for bit
(the ``jax_threefry_partitionable`` layout).  Gumbel values agree within
1e-6 (absolute and relative): both sides apply ``-log(-log(u))`` to the
same uniforms, but XLA's CPU ``log`` is a polynomial that is not
correctly rounded, so about a fifth of the inner logs differ in the last
bit (ROADMAP.md queue 3).  Sampled tokens are identical across greedy,
temperature, top-k and top-p rows.  Logprobs agree within 1e-6 over the
reduced vocabulary (256); over the full one (49152) the float32 sum of
49152 exponentials, taken in another order than XLA's, moves the
log-normaliser by up to 4e-6 (an ulp at |logprob| ~ 10 is 9.5e-7), so
the bound there is 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sampling as jsamp
from repro_torch.models import sampling as tsamp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: intra-op threads only contend (the suite
    runs several pytest workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = np.array([0, 1, 1234, -7, 2 ** 31 - 1, -2 ** 31], np.int32)
POS = np.array([0, 5, 17, 600, 3, 99], np.int32)


def _jax_keys():
    return [jax.random.fold_in(jax.random.PRNGKey(int(s)), int(p))
            for s, p in zip(SEEDS, POS)]


def _port_keys():
    return tsamp.fold_in(tsamp.prng_key(torch.from_numpy(SEEDS)),
                         torch.from_numpy(POS))


def test_prng_key_and_fold_in_bit_exact():
    want = np.stack([np.asarray(jax.random.key_data(k)) for k in _jax_keys()])
    np.testing.assert_array_equal(_port_keys().numpy().astype(np.uint32),
                                  want)
    base = np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(int(s))))
                     for s in SEEDS])
    np.testing.assert_array_equal(
        tsamp.prng_key(torch.from_numpy(SEEDS)).numpy().astype(np.uint32),
        base)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_random_bits_and_uniform_bit_exact(n):
    keys = _jax_keys()
    want = np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32))
                     for k in keys])
    got = tsamp.random_bits(_port_keys(), n).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    tiny = np.finfo(np.float32).tiny
    want_u = np.stack([np.asarray(jax.random.uniform(
        k, (n,), jnp.float32, tiny, 1.0)) for k in keys])
    got_u = tsamp.uniform(_port_keys(), n, float(tiny), 1.0).numpy()
    np.testing.assert_array_equal(got_u, want_u)


def test_gumbel_matches_jax():
    keys = _jax_keys()
    want = np.stack([np.asarray(jax.random.gumbel(k, (4096,), jnp.float32))
                     for k in keys])
    got = tsamp.gumbel(_port_keys(), 4096).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


ROWS = [  # temperature, top_k, top_p, seed
    (0.0, 0, 1.0, 0),        # greedy
    (1.0, 0, 1.0, 3),        # temperature only
    (0.8, 40, 1.0, 11),      # top-k
    (0.7, 0, 0.9, 12),       # top-p
    (0.8, 40, 0.95, 1234),   # all filters
    (1.3, 5, 0.5, -9),
    (0.5, 1, 1.0, 77),       # top-k 1 == greedy
    (2.0, 0, 0.3, 2 ** 30),
]


@pytest.mark.parametrize("V", [256, 49152])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_sample_tokens_match_jax(V, scale):
    rng = np.random.RandomState(V + int(scale))
    logits = (rng.randn(len(ROWS), V) * scale).astype(np.float32)
    temp, top_k, top_p, seed = (np.array(c, dt) for c, dt in zip(
        zip(*ROWS), (np.float32, np.int32, np.float32, np.int32)))
    pos = rng.randint(0, 2000, size=len(ROWS)).astype(np.int32)
    jt, jl = jsamp.sample_tokens(jnp.asarray(logits), jnp.asarray(temp),
                                 jnp.asarray(top_k), jnp.asarray(top_p),
                                 jnp.asarray(seed), jnp.asarray(pos))
    tt, tl = tsamp.sample_tokens(*(torch.from_numpy(a) for a in (
        logits, temp, top_k, top_p, seed, pos)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-6 if V == 256 else 1e-5, rtol=0)


def test_sampling_leaves_match_jax():
    from repro.serve import SamplingParams as JSP
    from repro_torch.serve import SamplingParams
    a = jsamp.sampling_leaves(JSP(temperature=0.8, top_k=4, seed=3), 5)
    b = tsamp.sampling_leaves(SamplingParams(temperature=0.8, top_k=4,
                                             seed=3), 5)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype
