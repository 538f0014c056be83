"""The port's ContinuousBatchingEngine against the JAX engine.

Same requests (numpy-seeded prompts, a greedy/seeded mix, more requests
than slots) and the same weights (JAX ``Model.init`` -> numpy ->
``weights.from_jax_params``) at ``reduced(smollm-135m)`` in float32.  The
JAX engine serves each reference once on its direct (XLA) path; the port
serves under the Xar-Trek runtime pinned to HOST, pinned to ACCEL, and
under a scripted policy that migrates every 3 calls.  Tokens must be
identical.  Logprobs (within 1e-4) are compared only on the lossless
config (float32 KV pool): on a bfloat16 pool the reference itself drifts
across preempt/resume (ROADMAP.md queue 3)."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models.model import build_model as j_build
from repro.serve import ContinuousBatchingEngine as JEngine
from repro.serve import GenerationRequest as JRequest
from repro.serve import SamplingParams as JSampling
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced
from repro_torch.core.function import FunctionRegistry
from repro_torch.core.kernel_bank import KernelBank, KernelLoadError
from repro_torch.core.policy import Decision, PinAccel, PinHost
from repro_torch.core.runtime import XarTrekRuntime
from repro_torch.core.targets import TargetKind
from repro_torch.serve import (
    ContinuousBatchingEngine, GenerationRequest, SamplingParams,
)
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: intra-op threads only contend (the suite
    runs several pytest workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LP_TOL = 1e-4

# (prompt length, max_new_tokens, sampling or None for greedy)
SPECS = [(5, 6, None), (13, 4, (0.8, 40, 0.95, 7)), (9, 7, None),
         (20, 5, (1.0, 0, 0.9, 11)), (11, 6, (0.7, 5, 1.0, 3))]


def _cfgs(kv: str):
    j = dataclasses.replace(reduced(ARCHS["smollm-135m"]), dtype="float32",
                            kv_cache_dtype=kv)
    t = dataclasses.replace(t_reduced(T_ARCHS["smollm-135m"]),
                            dtype="float32", kv_cache_dtype=kv)
    return j, t


def _requests(vocab, make_req, make_sp, specs=SPECS, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for n, m, s in specs:
        sp = (make_sp(logprobs=True) if s is None else
              make_sp(temperature=s[0], top_k=s[1], top_p=s[2], seed=s[3],
                      logprobs=True))
        out.append(make_req(rng.randint(0, vocab, size=n), max_new_tokens=m,
                            sampling=sp))
    return out


@pytest.fixture(scope="module")
def world():
    """JAX weights (shared by both pool dtypes) and the reference runs."""
    jcfg, tcfg = _cfgs("float32")
    jcfg16, tcfg16 = _cfgs("bfloat16")
    params = j_build(jcfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    refs = {}

    def ref(name, cfg, **kw):
        eng = JEngine(cfg, params=params, **kw)
        reqs = _requests(cfg.vocab_size, JRequest, JSampling)
        outs = eng.run(reqs)
        refs[name] = [outs[r.req_id] for r in reqs]
        if kw.get("paged"):
            refs[name + "_preempted"] = eng.slots.stats["preempted"]

    ref("dense", jcfg, max_slots=2, max_seq=64)
    ref("paged", jcfg, max_slots=2, max_seq=64, paged=True, block_size=8)
    ref("paged_bf16", jcfg16, max_slots=2, max_seq=64, paged=True,
        block_size=8)
    ref("tiny_pool", jcfg, max_slots=3, max_seq=32, paged=True,
        block_size=4, num_blocks=9)
    return dict(params=tparams, tcfg=tcfg, tcfg16=tcfg16, refs=refs)


@dataclasses.dataclass
class FlipEvery:
    """Scripted policy: HOST for ``n`` calls of a step, then ACCEL for
    ``n``, and so on (forced mid-stream migration)."""

    n: int = 3
    name: str = "flip_every"

    def __post_init__(self):
        self.count = {}

    def decide(self, signals, row, residency):
        c = self.count.get(row.app, 0)
        self.count[row.app] = c + 1
        accel = (c // self.n) % 2 == 1 and residency.resident
        return Decision(TargetKind.ACCEL if accel else TargetKind.HOST)


POLICIES = {"host": PinHost, "accel": PinAccel, "flip": FlipEvery}


def _engine(world, policy, cfg=None, **kw):
    rt = XarTrekRuntime(registry=FunctionRegistry())
    eng = ContinuousBatchingEngine(cfg or world["tcfg"],
                                   params=world["params"], runtime=rt,
                                   policy=POLICIES[policy](), device="cpu",
                                   **kw)
    return eng, rt


def _serve(eng, cfg=None, specs=SPECS):
    reqs = _requests((cfg or eng.cfg).vocab_size, GenerationRequest,
                     SamplingParams, specs)
    outs = eng.run(reqs)
    return [outs[r.req_id] for r in reqs]


def _assert_same(got, want, logprobs: bool):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
        if logprobs:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=LP_TOL)


@pytest.mark.parametrize("policy", ["host", "accel", "flip"])
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_tokens_and_logprobs_match_jax_engine(world, pool, policy):
    kw = dict(max_slots=2, max_seq=64)
    if pool == "paged":
        kw.update(paged=True, block_size=8)
    eng, rt = _engine(world, policy, **kw)
    _assert_same(_serve(eng), world["refs"][pool], logprobs=True)
    calls = rt.summary()["per_function"]["cb_decode"]["calls"]
    if policy == "flip":
        assert calls.get("host") and calls.get("accel")
        assert rt.summary()["migrations"] >= 2
    else:
        assert set(calls) == {policy}


def test_bf16_pool_tokens_match_jax_engine(world):
    """Float32 compute over a bfloat16 pool (the JAX serve tests' config):
    ACCEL reads the pool in its own dtype, the reference casts it."""
    eng, _ = _engine(world, "accel", cfg=world["tcfg16"], max_slots=2,
                     max_seq=64, paged=True, block_size=8)
    _assert_same(_serve(eng), world["refs"]["paged_bf16"], logprobs=False)


def test_preempt_resume_under_tiny_pool_matches_jax(world):
    eng, _ = _engine(world, "accel", max_slots=3, max_seq=32, paged=True,
                     block_size=4, num_blocks=9)
    got = _serve(eng)
    assert eng.slots.stats["preempted"] > 0
    assert eng.slots.stats["preempted"] == world["refs"]["tiny_pool_preempted"]
    _assert_same(got, world["refs"]["tiny_pool"], logprobs=True)
    assert eng.slots.pool.free_blocks() == eng.slots.pool.num_blocks


def test_stop_token_ends_request_early(world):
    want = world["refs"]["paged"][0]            # greedy, 6 tokens
    stop = int(want.tokens[2])
    first = list(want.tokens).index(stop)
    eng, _ = _engine(world, "accel", max_slots=2, max_seq=64, paged=True,
                     block_size=8)
    req = GenerationRequest(
        np.random.RandomState(3).randint(0, eng.cfg.vocab_size, size=5),
        max_new_tokens=6, stop_tokens=(stop,),
        sampling=SamplingParams(logprobs=True))
    out = eng.run([req])[req.req_id]
    assert out.finish_reason == "stop"
    np.testing.assert_array_equal(out.tokens, want.tokens[:first + 1])


def test_abort_mid_stream_frees_slot_and_blocks(world):
    eng, _ = _engine(world, "accel", max_slots=2, max_seq=64, paged=True,
                     block_size=8)
    reqs = _requests(eng.cfg.vocab_size, GenerationRequest, SamplingParams)
    victim = reqs[2]
    handles = {r.req_id: eng.submit(r) for r in reqs}
    handles[victim.req_id].on_token = (
        lambda tok: len(handles[victim.req_id].tokens) == 2
        and handles[victim.req_id].abort())
    outs = eng.run()
    want = world["refs"]["paged"]
    assert outs[victim.req_id].finish_reason == "aborted"
    np.testing.assert_array_equal(outs[victim.req_id].tokens,
                                  want[2].tokens[:2])
    for i, r in enumerate(reqs):
        if r is not victim:
            np.testing.assert_array_equal(outs[r.req_id].tokens,
                                          want[i].tokens)
    assert not eng.slots.active
    assert eng.slots.pool.free_blocks() == eng.slots.pool.num_blocks


def test_streaming_handle_and_generate(world):
    """Tokens stream through the handle while ``run`` drains on another
    thread; ``generate`` returns the same greedy tokens as the JAX run."""
    import threading
    eng, _ = _engine(world, "accel", max_slots=2, max_seq=64, paged=True,
                     block_size=8)
    prompt = np.random.RandomState(3).randint(0, eng.cfg.vocab_size, size=5)
    want = world["refs"]["paged"][0].tokens          # greedy, 6 tokens
    handle = eng.submit(prompt, max_new_tokens=6)
    loop = threading.Thread(target=eng.run)
    loop.start()
    streamed = list(handle)
    loop.join(timeout=60)
    assert not loop.is_alive()
    np.testing.assert_array_equal(streamed, want)
    np.testing.assert_array_equal(handle.result(timeout=1).tokens, want)
    np.testing.assert_array_equal(eng.generate(prompt[None], 6)[0], want)


def _failing_build(monkeypatch):
    from repro_torch.kernels import ops

    def boom(device):
        raise RuntimeError("nvcc: simulated build failure")
    monkeypatch.setattr(ops, "build", boom)


def test_failed_accel_load_raises_at_construction(world, monkeypatch):
    _failing_build(monkeypatch)
    with pytest.raises(KernelLoadError) as info:
        _engine(world, "accel", max_slots=2, max_seq=64)
    assert "simulated build failure" in str(info.value.__cause__)


def test_failed_async_accel_load_reraises_instead_of_serving_host(
        world, monkeypatch):
    """The JAX runtime routes every ACCEL decision to HOST when the bank's
    loader thread died; the port re-raises the recorded failure at the
    next call, and unfinished handles finish ``aborted``."""
    _failing_build(monkeypatch)
    rt = XarTrekRuntime(registry=FunctionRegistry())
    eng = ContinuousBatchingEngine(world["tcfg"], params=world["params"],
                                   runtime=rt, policy=PinAccel(),
                                   device="cpu", max_slots=2, max_seq=64,
                                   eager_accel=False)
    deadline = time.monotonic() + 30
    while len(rt.bank.failures()) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sorted(rt.bank.failures()) == ["cb_decode", "cb_prefill"]
    handle = eng.submit(np.arange(1, 6), max_new_tokens=3)
    with pytest.raises(KernelLoadError):
        eng.run()
    assert handle.result(timeout=1).finish_reason == "aborted"
    assert not rt.call_log          # nothing was served on HOST instead


def test_kernel_bank_records_and_reraises_load_failures():
    def load(name):
        if name == "bad":
            raise ValueError("bad kernel")
        return name

    bank = KernelBank(slots=2, load_fn=load)
    bank.load_sync("good")
    assert bank.is_resident("good")
    with pytest.raises(KernelLoadError):
        bank.load_sync("bad")
    assert not bank.is_resident("bad") and not bank.is_loading("bad")
    with pytest.raises(KernelLoadError):
        bank.raise_if_failed("bad")
    bank.load_async("bad")              # a failed kernel is not retried
    assert bank.stats["failures"] == 1


def test_runtime_moves_state_to_the_chosen_targets_device():
    """``state_devices`` moves a call's arguments to the device its target
    wants (the Popcorn state transformation); trees that disagree in
    structure or leaf shape are refused."""
    from repro_torch.core import migration
    from repro_torch.core.binary import AbiMismatch
    from repro_torch.core.function import MigratableFunction
    reg = FunctionRegistry()
    seen = []

    def host(x):
        seen.append(x["a"].device.type)
        return x["a"] * 2

    reg.register(MigratableFunction("double", "double",
                                    {TargetKind.HOST: host}))
    rt = XarTrekRuntime(registry=reg, policy=PinHost())
    arg = {"a": torch.ones(3)}
    rt.prepare("double", arg)
    out = rt.call("double", arg, state_devices={TargetKind.HOST: "cpu"})
    assert out.tolist() == [2.0, 2.0, 2.0] and seen[-1] == "cpu"
    assert migration.migration_bytes(arg) == 12
    with pytest.raises(AbiMismatch):
        migration.check_abi(arg, {"a": torch.ones(4)})
    with pytest.raises(AbiMismatch):
        migration.check_abi(arg, {"b": torch.ones(3)})
