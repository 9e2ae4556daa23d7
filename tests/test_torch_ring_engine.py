"""Ring caches (--swa-compress) in the port's BatchEngine, on the CPU, on
the tiny gpt-oss (a 32-key window on every other layer, sinks; a ring of
640 rows): the engine's greedy tokens are the runtime's ring tokens, and
its prefix reuse follows the ring rule.

Position p lives in ring slot p % 640 until a later position overwrites
it. A slot that served a 700-token request holds positions 60-699 on its
ring layers; a new prompt sharing only its first 40 tokens needs
positions 8-39, which are gone. The JAX engine reuses that prefix anyway
and its tokens part from its own fresh engine's (shown below); the port's
engine prefills such a slot from 0, and reuses a prefix whose window the
ring still holds."""
import queue

import numpy as np
import pytest

from fixtures import make_tiny_gptoss_gguf
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
from ik_llama_cpp_tpu.server.engine import BatchEngine as JEngine, Request as JRequest
from ik_llama_cpp_tpu_torch.models.llama import SwaKVCache
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request

CAP = 900


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_tiny_gptoss_gguf(tmp_path_factory.mktemp("ring") / "oss.gguf", seed=1)


@pytest.fixture(scope="module")
def rt(model):
    return Runtime.from_gguf(model, device="cpu", swa_compress=True)


RNG = np.random.default_rng(9)
PA = [int(x) for x in RNG.integers(3, 250, 700)]
PB = PA[:40] + [int(x) for x in RNG.integers(3, 250, 20)]     # a prefix the ring lost
PC = PA[:690] + [int(x) for x in RNG.integers(3, 250, 10)]    # a prefix it still holds


def _serve(eng, make, reqs):
    """Each (prompt, n) request in turn, on a thread-run engine; returns
    [(tokens, prompt tokens reused)]."""
    out = []
    for p, n in reqs:
        r = make(p, n)
        r.stream_queue = queue.Queue()
        cached = eng.n_prompt_tokens_cached
        eng.submit(r)
        if hasattr(eng, "step"):
            while eng.step():
                pass
        toks = []
        while True:
            tok, _, done = r.stream_queue.get(timeout=600)
            if tok >= 0:
                toks.append(tok)
            if done:
                break
        out.append((toks, eng.n_prompt_tokens_cached - cached))
    return out


def _port(p, n):
    return Request(prompt_ids=p, n_predict=n, sampler=SamplerParams(temp=0.0))


def _jax(p, n):
    return JRequest(prompt_ids=p, n_predict=n, sampler=JParams(temp=0.0))


def _want(rt, p, n=8):
    return rt.generate_greedy_on_device(p, n, capacity=CAP, stop_at_eos=False)[1]


@pytest.mark.parametrize("second,reused", [(PB, 0), (PC, 690)], ids=["lost", "held"])
def test_ring_reuse_rule(rt, second, reused):
    eng = BatchEngine(rt, n_slots=1, capacity=CAP)
    assert isinstance(eng.kv, SwaKVCache) and eng.kv.swa_cap == 640
    (a, _), (b, cached) = _serve(eng, _port, [(PA, 4), (second, 8)])
    assert a == _want(rt, PA, 4) and b == _want(rt, second) and cached == reused


def test_jax_engine_reuses_a_lost_prefix(model):
    """What the reuse rule prevents: the JAX engine reuses PB's 40-token
    prefix from ring rows that later positions overwrote, and its greedy
    tokens differ from a fresh JAX engine's for the same prompt."""
    jr = JRuntime.from_gguf(model, swa_compress=True)
    got = []
    for reqs in ([(PA, 4), (PB, 8)], [(PB, 8)]):
        eng = JEngine(jr, n_slots=1, capacity=CAP)
        eng.start()
        try:
            got.append(_serve(eng, _jax, reqs)[-1])
        finally:
            eng.stop()
    (reused_toks, cached), (fresh_toks, _) = got
    assert cached == 40 and reused_toks != fresh_toks


def test_two_slots_on_rings(rt):
    """Two requests at once (700 and 300 tokens) on two slots, then one that
    extends the first slot's history: the runtime's ring tokens each."""
    eng = BatchEngine(rt, n_slots=2, capacity=CAP)
    pd = [int(x) for x in np.random.default_rng(5).integers(3, 250, 300)]
    reqs = [_port(PA, 8), _port(pd, 8)]
    for r in reqs:
        r.stream_queue = queue.Queue()
        eng.submit(r)
    while eng.step():
        pass
    for r, p in zip(reqs, (PA, pd)):
        assert _drain(r.stream_queue) == _want(rt, p)
    (c, cached), = _serve(eng, _port, [(PC, 8)])
    assert c == _want(rt, PC) and cached == 690


def _drain(q):
    toks = []
    while True:
        tok, _, done = q.get(timeout=0)
        if tok >= 0:
            toks.append(tok)
        if done:
            return toks
