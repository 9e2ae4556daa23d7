"""The port's BatchEngine and text Runtime on the CPU: the JAX engine's
greedy tokens on the tiny fixture JAX's test_server.py uses, then the
port engine's own features (prefix reuse, the RAM prompt-cache tier, the
context shift through k_shift, partial-stop holdback, a batched prefill of
slots that are not adjacent, the top-k readback, failed requests that do
not stop the engine), and the request options of the server-extras slice
against the JAX engine's tokens."""
import queue

import numpy as np
import pytest

from fixtures import make_tiny_llama_gguf
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
from ik_llama_cpp_tpu.server.engine import BatchEngine as JEngine, Request as JRequest
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.engine import (BatchEngine, HostPromptCache,
                                                  Request, SlotState,
                                                  _partial_stop_holdback, cache_rows)

TEXTS = ["Once upon a time", "the quick brown fox", "Hello world",
         "to be or not to be"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return make_tiny_llama_gguf(tmp_path_factory.mktemp("eng") / "m.gguf", seed=1)


@pytest.fixture(scope="module")
def rt(model):
    return Runtime.from_gguf(model, device="cpu")


def _drain(q, timeout=120):
    toks, text = [], ""
    while True:
        tok, piece, done = q.get(timeout=timeout)
        if tok >= 0:
            toks.append(tok)
        text += piece
        if done:
            return toks, text


def _serve(eng, reqs, start=True):
    """Submit every request, run the engine (its thread, or step() by hand)
    and return each request's tokens."""
    qs = []
    for r in reqs:
        r.stream_queue = queue.Queue()
        eng.submit(r)
        qs.append(r.stream_queue)
    if start:
        eng.start()
        try:
            return [_drain(q)[0] for q in qs]
        finally:
            eng.stop()
    while eng.step():
        pass
    return [_drain(q, timeout=0)[0] for q in qs]


def _greedy(p, n, **kw):
    return dict(prompt_ids=p, n_predict=n, **kw)


def test_engine_matches_jax_engine(model, rt):
    """Four greedy text requests on two slots: the JAX engine's tokens."""
    jrt = JRuntime.from_gguf(model)
    prompts = [rt.tokenizer.encode(t) for t in TEXTS]
    assert prompts == [jrt.tokenizer.encode(t) for t in TEXTS]
    want = _serve(JEngine(jrt, n_slots=2, capacity=256),
                  [JRequest(sampler=JParams(temp=0.0), **_greedy(p, 12)) for p in prompts])
    got = _serve(BatchEngine(rt, n_slots=2, capacity=256),
                 [Request(sampler=SamplerParams(temp=0.0), **_greedy(p, 12))
                  for p in prompts])
    assert got == want
    assert all(len(t) == 12 for t in got)


def test_runtime_text_generation_matches_jax(model, rt):
    """A str prompt (BOS by the tokenizer's rule), greedy and sampled, with
    eos_id from the tokenizer, and detokenize."""
    jrt = JRuntime.from_gguf(model)
    assert rt.eos_id == jrt.tokenizer.eos_id == 2
    for sp, jp in ((None, None), (SamplerParams(temp=0.9, top_k=20),
                                  JParams(temp=0.9, top_k=20))):
        ids, out = rt.generate("the quick brown fox", 10, sampler=sp, seed=4,
                               capacity=128)
        jids, jout = jrt.generate("the quick brown fox", 10, sampler=jp, seed=4,
                                  capacity=128)
        assert ids == jids and ids[0] == rt.tokenizer.bos_id
        assert out == jout
        assert rt.detokenize(out) == jrt.tokenizer.decode(jout)


def _fresh(rt, prompt, n):
    return rt.generate(prompt, n, capacity=256, stop_at_eos=False)[1]


def test_prefix_reuse(rt):
    eng = BatchEngine(rt, n_slots=1, capacity=256)
    ids = rt.tokenizer.encode("and the rest of it is")
    a = _serve(eng, [Request(sampler=SamplerParams(temp=0.0), **_greedy(ids, 6))],
               start=False)
    cached = eng.n_prompt_tokens_cached
    b = _serve(eng, [Request(sampler=SamplerParams(temp=0.0), **_greedy(ids, 6))],
               start=False)
    assert eng.n_prompt_tokens_cached > cached and a == b == [_fresh(rt, ids, 6)]
    # a follow-up that extends the whole conversation reuses its rows; the
    # last generated token has no row yet, so it is evaluated again
    follow = ids + b[0] + rt.tokenizer.encode(" more", add_bos=False)
    c = _serve(eng, [Request(sampler=SamplerParams(temp=0.0), **_greedy(follow, 6))],
               start=False)
    assert c == [_fresh(rt, follow, 6)]
    assert eng.slots[0].cache_tokens == eng.slots[0].tokens[:eng.slots[0].n_past]


def test_prefix_reuse_after_idling_matches_fresh_eval(rt):
    """A slot idles while another decodes, then a prompt that extends its
    cached tokens reuses its rows: the tokens of a fresh evaluation. (The
    JAX engine decodes idle rows at position 0 and overwrites the first
    cached row: ROADMAP §3.)"""
    tok = rt.tokenizer
    a = tok.encode("Once upon a time")
    eng = BatchEngine(rt, n_slots=2, capacity=256)
    ra, _ = _serve(eng, [Request(sampler=SamplerParams(temp=0.0), **_greedy(a, 4)),
                         Request(sampler=SamplerParams(temp=0.0),
                                 **_greedy(tok.encode("the quick brown fox"), 40))],
                   start=False)
    c = a + ra[:3] + tok.encode(" more", add_bos=False)
    rc = _serve(eng, [Request(sampler=SamplerParams(temp=0.0), **_greedy(c, 8))],
                start=False)
    assert eng.n_prompt_tokens_cached >= len(a)
    assert rc == [_fresh(rt, c, 8)]


def test_batched_prefill_of_slots_apart(rt):
    """Slots 0 and 2 prefill in one forward over the span of rows 0-2
    while slot 1 generates (its row writes junk at its next position,
    which its decode overwrites); every request gives its fresh
    evaluation's tokens."""
    tok = rt.tokenizer
    eng = BatchEngine(rt, n_slots=3, capacity=256)
    greedy = SamplerParams(temp=0.0)
    first = [Request(sampler=greedy, **_greedy(tok.encode(t), n))
             for t, n in (("it is an error", 1), ("on the other hand", 30),
                          ("three four five six", 1))]
    for r in first:
        r.stream_queue = queue.Queue()
        eng.submit(r)
    eng.step()                    # slots 0-2 prefill together; 0 and 2 finish
    assert [s.state for s in eng.slots] == [SlotState.IDLE, SlotState.GENERATING,
                                            SlotState.IDLE]
    later = [Request(sampler=greedy, **_greedy(tok.encode(t), 8))
             for t in ("Hello world", "The tiny model says")]
    forwards = eng.n_prefill_forwards
    out = _serve(eng, later, start=False)
    assert eng.n_prefill_forwards == forwards + 1
    for r, toks in zip(later, out):
        assert toks == _fresh(rt, r.prompt_ids, 8)
    assert _drain(first[1].stream_queue, 0)[0] == _fresh(rt, first[1].prompt_ids, 30)


def test_prefill_splits_around_a_row_with_no_room(rt):
    """Slot 1 generates too near the cache's end for a junk write of the
    new prompts' bucket: slots 0 and 2 take a forward each, and every
    request still gives its fresh evaluation's tokens."""
    tok = rt.tokenizer
    cap = 249                     # 256 cache rows
    eng = BatchEngine(rt, n_slots=3, capacity=cap)
    greedy = SamplerParams(temp=0.0)
    long_ids = tok.encode(" ".join(TEXTS * 8))[:200]
    first = [Request(sampler=greedy, **_greedy(ids, n))
             for ids, n in ((tok.encode("it is an error"), 1), (long_ids, 20),
                            (tok.encode("three four five six"), 1))]
    for r in first:
        r.stream_queue = queue.Queue()
        eng.submit(r)
    eng.step()
    assert eng.slots[1].state == SlotState.GENERATING
    later = [Request(sampler=greedy, **_greedy(ids, 4))
             for ids in (tok.encode(" ".join(TEXTS))[:50],
                         tok.encode(" ".join(TEXTS[::-1]))[:40])]
    assert all(len(r.prompt_ids) > 32 for r in later) and len(long_ids) == 200
    assert eng.slots[1].n_past + 64 > eng.kv.capacity == 256
    forwards = eng.n_prefill_forwards
    out = _serve(eng, later, start=False)
    assert eng.n_prefill_forwards == forwards + 2
    for r, toks in zip(later, out):
        assert toks == rt.generate(r.prompt_ids, 4, capacity=cap, stop_at_eos=False)[1]
    assert _drain(first[1].stream_queue, 0)[0] == \
        rt.generate(long_ids, 20, capacity=cap, stop_at_eos=False)[1]


def test_prefill_spans_and_junk_rows(rt):
    """A span takes the next prefilling slot when every row up to it has
    room for the span's bucket; an idle row between gives up its cached
    tail at the cache's end to make room."""
    eng = BatchEngine(rt, n_slots=4, capacity=128)
    cap = eng.kv.capacity
    s0, s1, s2, s3 = eng.slots
    for s in (s0, s2, s3):
        s.state, s.n_past = SlotState.PREFILL, 0
    chunks = {0: [1] * 40, 2: [1] * 10, 3: [1] * 5}
    s1.state, s1.n_past = SlotState.GENERATING, cap - 32
    assert eng._spans([s0, s2, s3], chunks) == [[s0], [s2, s3]]
    s1.n_past = 20
    assert eng._spans([s3, s0, s2], chunks) == [[s0, s2, s3]]
    assert eng._junk_row(s1, 64) == 20
    s1.state, s1.cache_tokens = SlotState.IDLE, list(range(cap - 10))
    assert eng._spans([s0, s2, s3], chunks) == [[s0, s2, s3]]
    assert eng._junk_row(s1, 64) == cap - 64 and s1.cache_tokens == list(range(cap - 64))
    assert eng._junk_row(s1, 1) == cap - 64


def test_long_prompt_prefills_beside_a_decode(rt):
    """A prompt of more than one chunk arrives while another slot decodes:
    its chunks interleave with decode steps and its rows survive them."""
    tok = rt.tokenizer
    eng = BatchEngine(rt, n_slots=2, capacity=1024)
    greedy = SamplerParams(temp=0.0)
    long_ids = tok.encode(" ".join(TEXTS * 30))[:600]
    out = _serve(eng, [Request(sampler=greedy, **_greedy(tok.encode("Hello world"), 24)),
                       Request(sampler=greedy, **_greedy(long_ids, 6))], start=False)
    assert out[1] == rt.generate(long_ids, 6, capacity=1024, stop_at_eos=False)[1]


@pytest.mark.parametrize("n_keep,n_discard", [(-1, -1), (2, 10)])
def test_context_shift_k_shift(rt, n_keep, n_discard):
    """Generation past the capacity K-shifts the slot's row in place and
    goes on: every one of n_predict tokens arrives, and the head that the
    request (or the engine's default, a quarter of the context) keeps is
    the prompt's."""
    eng = BatchEngine(rt, n_slots=2, capacity=128)
    ids = list(range(10, 25))
    r = Request(sampler=SamplerParams(temp=0.0, logit_bias={2: -101.0}),
                n_keep=n_keep, n_discard=n_discard, **_greedy(ids, 150))
    other = eng.slots[1]
    (toks,) = _serve(eng, [r], start=False)
    assert len(toks) == 150
    assert eng.slots[0].n_shifts > 0 and eng.n_failed == 0
    head = eng.slots[0].tokens
    if n_keep < 0:
        assert head[:len(ids)] == ids
    else:
        assert head[:n_keep] == ids[:n_keep] and head[n_keep] != ids[n_keep]
    assert other.cache_tokens == []


def test_cache_prompt_off_and_cancel(rt):
    """cache_prompt false evaluates the whole prompt again; a cancelled
    request ends at its next token and frees its slot."""
    eng = BatchEngine(rt, n_slots=1, capacity=256)
    ids = rt.tokenizer.encode("and the rest of it is")
    greedy = SamplerParams(temp=0.0)
    a = _serve(eng, [Request(sampler=greedy, **_greedy(ids, 6))], start=False)
    b = _serve(eng, [Request(sampler=greedy, cache_prompt=False, **_greedy(ids, 6))],
               start=False)
    assert a == b and eng.n_prompt_tokens_cached == 0
    assert eng.n_prompt_tokens_processed == 2 * len(ids)
    c = _serve(eng, [Request(sampler=greedy, cancelled=True, **_greedy(ids, 50))],
               start=False)
    assert c == [a[0][:1]] and eng.slots[0].state == SlotState.IDLE


def test_cache_rows_are_views(rt):
    kv = rt.new_cache(3, 64)
    row = cache_rows(kv, 1, 2)
    row.k[0, 1, 5] = 7.0
    assert float(kv.k[0, 2, 5].float().mean()) == 7.0
    assert row.k[0].is_contiguous()


def test_ram_prompt_cache_tier(rt):
    eng = BatchEngine(rt, n_slots=1, capacity=128, cache_ram_mib=64)
    greedy = SamplerParams(temp=0.0)
    a, b = list(range(10, 40)), list(range(60, 90))
    (a1,) = _serve(eng, [Request(sampler=greedy, **_greedy(a, 4))], start=False)
    _serve(eng, [Request(sampler=greedy, **_greedy(b, 4))], start=False)
    assert eng.prompt_cache.entries
    cached = eng.n_prompt_tokens_cached
    (a2,) = _serve(eng, [Request(sampler=greedy, **_greedy(a, 4))], start=False)
    assert eng.prompt_cache.n_hits >= 1 and eng.n_prompt_tokens_cached > cached
    assert a1 == a2 and "prompt_cache_ram_hits" in eng.metrics_text()


def test_host_prompt_cache_eviction():
    hpc = HostPromptCache(limit_mib=1)
    big = np.zeros((600 * 1024,), np.uint8)
    hpc.save([1, 2, 3], {"k": big})
    hpc.save([4, 5, 6], {"k": big.copy()})
    assert [e["tokens"] for e in hpc.entries] == [[4, 5, 6]]
    assert hpc.best_match([9, 9, 9]) == (None, 0)


def test_partial_stop_holdback_fn():
    assert _partial_stop_holdback("hello wor", ["world"]) == 3
    assert _partial_stop_holdback("hello w", ["world", "wx"]) == 1
    assert _partial_stop_holdback("abc", ["abc"]) == 0
    assert _partial_stop_holdback("x", [""]) == 0


def test_stream_holds_back_a_partial_stop(rt):
    """A stop string that spans tokens never reaches the stream: the
    streamed text is the text before it."""
    ids = rt.tokenizer.encode("the quick brown fox")
    eng = BatchEngine(rt, n_slots=1, capacity=128)
    r0 = Request(sampler=SamplerParams(temp=0.0), **_greedy(ids, 10))
    _serve(eng, [r0], start=False)
    text0 = rt.detokenize(eng.slots[0].tokens[len(ids):])
    assert len(text0) >= 6
    stop = text0[2:6]
    r1 = Request(sampler=SamplerParams(temp=0.0), stop=[stop], **_greedy(ids, 10))
    r1.stream_queue = queue.Queue()
    eng.submit(r1)
    while eng.step():
        pass
    streamed = ""
    while not r1.stream_queue.empty():
        _, piece, _ = r1.stream_queue.get()
        streamed += piece
        assert stop not in streamed
    assert streamed == text0[:2]


def test_topk_readback_decode_parity(rt):
    """The top-k readback decode gives the full-logits path's tokens at the
    same seed (a dummy logit_bias forces the full path)."""
    ids = list(range(30, 50))
    kw = dict(temp=0.9, top_k=40, top_p=0.95, min_p=0.05, penalty_repeat=1.2)
    eng = BatchEngine(rt, n_slots=1, capacity=128)
    (a,) = _serve(eng, [Request(sampler=SamplerParams(**kw), seed=11, **_greedy(ids, 12))],
                  start=False)
    steps = eng.n_topk_steps
    assert steps > 0
    (b,) = _serve(eng, [Request(sampler=SamplerParams(**kw, logit_bias={0: 0.0}), seed=11,
                                **_greedy(ids, 12))], start=False)
    assert a == b and eng.n_topk_steps == steps


def test_failed_request_does_not_stop_the_engine(rt):
    """A request whose forward raises (a token id past the vocabulary) and
    one whose grammar dead-ends fail with their error text; the engine
    thread goes on serving and counts them."""
    eng = BatchEngine(rt, n_slots=2, capacity=128)
    eng.start()
    try:
        bad = Request(prompt_ids=[1, rt.cfg.n_vocab + 5], n_predict=4,
                      sampler=SamplerParams(temp=0.0), stream_queue=queue.Queue())
        eng.submit(bad)
        assert _drain(bad.stream_queue) == ([], "")
        assert bad.error and "Error" in bad.error
        dead = Request(prompt_ids=[1, 10, 11], n_predict=4, grammar='root ::= "\\uffff"',
                       sampler=SamplerParams(temp=0.0), stream_queue=queue.Queue())
        eng.submit(dead)
        _drain(dead.stream_queue)
        assert dead.error.startswith("grammar")
        good = Request(prompt_ids=rt.tokenizer.encode("Hello world"), n_predict=3,
                       sampler=SamplerParams(temp=0.0), stream_queue=queue.Queue())
        eng.submit(good)
        assert len(_drain(good.stream_queue)[0]) == 3 and good.error is None
        assert eng.alive and eng.n_failed == 2
        assert "llamacpp:requests_failed_total 2" in eng.metrics_text()
    finally:
        eng.stop()


def test_many_client_threads(rt):
    """Twelve client threads submit at once, with a short switch interval,
    into a two-slot engine: every request completes with its tokens, and
    the counters hold every request and token."""
    import sys
    import threading
    eng = BatchEngine(rt, n_slots=2, capacity=128)
    eng.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    out = {}

    def client(i):
        r = Request(prompt_ids=[1, 10 + i, 20 + i], n_predict=4,
                    sampler=SamplerParams(temp=0.0), stream_queue=queue.Queue())
        eng.submit(r)
        out[i] = _drain(r.stream_queue)[0]

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert sorted(out) == list(range(12)) and all(len(v) == 4 for v in out.values())
    assert eng.n_requests == 12 and eng.n_tokens_predicted == 48 and eng.n_failed == 0
    assert out[3] == _fresh(rt, [1, 13, 23], 4)


@pytest.fixture(scope="module")
def jeng(model):
    """One JAX engine for the option cases (its jits compile once)."""
    e = JEngine(JRuntime.from_gguf(model), n_slots=1, capacity=128)
    e.start()
    yield e
    e.stop()


@pytest.mark.parametrize("kw", [
    dict(allow_rules=[[(0, 127, "latin", 0.0)]]), dict(expiring_logit_bias='(8 : "e" : 5.0)\n'),
    dict(grammar="a+", grammar_kind="regex"),
    dict(grammar="root ::= [a-z]+", grammar_lazy=True, grammar_triggers=["e"]),
    dict(banned_strings=["e"]), dict(reasoning_budget=0),
    dict(post_sampling_probs=True, n_probs=2)])
def test_later_slices_raise(jeng, rt, kw):
    """The request options of the server-extras slice, refused before it,
    are taken: the port engine's greedy tokens, and its post-sampling
    probabilities within 2e-2, are the JAX engine's on the same request."""
    import copy
    p = rt.tokenizer.encode("Hello world")
    reqs = [R(prompt_ids=p, n_predict=10, sampler=P(temp=0.0), cache_prompt=False,
              stream_queue=queue.Queue(), **copy.deepcopy(kw))
            for R, P in ((JRequest, JParams), (Request, SamplerParams))]
    jeng.submit(reqs[0])
    want = _drain(reqs[0].stream_queue)
    eng = BatchEngine(rt, n_slots=1, capacity=128)
    got = _serve(eng, [reqs[1]])[0]
    assert got == want[0] and eng.n_failed == 0 and eng.n_requests == 1
    for t, j in zip(reqs[1].probs_out, reqs[0].probs_out):
        assert t["id"] == j["id"] and [i for i, _ in t["top"]] == [i for i, _ in j["top"]]
        np.testing.assert_allclose([x for _, x in t["top"]], [x for _, x in j["top"]], atol=2e-2)


def test_later_engine_options_raise(rt, tmp_path):
    """DFlash drafting stays a later slice; slot save, once refused, writes
    the slot's state file (nothing cached yet: no tokens)."""
    with pytest.raises(NotImplementedError, match="DFlash"):
        BatchEngine(rt, n_slots=1, capacity=64, spec="dflash:draft.gguf")
    eng = BatchEngine(rt, n_slots=1, capacity=64)
    out = eng.save_slot(0, str(tmp_path / "slot0.bin"))
    assert out["n_saved"] == 0 and (tmp_path / "slot0.bin").stat().st_size == out["n_written"]
