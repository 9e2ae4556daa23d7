"""Speculative drafting in the port's BatchEngine and server on the CPU.

With every stage (``spec``) the engine serves four greedy requests on four
slots with the JAX engine's tokens and draft counters, on
``make_tiny_llama_gguf(seed=4)``, on the full-logits and on the top-k
readback path. The JAX engine keeps a slot's drafter from one request to
the next and across a context shift; the port drops it, which the tests of
two requests on one slot and of a context shift hold to the engine's
tokens without spec. The ``/metrics`` lines
and the server's ``--spec`` / ``--spec-n`` flags follow the JAX server.

On a recurrent model the JAX engine cannot be the reference: it folds a
bucket's padding and idle rows' junk into the recurrent state (confirmed in
``test_torch_qwen3next_engine.py``). The port's slots, each wrong at a set
draft position so that every round accepts in part, are held to the port's
plain greedy tokens and their states to the JAX runtime's evaluation of
the slot's cached tokens."""
import queue

import numpy as np
import pytest

import fixtures as F
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
from ik_llama_cpp_tpu.server.engine import BatchEngine as JEngine, Request as JRequest
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server import app
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request, SlotState

TEXTS = ["the cat sat on the mat. the cat sat on the mat. the cat",
         "abc abc abc abc abc",
         "a b c d. a b c d. a b c d. a b",
         "one two three four. one two three four. one two three"]
STAGES = ["ngram", "suffix", "ngram-mod", "ngram-cache", "eagle3"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return F.make_tiny_llama_gguf(tmp_path_factory.mktemp("speceng") / "m.gguf", seed=4)


@pytest.fixture(scope="module")
def rts(model):
    return JRuntime.from_gguf(model), Runtime.from_gguf(model, device="cpu")


def _drain(q, timeout=300):
    toks = []
    while True:
        tok, _, done = q.get(timeout=timeout)
        if tok >= 0:
            toks.append(tok)
        if done:
            return toks


def _serve(eng, reqs, threaded=True):
    for r in reqs:
        r.stream_queue = queue.Queue()
        eng.submit(r)
    if threaded:
        eng.start()
        try:
            return [_drain(r.stream_queue) for r in reqs]
        finally:
            eng.stop()
    while eng.step():
        pass
    return [_drain(r.stream_queue, timeout=0) for r in reqs]


@pytest.mark.parametrize("topk", [False, True], ids=["logits", "topk"])
def test_every_stage_equals_jax_engine(rts, topk):
    """Tokens per request and the draft counters are the JAX engine's; the
    speculative tokens are the engine's tokens without spec."""
    jr, tr = rts
    prompts = [tr._ids(t) for t in TEXTS]
    sp = dict(temp=0.0, top_k=40 if topk else 0)
    plain = _serve(BatchEngine(tr, n_slots=4, capacity=256),
                   [Request(prompt_ids=p, n_predict=20, sampler=SamplerParams(**sp))
                    for p in prompts], threaded=False)
    accepted = {}
    for spec in STAGES:
        je = JEngine(jr, n_slots=4, capacity=256, spec=spec, spec_n=4)
        want = _serve(je, [JRequest(prompt_ids=p, n_predict=20, sampler=JParams(**sp))
                           for p in prompts])
        te = BatchEngine(tr, n_slots=4, capacity=256, spec=spec, spec_n=4)
        got = _serve(te, [Request(prompt_ids=p, n_predict=20, sampler=SamplerParams(**sp))
                          for p in prompts], threaded=False)
        assert got == want == plain, spec
        assert (te.n_draft_proposed, te.n_draft_accepted) == (
            je.n_draft_proposed, je.n_draft_accepted), spec
        assert (te.n_topk_steps > 0) == topk
        assert (te.n_spec_steps > 0) == (te.n_draft_proposed > 0) == (spec != "eagle3")
        accepted[spec] = te.n_draft_accepted
    # ngram-mod's table fills in chunks of 32 tokens: these short prompts
    # give it few proposals, which the model does not take
    assert all(accepted[s] > 0 for s in ("ngram", "suffix", "ngram-cache")), accepted


def test_metrics_lines(rts):
    _, tr = rts
    eng = BatchEngine(tr, n_slots=2, capacity=256, spec="ngram", spec_n=4)
    _serve(eng, [Request(prompt_ids=tr._ids(TEXTS[2]), n_predict=16,
                         sampler=SamplerParams(temp=0.0))], threaded=False)
    text = eng.metrics_text()
    assert "# TYPE llamacpp:draft_tokens_total counter" in text
    assert f"llamacpp:draft_tokens_total {eng.n_draft_proposed}\n" in text
    assert "# TYPE llamacpp:draft_tokens_accepted_total counter" in text
    assert f"llamacpp:draft_tokens_accepted_total {eng.n_draft_accepted}\n" in text
    assert eng.n_draft_accepted > 0


def test_spec_flags_are_parsed_and_reach_the_engine(rts, monkeypatch):
    """--spec / --spec-n as the JAX server has them; main() hands them to
    BatchEngine (the HTTP layer is stubbed out)."""
    args = app.parse_args(["--gguf", "m.gguf", "--spec", "suffix", "--spec-n", "6"])
    assert (args.spec, args.spec_n) == ("suffix", 6)
    args = app.parse_args(["--gguf", "m.gguf"])
    assert (args.spec, args.spec_n) == (None, 8)
    _, tr = rts
    made = {}

    class Web:
        @staticmethod
        def run_app(*a, **k):
            made["served"] = True

    class Engine(BatchEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made["engine"] = self

        def start(self):
            pass

    monkeypatch.setattr(app, "_aiohttp_web", lambda: Web)
    monkeypatch.setattr(app, "make_app", lambda srv: None)
    monkeypatch.setattr(app, "BatchEngine", Engine)
    monkeypatch.setattr(app.Runtime, "from_gguf", classmethod(lambda cls, *a, **k: tr))
    app.main(["--gguf", "m.gguf", "--device", "cpu", "--parallel", "2",
              "--spec", "ngram-cache", "--spec-n", "5"])
    eng = made["engine"]
    assert made["served"] and (eng.spec, eng.spec_n, eng.n_slots) == ("ngram-cache", 5, 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        app.main(["--gguf", "m.gguf", "--device", "cpu", "--spec", "dflash:d.gguf"])


def test_near_capacity_slot_decodes_without_drafts(rts):
    """A slot within spec_n + 2 rows of the capacity takes plain decode
    steps (the JAX rule), so a verify block never writes past the cache."""
    _, tr = rts
    eng = BatchEngine(tr, n_slots=1, capacity=64, spec="ngram", spec_n=8)
    p = tr._ids(TEXTS[2])[:40]
    got = _serve(eng, [Request(prompt_ids=p, n_predict=30, sampler=SamplerParams(temp=0.0))],
                 threaded=False)
    want = _serve(BatchEngine(tr, n_slots=1, capacity=64),
                  [Request(prompt_ids=p, n_predict=30, sampler=SamplerParams(temp=0.0))],
                  threaded=False)
    assert got == want and eng.n_spec_steps > 0 and eng.n_decode_steps > eng.n_spec_steps


def test_suffix_drafter_is_dropped_between_requests(rts):
    """Two requests in sequence on one slot, the second's prompt shorter
    than the first's tokens and ending on a token that the first held late:
    a drafter kept from the first request would look up positions past the
    second's end. Each request gets the tokens of the engine without spec."""
    _, tr = rts
    prompts = [[5, 6, 7, 8] * 10, [5, 6, 7, 8] * 2]

    def serve(spec):
        eng = BatchEngine(tr, n_slots=1, capacity=256, spec=spec, spec_n=4)
        return eng, [_serve(eng, [Request(prompt_ids=p, n_predict=12,
                                          sampler=SamplerParams(temp=0.0))],
                            threaded=False)[0] for p in prompts]

    eng, got = serve("suffix")
    _, want = serve(None)
    assert got == want and eng.n_failed == 0 and eng.n_spec_steps > 0


def test_suffix_drafter_is_dropped_at_a_context_shift(rts):
    """One slot decodes past its capacity with spec="suffix": after the
    context shift the slot's token list is shorter, and drafting resumes
    with a new drafter. The tokens are the engine's without spec, which
    shifts at the same step."""
    _, tr = rts
    p = tr._ids(TEXTS[2])[:30]

    def serve(spec):
        eng = BatchEngine(tr, n_slots=1, capacity=64, spec=spec, spec_n=4)
        got = _serve(eng, [Request(prompt_ids=p, n_predict=60,
                                   sampler=SamplerParams(temp=0.0))], threaded=False)
        return eng, got

    eng, got = serve("suffix")
    base, want = serve(None)
    assert got == want and len(got[0]) == 60 and eng.n_failed == 0
    assert eng.slots[0].n_shifts == base.slots[0].n_shifts > 0
    assert eng.n_spec_steps > 0


# ------------------------------------------------------------ recurrent
class WrongAt:
    """The slot's known continuation with the token at ``at`` of every
    proposal changed."""

    def __init__(self, prompt_len, cont, at=2):
        self.n0, self.cont, self.at = prompt_len, cont, at

    def propose(self, tokens, n):
        d = list(self.cont[len(tokens) - self.n0:][:n])
        if len(d) > self.at:
            d[self.at] = (d[self.at] + 1) % 250
        return d


def test_recurrent_partial_acceptance_state(tmp_path):
    """Three slots of the qwen3next fixture with drafts wrong at their third
    token: each request gives its plain greedy tokens; after the engine
    drains, each slot's conv tail and delta state are a fresh evaluation's
    of its cached tokens in the port (to 1e-6 of the largest value: a
    replay re-runs the accepted prefix as its own chunk) and the JAX
    runtime's (to 2^-5; the JAX runtime under jit rounds its residual
    stream at other points)."""
    path = F.make_tiny_qwen3next_gguf(tmp_path / "q.gguf", seed=3)
    tr = Runtime.from_gguf(path, device="cpu")
    jr = JRuntime.from_gguf(path)
    prompts = [[int(x) for x in np.random.default_rng(s).integers(3, 250, 9 + 5 * s)]
               for s in range(3)]
    plains = [tr.generate(p, 10, stop_at_eos=False)[1] for p in prompts]
    eng = BatchEngine(tr, n_slots=3, capacity=128, spec="ngram", spec_n=4)
    for s, p, pl in zip(eng.slots, prompts, plains):
        s.drafter = WrongAt(len(p), pl)
    got = _serve(eng, [Request(prompt_ids=p, n_predict=10, sampler=SamplerParams(temp=0.0))
                       for p in prompts], threaded=False)
    assert got == plains
    assert 0 < eng.n_draft_accepted < eng.n_draft_proposed
    for s, p, pl in zip(eng.slots, prompts, plains):
        assert s.state == SlotState.IDLE and s.cache_tokens == (p + pl)[:len(p) + 9]
        _, ref, _ = tr.eval_tokens(s.cache_tokens, tr.new_cache(1, 128), 0)
        _, jkv, _ = jr.eval_tokens(s.cache_tokens, jr.new_cache(1, 128), 0)
        for f in ("state", "conv"):
            mine = getattr(eng.kv, f)[:, s.idx]
            want = getattr(ref, f)[:, 0]
            assert (mine - want).abs().max() <= 1e-6 * want.abs().max(), (s.idx, f)
            j = np.asarray(getattr(jkv, f))[:, 0]
            assert np.abs(mine.numpy() - j).max() <= 2.0 ** -5 * np.abs(j).max(), (s.idx, f)
