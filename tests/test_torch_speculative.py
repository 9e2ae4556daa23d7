"""The port's speculative decoding (``runtime/speculative.py`` and the
runtime's verify steps) against the JAX package on the CPU.

The drafters are host Python copied from the JAX package: their proposals
equal JAX's exactly on seeded token streams. Each stage of
``generate_speculative`` (and a draft ``Runtime``, and the device loop of
``generate_speculative_device``) gives the JAX package's tokens and
``SpecStats`` on ``make_tiny_llama_gguf(seed=4)``, up to a tie: where the
two packages' greedy tokens part, the JAX logits' top two lie within 2^-5
of the largest logit (one bf16 rounding of the residual stream may reorder
them). The speculative tokens are the port's own plain greedy tokens,
exactly. The recurrent checkpoint runs on the qwen3next fixture with a
drafter that is wrong at a set position of every proposal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.runtime import speculative as JS
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.runtime import speculative as TS
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine

TIE = 2.0 ** -5
PROMPTS = ["the cat sat on the mat. the cat sat on the mat. the cat",
           "one two three four. one two three four. one two three",
           "a b c d. a b c d. a b c d. a b"]
STAGES = ["ngram", "suffix", "ngram-map", "ngram-mod", "ngram-cache", "eagle3"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return F.make_tiny_llama_gguf(tmp_path_factory.mktemp("spec") / "m.gguf", seed=4)


@pytest.fixture(scope="module")
def rts(tiny):
    return JRuntime.from_gguf(tiny), TRuntime.from_gguf(tiny, device="cpu")


def _st(stats):
    """SpecStats of either package as a plain tuple."""
    return stats.n_draft, stats.n_accept, stats.n_rounds


def _agree(jr, ids, jt, tt, js=None, ts=None):
    """The port's tokens (and stats) are JAX's, or the first pick where
    they part is a tie of the JAX logits over the JAX history."""
    if tt == jt:
        assert js is None or _st(ts) == _st(js), (ts, js)
        return
    i = next(i for i, (a, b) in enumerate(zip(jt, tt)) if a != b)
    lg, _, _ = jr.eval_tokens(ids + jt[:i], jr.new_cache(1, len(ids) + i + 8), 0)
    top2 = np.sort(lg[-1])[-2:]
    assert top2[1] - top2[0] <= TIE * np.abs(lg[-1]).max(), (i, jt, tt)


# ------------------------------------------------------------- drafters
def _streams():
    """Seeded token streams with repeats: a small alphabet, a copied span."""
    rng = np.random.default_rng(0)
    out = []
    for vocab, n in ((4, 60), (8, 90), (30, 120)):
        s = [int(x) for x in rng.integers(0, vocab, n)]
        out.append(s[: n // 2] + s[: n // 3] + s[n // 2:])
    return out


@pytest.mark.parametrize("name", ["NgramDraft", "SuffixDraft", "NgramMapDraft",
                                  "NgramModDraft", "NgramCacheDraft", "Eagle3Draft"])
def test_drafter_proposals_equal_jax(name):
    """Each drafter, fed the same growing streams with the same accept
    feedback, proposes exactly what the JAX drafter proposes."""
    kw = {"NgramModDraft": dict(n=3, size=512)}.get(name, {})
    for seq in _streams():
        jd, td = getattr(JS, name)(**kw), getattr(TS, name)(**kw)
        if name == "NgramModDraft":
            jd.begin(seq[:20])
            td.begin(seq[:20])
        for end in range(5, len(seq), 3):
            n_draft = 1 + end % 8
            jp, tp = jd.propose(seq[:end], n_draft), td.propose(seq[:end], n_draft)
            assert tp == jp, (name, end)
            if hasattr(jd, "accept"):
                acc = sum(1 for _ in zip(tp, seq[end:])) % 3
                jd.accept(acc)
                td.accept(acc)
        if name == "NgramCacheDraft":
            jd.feed_dynamic(seq[:30])
            td.feed_dynamic(seq[:30])
            assert td.dyn == jd.dyn and td.propose(seq, 6) == jd.propose(seq, 6)


def test_replay_and_static_tiers_equal_jax():
    seq = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
    assert TS.ReplayDraft(3, seq).propose(seq[:5], 4) == JS.ReplayDraft(3, seq).propose(seq[:5], 4)
    static = {(5, 6): {11: 10, 12: 2}}
    assert (TS.NgramCacheDraft(static_cache=static).propose([1, 2, 5, 6], 2)
            == JS.NgramCacheDraft(static_cache=static).propose([1, 2, 5, 6], 2) == [11])


def test_ngram_mod_prefeed_equals_jax():
    toks = [int(x) for x in np.random.default_rng(3).integers(1, 50, 200)]
    for n, bits in ((4, 10), (3, 12), (2, 6)):
        np.testing.assert_array_equal(TS._ngram_mod_prefeed(toks, n=n, table_bits=bits),
                                      JS._ngram_mod_prefeed(toks, n=n, table_bits=bits))


# --------------------------------------------------------------- stages
@pytest.mark.parametrize("prompt", PROMPTS)
def test_every_stage_equals_jax_and_plain_greedy(rts, prompt):
    """At every stage the tokens are the port's plain greedy tokens, and
    tokens and SpecStats are the JAX package's (up to a tie)."""
    jr, tr = rts
    ids, plain = tr.generate(prompt, 20, stop_at_eos=False)
    _, jplain = jr.generate(prompt, 20, stop_at_eos=False)
    _agree(jr, ids, jplain, plain)
    for stage in STAGES:
        j_ids, jt, js = JS.generate_speculative(jr, prompt, 20, stage=stage, n_draft=4,
                                                stop_at_eos=False)
        t_ids, tt, ts = TS.generate_speculative(tr, prompt, 20, stage=stage, n_draft=4,
                                                stop_at_eos=False)
        assert t_ids == j_ids == ids
        assert tt == plain, stage
        _agree(jr, ids, jt, tt, js, ts)


def test_draft_model_and_replay_stage(rts):
    """A draft Runtime (the model itself: every draft accepted) and a
    ReplayDraft of the greedy continuation: full acceptance, JAX's stats."""
    jr, tr = rts
    prompt = PROMPTS[0]
    ids, plain = tr.generate(prompt, 16, stop_at_eos=False)
    _, jt, js = JS.generate_speculative(jr, prompt, 16, draft=jr, n_draft=4, stop_at_eos=False)
    _, tt, ts = TS.generate_speculative(tr, prompt, 16, draft=tr, n_draft=4, stop_at_eos=False)
    assert tt == plain
    _agree(jr, ids, jt, tt, js, ts)
    assert ts.n_accept == ts.n_draft > 0
    _, tt, ts = TS.generate_speculative(tr, ids, 16, n_draft=5, stop_at_eos=False,
                                        stage=TS.ReplayDraft(len(ids), plain))
    assert tt == plain and ts.accept_rate == 1.0 and ts.n_rounds == 3


def test_sampled_verify_matches_jax(rts):
    """A sampler that is not exactly argmax takes the host loop, which
    samples every position of the read-back logits: the JAX tokens with
    the same seed (top-k 1 keeps the draw away from near-equal logits)."""
    jr, tr = rts
    from ik_llama_cpp_tpu.runtime.sampling import SamplerParams as JParams
    _, jt, js = JS.generate_speculative(jr, PROMPTS[1], 12, stop_at_eos=False, seed=3,
                                        sampler=JParams(temp=0.7, top_k=1, penalty_repeat=1.1))
    _, tt, ts = TS.generate_speculative(tr, PROMPTS[1], 12, stop_at_eos=False, seed=3,
                                        sampler=SamplerParams(temp=0.7, top_k=1,
                                                              penalty_repeat=1.1))
    assert (tt, _st(ts)) == (jt, _st(js))


@pytest.mark.parametrize("kw", [dict(), dict(ngram_n=3, table_bits=12)])
def test_device_loop_ngram_equals_jax(rts, kw):
    """generate_speculative_device with the device ngram table: the JAX
    loop's tokens, stats and table."""
    jr, tr = rts
    prompt = PROMPTS[2]
    ids, plain = tr.generate(prompt, 24, stop_at_eos=False)
    _, jt, js = JS.generate_speculative_device(jr, prompt, 24, n_draft=4, rounds_per_call=3,
                                               capacity=256, stop_at_eos=False, **kw)
    _, tt, ts = TS.generate_speculative_device(tr, prompt, 24, n_draft=4, rounds_per_call=3,
                                               capacity=256, stop_at_eos=False, **kw)
    assert tt == plain
    _agree(jr, ids, jt, tt, js, ts)
    assert ts.n_accept > 0


def test_spec_loop_table_and_counts_equal_jax(rts):
    """One call of each runtime's ngram loop over the same prefilled
    prompt: the emitted buffer, the per-round counts, the table and the
    window are JAX's (the port drives its rounds from the host)."""
    jr, tr = rts
    ids = tr._ids(PROMPTS[2])
    w, rounds, n, bits = 5, 3, 3, 10
    jkv, tkv = jr.new_cache(1, 128), tr.new_cache(1, 128)
    jl, jkv, jn = jr.eval_tokens(ids, jkv, 0)
    tl, tkv, tn = tr.eval_tokens(ids, tkv, 0)
    cur = int(np.argmax(jl[-1]))
    assert cur == int(torch.argmax(tl[-1]))
    seq = ids + [cur]
    table = JS._ngram_mod_prefeed(seq, n=n, table_bits=bits)
    win = np.asarray(seq[-n:], np.int32)
    jbuf, jcs, jtab, jwin, jcur, _, jnp_ = jr._spec_loop(w, rounds, ngram_n=n, table_bits=bits)(
        jr.params, jnp.asarray(table), jnp.asarray(win), jnp.int32(cur), jkv, jnp.int32(jn))
    tbuf, tcs, ttab, twin, tcur, _, tnp = tr._spec_loop(w, rounds, ngram_n=n, table_bits=bits)(
        torch.from_numpy(table.copy()), torch.from_numpy(win.astype(np.int64)), cur, tkv, tn)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tcs.numpy(), np.asarray(jcs))
    np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    assert (tcur, tnp) == (int(jcur), int(jnp_))


def test_device_loop_replay_is_lossless(rts):
    jr, tr = rts
    prompt = PROMPTS[0]
    ids = tr._ids(prompt)
    _, ref, _ = TS.generate_speculative(tr, ids, 40, n_draft=4, stop_at_eos=False,
                                        stage=TS.ReplayDraft(0, []), capacity=256)
    _, jt, js = JS.generate_speculative_device(jr, ids, 24, n_draft=4, rounds_per_call=3,
                                               capacity=256, stop_at_eos=False, replay=ref)
    _, tt, ts = TS.generate_speculative_device(tr, ids, 24, n_draft=4, rounds_per_call=3,
                                               capacity=256, stop_at_eos=False, replay=ref)
    assert tt == ref[:24] and ts.accept_rate == 1.0
    _agree(jr, ids, jt, tt, js, ts)


def test_verify_step_runs_the_block_unpadded(rts):
    """_spec_verify runs T = W (no bucket): W rows written, W argmaxes
    back, each the argmax of eval_tokens' logits at that position."""
    _, tr = rts
    ids = tr._ids(PROMPTS[1])
    kv = tr.new_cache(1, 128)
    _, kv, n = tr.eval_tokens(ids[:-5], kv, 0)
    preds = tr._spec_verify(5)(torch.tensor([ids[-5:]]), kv, n)
    full, _, _ = tr.eval_tokens(ids, tr.new_cache(1, 128), 0, all_logits=True)
    assert preds.shape == (1, 5)
    assert preds[0].tolist() == full[-5:].argmax(-1).tolist()
    with pytest.raises(ValueError):
        tr._spec_verify(4)(torch.tensor([ids[-5:]]), kv, n)


def test_autotune_n_draft(rts):
    _, tr = rts
    best, res = TS.autotune_n_draft(tr, "a b c a b c a b", candidates=(2, 4), n_tokens=8)
    assert best in (2, 4) and set(res) == {2, 4} and all(v > 0 for v in res.values())


def test_later_stages_raise(rts):
    """DFlash drafting waits for its draft model's forward (item 8)."""
    _, tr = rts
    with pytest.raises(NotImplementedError, match="item 8"):
        TS.DFlashDraft("draft.gguf", tr)
    with pytest.raises(NotImplementedError, match="item 8"):
        BatchEngine(tr, n_slots=1, capacity=64, spec="dflash:draft.gguf")
    with pytest.raises(ValueError, match="unknown speculative stage"):
        BatchEngine(tr, n_slots=1, capacity=64, spec="medusa")


# ----------------------------------------------------- recurrent state
class WrongAt:
    """Proposes the known continuation with the token at ``at`` of every
    proposal changed, so that a round accepts ``at`` tokens at most."""

    def __init__(self, prompt_len, cont, at=2):
        self.n0, self.cont, self.at = prompt_len, cont, at

    def propose(self, tokens, n):
        d = list(self.cont[len(tokens) - self.n0:][:n])
        if len(d) > self.at:
            d[self.at] = (d[self.at] + 1) % 250
        return d


@pytest.fixture(scope="module")
def qnext(tmp_path_factory):
    p = F.make_tiny_qwen3next_gguf(tmp_path_factory.mktemp("specq") / "q.gguf", seed=3)
    return JRuntime.from_gguf(p), TRuntime.from_gguf(p, device="cpu")


def test_recurrent_checkpoint_against_jax(qnext):
    """generate_speculative on the hybrid model, every round partially
    accepted: the JAX runtime's tokens and stats up to a tie (its
    pre-verify cache is kept by reference, the port's conv tails and delta
    states by a copy), the port's plain greedy tokens, and after the last
    rollback a state equal to a plain evaluation's of the accepted tokens
    (bit for bit) and to the JAX runtime's evaluation of them within 2^-5
    of its largest value (the JAX runtime under jit rounds its residual
    stream at other points than eager PyTorch)."""
    jr, tr = qnext
    ids = [int(x) for x in np.random.default_rng(1).integers(3, 250, 11)]
    _, plain = tr.generate(ids, 7, stop_at_eos=False)
    _, jt, js = JS.generate_speculative(jr, ids, 7, n_draft=4, stop_at_eos=False,
                                        stage=WrongAt(len(ids), plain))
    _, tt, ts = TS.generate_speculative(tr, ids, 7, n_draft=4, stop_at_eos=False,
                                        stage=WrongAt(len(ids), plain))
    assert tt == plain
    _agree(jr, ids, jt, tt, js, ts)
    assert 0 < ts.n_accept < ts.n_draft
    out, kv, n_past = TS._generate_spec_host(
        tr, ids, 7, draft=None, n_draft=4, sampler=SamplerParams(temp=0.0),
        rng=np.random.default_rng(0), capacity=1024, stop_at_eos=False,
        stats=TS.SpecStats(), drafter=WrongAt(len(ids), plain))
    fed = ids + out[:n_past - len(ids)]
    _, ref, _ = tr.eval_tokens(fed, tr.new_cache(1, 1024), 0)
    assert torch.equal(kv.state, ref.state) and torch.equal(kv.conv, ref.conv)
    _, jkv, _ = jr.eval_tokens(fed, jr.new_cache(1, 1024), 0)
    for f in ("state", "conv"):
        j = np.asarray(getattr(jkv, f))
        assert np.abs(getattr(kv, f).numpy() - j).max() <= TIE * np.abs(j).max(), f


def test_recurrent_greedy_device_loop_is_refused(qnext):
    _, tr = qnext
    with pytest.raises(NotImplementedError, match="recurrent"):
        tr._spec_loop(5, 2)
