"""The batched server engine over the hybrid family's recurrent cache, on the
tiny qwen3next fixture on the CPU.

Every forward of the engine passes ``n_valid``: a row with no token of its
own (an idle slot, a slot between its prompt chunks) keeps its conv tail
and delta state bit for bit. A slot's state is reused only when the new
prompt strictly extends its cached tokens, and is zeroed otherwise and on a
context shift's re-prefill. Each served greedy request is held to a fresh
B = 1 evaluation (``Runtime.generate``). Two behaviours of the JAX engine
that the port does not copy are confirmed here on the same fixture."""
import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.models import qwen3next as JQ
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu.server import engine as JE
from ik_llama_cpp_tpu_torch.models.qwen3next import HybridCache
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request, SlotState, cache_rows


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return F.make_tiny_qwen3next_gguf(tmp_path_factory.mktemp("q3ne") / "q3n.gguf", seed=3)


@pytest.fixture(scope="module")
def rt(gguf):
    return TG.Runtime.from_gguf(gguf, device="cpu")


def _ids(n, seed):
    return [int(x) for x in np.random.default_rng(seed).integers(3, 250, n)]


def _submit(eng, prompt, n_predict):
    r = Request(prompt_ids=prompt, n_predict=n_predict, sampler=SamplerParams(temp=0.0))
    r.stream_queue = queue.Queue()
    eng.submit(r)
    return r


def _drain(r):
    toks = []
    while True:
        tok, _, done = r.stream_queue.get(timeout=0)
        if tok >= 0:
            toks.append(tok)
        if done:
            return toks


def _rows(eng, i):
    return eng.kv.conv[:, i].clone(), eng.kv.state[:, i].clone()


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_cache_rows_narrow_all_four_tensors(rt):
    eng = BatchEngine(rt, n_slots=3, capacity=128)
    assert isinstance(eng.kv, HybridCache)
    view = cache_rows(eng.kv, 1, 2)
    assert isinstance(view, HybridCache)
    for f in ("k", "v", "conv", "state"):
        t = getattr(view, f)
        assert t.shape[1] == 2 and t.data_ptr() == getattr(eng.kv, f)[:, 1].data_ptr(), f


def test_idle_row_is_untouched_by_a_prefill_span_and_decode_steps(rt):
    """Slot 1 serves a one-token request and goes idle after the first
    prefill round, while slots 0 and 2 still prefill 600-token prompts: the
    second round's span covers rows 0-2, and the decode steps every row.
    Slot 1's conv tail and delta state stay bit for bit; slots 0 and 2
    give their B = 1 tokens."""
    eng = BatchEngine(rt, n_slots=3, capacity=1024)
    prompts = [_ids(600, 1), _ids(30, 2), _ids(600, 3)]
    reqs = [_submit(eng, p, n) for p, n in zip(prompts, (6, 1, 6))]
    eng.step()
    assert eng.slots[1].state == SlotState.IDLE
    assert [s.state for s in (eng.slots[0], eng.slots[2])] == [SlotState.PREFILL] * 2
    idle = _rows(eng, 1)
    n_fwd = eng.n_prefill_forwards
    eng.step()
    assert eng.n_prefill_forwards == n_fwd + 1      # one span over rows 0-2
    assert _same(_rows(eng, 1), idle)
    while eng.step():
        pass
    assert eng.n_decode_steps >= 5 and _same(_rows(eng, 1), idle)
    got = [_drain(r) for r in reqs]
    assert got[0] == rt.generate(prompts[0], 6)[1]
    assert got[2] == rt.generate(prompts[2], 6)[1]
    assert len(got[1]) == 1


def test_prompt_interleaved_with_another_slots_decode(rt):
    """A 700-token prompt arrives while slot 0 decodes: its two chunks run
    between slot 0's decode steps, and between them its state sits through
    a decode step at n_valid 0. Both requests give their B = 1 tokens."""
    eng = BatchEngine(rt, n_slots=2, capacity=1024)
    a = _submit(eng, _ids(20, 4), 12)
    for _ in range(3):
        eng.step()
    assert eng.slots[0].state == SlotState.GENERATING
    b = _submit(eng, _ids(700, 5), 6)
    eng.step()                                      # B's first chunk, then a decode
    assert eng.slots[1].state == SlotState.PREFILL and eng.slots[1].n_past == 512
    mid = _rows(eng, 1)
    eng._decode([eng.slots[0]])                     # a decode step of slot 0 alone
    assert _same(_rows(eng, 1), mid)
    while eng.step():
        pass
    assert _drain(a) == rt.generate(_ids(20, 4), 12)[1]
    assert _drain(b) == rt.generate(_ids(700, 5), 6)[1]


def test_prefix_reuse_only_on_strict_extension(rt):
    """A prompt that strictly extends the slot's cached tokens continues
    from its state (those tokens counted as cached); one equal to them, or
    diverging, zeroes the slot's state and prefills from 0. Each gives
    its B = 1 tokens."""
    eng = BatchEngine(rt, n_slots=1, capacity=512)
    p = _ids(40, 6)
    first = _submit(eng, p, 5)
    while eng.step():
        pass
    gen = _drain(first)
    cached = p + gen[:-1]
    assert eng.slots[0].cache_tokens == cached
    for prompt, reused in ((cached + _ids(9, 7), len(cached)), (list(cached), 0),
                           (p[:10] + _ids(20, 8), 0)):
        before = eng.n_prompt_tokens_cached
        r = _submit(eng, prompt, 5)
        eng._admit()
        assert eng.slots[0].n_past == reused
        if not reused:
            assert not eng.kv.conv[:, 0].any() and not eng.kv.state[:, 0].any()
        while eng.step():
            pass
        assert eng.n_prompt_tokens_cached - before == reused
        assert _drain(r) == rt.generate(prompt, 5)[1]


def test_context_shift_re_prefills_from_a_zeroed_state(rt):
    """A request that runs into the cache's end is shifted by re-prefilling
    its kept tokens (K-shift is off for this family) over a zeroed state:
    its tokens before the shift are the B = 1 tokens of its prompt, and
    after it those of the kept tokens."""
    eng = BatchEngine(rt, n_slots=1, capacity=64)
    prompt = _ids(30, 9)
    shifts = []
    shift = eng._context_shift

    def spy(slot):
        done = shift(slot)
        zeroed = not eng.kv.conv[:, slot.idx].any() and not eng.kv.state[:, slot.idx].any()
        shifts.append((list(slot.tokens), slot.n_decoded, done, zeroed))
        return done

    eng._context_shift = spy
    r = _submit(eng, prompt, 40)
    while eng.step():
        pass
    out = _drain(r)
    assert len(out) == 40 and len(shifts) == 1
    kept, n_before, done, zeroed = shifts[0]
    assert not done and zeroed and len(kept) < len(prompt) + n_before
    assert out[:n_before] == rt.generate(prompt, n_before)[1]
    assert out[n_before:] == rt.generate(kept, 40 - n_before)[1]


def test_ram_tier_is_refused(rt):
    with pytest.raises(NotImplementedError, match="item 7"):
        BatchEngine(rt, n_slots=1, capacity=128, cache_ram_mib=64)


# ----------------------------------- behaviours of the JAX engine, confirmed
def test_jax_decode_step_folds_token_0_into_idle_rows(gguf):
    """The JAX engine's decode step gives every row that is not generating
    token 0 at position 0, with no n_valid (``server/engine.py:1001-1005``):
    on the hybrid cache that folds the junk token into an idle slot's
    conv tail and delta state. The port passes n_valid 0 there
    (test_idle_row_is_untouched_by_a_prefill_span_and_decode_steps)."""
    jrt = JG.Runtime.from_gguf(gguf)
    eng = JE.BatchEngine(jrt, n_slots=2, capacity=64)
    toks = np.asarray([_ids(12, 10), _ids(12, 11)], np.int32)
    _, kv = JQ.forward(jrt.params, jrt.cfg, jnp.asarray(toks), eng.kv, jnp.int32(0))
    idle = np.asarray(kv.state[:, 1])
    step = np.asarray([[toks[0, -1]], [0]], np.int32)      # row 1 idle
    _, kv = eng._decode()(jrt.params, jnp.asarray(step), kv, jnp.asarray([12, 0], jnp.int32))
    assert not np.array_equal(np.asarray(kv.state[:, 1]), idle)


def test_jax_prefix_reuse_ignores_the_recurrent_state(gguf):
    """The JAX engine keeps min(prefix, n_prompt - 1) rows whatever the
    model (``server/engine.py:524-548``), so a prompt equal to a slot's
    cached tokens re-feeds its last token into a delta state that has
    already seen it: the logits then differ from a fresh evaluation's. The
    port prefills such a prompt from a zeroed state
    (test_prefix_reuse_only_on_strict_extension)."""
    jrt = JG.Runtime.from_gguf(gguf)
    assert jrt.recurrent
    eng = JE.BatchEngine(jrt, n_slots=1, capacity=64)
    p = _ids(12, 12)
    eng.slots[0].cache_tokens = list(p)
    eng.submit(JE.Request(prompt_ids=list(p), n_predict=2))
    eng._admit()
    assert eng.slots[0].n_past == len(p) - 1
    fresh, kv = JQ.forward(jrt.params, jrt.cfg, jnp.asarray(np.asarray([p], np.int32)),
                           JQ.HybridCache.create(jrt.cfg, 1, 64), jnp.int32(0))
    again, _ = JQ.forward(jrt.params, jrt.cfg, jnp.asarray(np.asarray([p[-1:]], np.int32)),
                          kv, jnp.int32(len(p) - 1))
    fresh, again = np.asarray(fresh[0, -1]), np.asarray(again[0, -1])
    assert float(np.abs(fresh - again).max()) > 0.05 * float(np.abs(fresh).max())
