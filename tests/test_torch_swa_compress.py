"""--swa-compress ring caches in the port against the JAX package on the
CPU: the sliding-window layers of a tiny gemma3 (five window layers and a
global one), gemma2 and gpt-oss (sinks) keep a ring of window + 576 rows
rounded up to 128 (640), and a 700-token prompt plus decode steps runs past
the ring's end, so that rows wrap (position p in slot p % 640).

The logits over that history must agree with the JAX ring cache's (the
eager forwards; the rule of test_torch_archs.py, 2% of the largest logit)
and with the port's own full cache (1% of the largest logit: the same
arithmetic over the keys in another order, so the float32 softmax sums
differ in their last bits and the bf16 attention output by an ulp at times,
which the layers carry on; observed 2.4e-3 on gemma3)."""
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime
from test_torch_archs import TOL

N_PROMPT, STEPS, CAPACITY = 700, 6, 900
CASES = {"gemma3": lambda p: F.make_tiny_gemma_gguf(p, version=3, n_layer=6),
         "gemma2": lambda p: F.make_tiny_gemma_gguf(p, version=2),
         "gpt-oss": lambda p: F.make_tiny_gptoss_gguf(p)}


@pytest.fixture(scope="module", params=list(CASES))
def runtimes(request, tmp_path_factory):
    path = CASES[request.param](tmp_path_factory.mktemp("swa") / f"{request.param}.gguf")
    return (JRuntime.from_gguf(path, swa_compress=True),
            TRuntime.from_gguf(path, device="cpu", swa_compress=True))


def _ids(n_vocab: int):
    return [int(x) for x in np.random.default_rng(9).integers(3, min(250, n_vocab),
                                                              N_PROMPT + STEPS)]


def _run(jr, tr, ids, jkv, tkv):
    """The eager JAX forward's and the port's logits over ``ids``: the
    prompt in chunks of at most 512 tokens, then one token a step."""
    import jax.numpy as jnp
    js, ts, n = [], [], 0
    chunks = [ids[i:min(i + 512, N_PROMPT)] for i in range(0, N_PROMPT, 512)]
    chunks += [ids[i:i + 1] for i in range(N_PROMPT, len(ids))]
    for chunk in chunks:
        tok = np.asarray(chunk, np.int32)[None]
        jl, jkv = JLM.forward(jr.params, jr.cfg, jnp.asarray(tok), jkv, jnp.int32(n))
        tl = TLM.forward(tr.params, tr.cfg, torch.from_numpy(tok).long(), tkv, n)
        js.append(np.asarray(jl[0]))
        ts.append(tl[0].numpy())
        n += len(chunk)
    return np.concatenate(js), np.concatenate(ts), tkv


def test_ring_cache_matches_jax_and_the_full_cache(runtimes):
    jr, tr = runtimes
    jkv, tkv = jr.new_cache(1, CAPACITY), tr.new_cache(1, CAPACITY)
    assert isinstance(tkv, TLM.SwaKVCache) and tkv.layer_map == jkv.layer_map
    assert tkv.swa_cap == jkv.swa_cap == 640 < N_PROMPT and tkv.capacity == 1024
    ids = _ids(tr.cfg.n_vocab)
    jl, tl, tkv = _run(jr, tr, ids, jkv, tkv)
    scale = float(np.abs(jl).max())
    assert np.abs(tl - jl).max() <= TOL * scale
    # the port's full cache over the same history
    full = TLM.KVCache.create(tr.cfg, 1, 1024, "cpu")
    _, fl, _ = _run(jr, tr, ids, JLM.KVCache.create(jr.cfg, 1, 1024), full)
    assert np.abs(tl - fl).max() <= 1e-2 * scale
    # the ring layers hold 640 rows, the full layers the capacity
    ring_bytes = sum(t.numel() * t.element_size()
                     for t in (tkv.k_full, tkv.v_full, tkv.k_swa, tkv.v_swa))
    n_swa = sum(m < 0 for m in tkv.layer_map)
    assert ring_bytes == (full.k.numel() * 2 * 2) * (
        (tr.cfg.n_layer - n_swa) + n_swa * 640 / 1024) / tr.cfg.n_layer


def test_runtime_eval_with_ring_matches_full_cache(runtimes):
    """The port's Runtime pads prefill chunks to their bucket; on a ring the
    padded rows land in slots outside every window (the ring's margin
    covers a chunk), so eval_tokens and greedy decoding over the ring give
    the full cache's logits and tokens."""
    _, tr = runtimes
    ids = _ids(tr.cfg.n_vocab)[:N_PROMPT]
    ring = tr.eval_tokens(ids, tr.new_cache(1, CAPACITY), 0, all_logits=True)[0]
    full = tr.eval_tokens(ids, TLM.KVCache.create(tr.cfg, 1, 1024, "cpu"), 0,
                          all_logits=True)[0]
    assert (ring - full).abs().max() <= 1e-2 * full.abs().max()
    _, out = tr.generate_greedy_on_device(ids, 8, capacity=CAPACITY, stop_at_eos=False)
    plain = TRuntime(cfg=tr.cfg, params=tr.params, device=tr.device)
    _, out_full = plain.generate_greedy_on_device(ids, 8, capacity=CAPACITY,
                                                  stop_at_eos=False)
    assert out == out_full


def test_no_ring_where_it_would_not_help(runtimes):
    """As in the JAX runtime: a cache no longer than window + margin + 128
    and a quantized cache stay plain."""
    jr, tr = runtimes
    assert type(tr.new_cache(1, 400)) is TLM.KVCache       # 512 rows: no ring
    assert type(jr.new_cache(1, 400)) is JLM.KVCache
    q8 = TRuntime(cfg=tr.cfg, params=tr.params, device=tr.device, kv_quant="q8",
                  swa_compress=True)
    assert type(q8.new_cache(1, CAPACITY)) is TLM.KVCache


def test_server_refuses_ring_caches(runtimes):
    """The batched server once refused ring caches; it serves them now (the
    name is kept): a BatchEngine over a SwaKVCache (its cache-row views
    take one) answers a 700-token greedy request with the runtime's ring
    tokens. tests/test_torch_ring_engine.py holds its prefix-reuse rule."""
    import queue
    from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
    from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request
    _, tr = runtimes
    eng = BatchEngine(tr, n_slots=2, capacity=CAPACITY)
    assert isinstance(eng.kv, TLM.SwaKVCache)
    ids = _ids(tr.cfg.n_vocab)[:N_PROMPT]
    r = Request(prompt_ids=ids, n_predict=STEPS, sampler=SamplerParams(temp=0.0))
    r.stream_queue = queue.Queue()
    eng.submit(r)
    while eng.step():
        pass
    toks = []
    while True:
        tok, _, done = r.stream_queue.get(timeout=0)
        if tok >= 0:
            toks.append(tok)
        if done:
            break
    assert toks == tr.generate_greedy_on_device(ids, STEPS, capacity=CAPACITY)[1]
