"""The mamba family (selective state-space model) in the port against the JAX
package on the CPU.

The tiny fixture (2 layers, width 64, d_inner 128, d_state 16, conv
kernel 4, dt rank 4, F16 linears) goes through both packages' loaders,
blocks, forwards and runtimes. One block on the JAX block's own inputs
agrees with it within 1e-5 of its largest output and its states within
1e-5 of theirs; the whole forwards, each on its own bf16 residual stream,
within 2^-5 of the largest logit (a bf16 rounding flip of the residual
stream reaches every later position through the state, as in the hybrid
family; see test_torch_qwen3next.py). The port's own rules (chunking,
padding, per-row ``n_valid``, checkpoints, the engine, the speculative
host loop) are held to the port's own plain results."""
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import mamba as JMB
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.ops import layers as JL
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.gguf.writer import GGUFWriter
from ik_llama_cpp_tpu_torch.models import mamba as TMB
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import mamba_from_numpy, params_from_numpy
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.runtime.speculative import ReplayDraft, generate_speculative
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request, cache_rows
from test_torch_archs import rewrite
from test_torch_llama import _assert_same, _numpy_tree

N_PROMPT, STEPS, TOL, FLIP_TOL = 20, 4, 1e-5, 2 ** -5


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return F.make_tiny_mamba_gguf(tmp_path_factory.mktemp("mamba") / "m.gguf", seed=9)


@pytest.fixture(scope="module")
def loaded(gguf):
    jg, tg = j_load_gguf(gguf), t_load_gguf(gguf)
    jc, tc = j_config(jg.metadata), t_config(tg.metadata)
    return JMB.load_mamba_params(jg, jc), jc, TMB.load_mamba_params(tg, tc, "cpu"), tc


@pytest.fixture(scope="module")
def rt(gguf):
    return TG.Runtime.from_gguf(gguf, device="cpu")


def _ids(n, seed=0):
    return [int(x) for x in np.random.default_rng(seed).integers(3, 250, n)]


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max())


def test_config_and_registration(rt):
    """The fixture's config in the port, and mamba registered in the
    runtime: no longer among the architectures still to port, recurrent,
    its cache a MambaCache."""
    cfg = rt.cfg
    assert cfg.arch == "mamba" and cfg.ssm_d_inner == 2 * cfg.n_embd == 128
    assert (cfg.ssm_d_state, cfg.ssm_d_conv, cfg.ssm_dt_rank, cfg.n_layer) == (16, 4, 4, 2)
    assert rt.recurrent and rt.needs_n_valid
    assert "mamba" not in TG.OWN_FORWARD and TG.FORWARDS["mamba"] is TMB.forward
    assert TG.LOADERS["mamba"] is TMB.load_mamba_params
    kv = rt.new_cache(2, 64)
    assert isinstance(kv, TMB.MambaCache) and kv.capacity == 1 << 30
    assert kv.conv.shape == (2, 2, 3, 128) and kv.ssm.shape == (2, 2, 128, 16)
    assert kv.conv.dtype == kv.ssm.dtype == torch.float32


def test_loader_matches_jax(loaded):
    """The port's load equals the JAX package's carried over by
    params_from_numpy: the bf16 embedding, the dense linears, the float32
    conv kernel (d_inner, d_conv), biases, A and D."""
    jp, _, tp, _ = loaded
    _assert_same(params_from_numpy(_numpy_tree(jp), "cpu"), tp)
    assert tp["blocks"][0]["conv1d"].shape == (128, 4)


def test_loader_consumes_every_tensor_and_takes_weight_names(gguf, tmp_path, loaded):
    """A and D load under their ``.weight`` names too, to the same values;
    a block tensor the graph does not apply is refused."""
    _, _, tp, _ = loaded
    src = t_load_gguf(gguf)
    w = GGUFWriter(tmp_path / "w.gguf")
    for key, val in src.metadata.items():
        w.add(key, val)
    for name, info in src.tensors.items():
        if name.endswith((".ssm_a", ".ssm_d")):
            name += ".weight"
        w.add_tensor(name, info.data, shape=info.shape, ggml_type=info.ggml_type)
    w.write()
    tg = t_load_gguf(tmp_path / "w.gguf")
    assert "blk.0.ssm_a.weight" in tg.tensors
    _assert_same(TMB.load_mamba_params(tg, t_config(tg.metadata), "cpu"), tp)
    extra = rewrite(gguf, tmp_path / "x.gguf",
                    extra={"blk.1.ssm_unknown.weight": np.ones(64, np.float32)})
    tg = t_load_gguf(extra)
    with pytest.raises(NotImplementedError, match="ssm_unknown"):
        TMB.load_mamba_params(tg, t_config(tg.metadata), "cpu")


def test_block_matches_jax(loaded):
    """One block over a 13-token chunk (n_valid 11 of it) from nonzero
    states, on the JAX block's inputs: the output within TOL of its largest
    value, the conv tail and the scan state within TOL of theirs."""
    jp, jc, tp, tc = loaded
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((1, 13, 64)) * 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    conv = (rng.standard_normal((1, 3, 128)) * 0.3).astype(np.float32)
    ssm = (rng.standard_normal((1, 128, 16)) * 0.3).astype(np.float32)
    h = JL.rms_norm(xb, jp["blocks"][1]["attn_norm"], jc.rms_eps)
    out, jconv, jssm = JMB._mamba_block(jp["blocks"][1], h, jc, jnp.asarray(conv),
                                        jnp.asarray(ssm), False, n_valid=jnp.int32(11))
    th = torch.from_numpy(np.asarray(h.astype(jnp.float32))).to(torch.bfloat16)
    tconv, tssm = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    tout = TMB._mamba_block(tp["blocks"][1], th, tc, tconv, tssm,
                            TMB._valid_rows([11], 13, tc.ssm_d_conv, "cpu"))
    assert _rel(tout.numpy(), out) <= TOL
    assert _rel(tconv.numpy(), jconv) <= TOL
    assert _rel(tssm.numpy(), jssm) <= TOL


def _eager(jp, jc, tp, tc, ids, jkv, tkv):
    """Both eager forwards over ``ids``: the first N_PROMPT as one chunk,
    then one token a step. Returns both (n, V) logits."""
    js, ts, n = [], [], 0
    for chunk in [ids[:N_PROMPT]] + [ids[i:i + 1] for i in range(N_PROMPT, len(ids))]:
        tok = np.asarray(chunk, np.int32)[None]
        jl, jkv = JMB.forward(jp, jc, jnp.asarray(tok), jkv, jnp.int32(n))
        ts.append(TMB.forward(tp, tc, torch.from_numpy(tok).long(), tkv, n)[0].numpy())
        js.append(np.asarray(jl[0]))
        n += len(chunk)
    return np.concatenate(js), np.concatenate(ts), jkv


def test_forward_matches_jax_eager(loaded):
    """The two whole forwards over a 20-token chunk and 4 decode steps: the
    same argmax at every position, logits within FLIP_TOL of the largest
    logit, and the final states within FLIP_TOL of theirs."""
    jp, jc, tp, tc = loaded
    tkv = TMB.MambaCache.create(tc, 1, 0, "cpu")
    jl, tl, jkv = _eager(jp, jc, tp, tc, _ids(N_PROMPT + STEPS), JMB.MambaCache.create(jc, 1),
                         tkv)
    assert np.isfinite(tl).all()
    assert _rel(tl, jl) <= FLIP_TOL
    assert (tl.argmax(-1) == jl.argmax(-1)).all()
    assert _rel(tkv.ssm.numpy(), jkv.ssm) <= FLIP_TOL
    assert _rel(tkv.conv.numpy(), jkv.conv) <= FLIP_TOL


def test_forward_takes_the_jax_cache(loaded):
    """A MambaCache of the JAX package carried over by mamba_from_numpy
    continues the port's decode as the port's own cache does."""
    jp, jc, tp, tc = loaded
    ids = _ids(N_PROMPT + 1)
    _, jkv = JMB.forward(jp, jc, jnp.asarray(np.asarray(ids[:N_PROMPT], np.int32)[None]),
                         JMB.MambaCache.create(jc, 1), jnp.int32(0))
    tkv = mamba_from_numpy(np.asarray(jkv.conv), np.asarray(jkv.ssm), device="cpu")
    assert tkv.conv.dtype == tkv.ssm.dtype == torch.float32
    own = TMB.MambaCache.create(tc, 1, 0, "cpu")
    TMB.forward(tp, tc, torch.tensor([ids[:N_PROMPT]]), own, 0)
    assert _rel(tkv.ssm.numpy(), own.ssm.numpy()) <= FLIP_TOL
    tok = torch.tensor([ids[N_PROMPT:]])
    a = TMB.forward(tp, tc, tok, tkv, N_PROMPT)
    b = TMB.forward(tp, tc, tok, own, N_PROMPT)
    assert _rel(a.numpy(), b.numpy()) <= FLIP_TOL
    with pytest.raises(TypeError):
        mamba_from_numpy(np.asarray(jkv.conv), np.asarray(jkv.ssm))


def test_chunked_equals_one_shot(loaded):
    """A 30-token prompt in chunks of 8, 16 and 6 (the conv tail and the
    state carried across chunks) gives the one-chunk logits and states,
    within 1e-5 of their largest value."""
    _, _, tp, tc = loaded
    ids = _ids(30, seed=2)
    one = TMB.MambaCache.create(tc, 1, 0, "cpu")
    lo = TMB.forward(tp, tc, torch.tensor([ids]), one, 0)[0]
    many = TMB.MambaCache.create(tc, 1, 0, "cpu")
    parts, n = [], 0
    for m in (8, 16, 6):
        parts.append(TMB.forward(tp, tc, torch.tensor([ids[n:n + m]]), many, n)[0])
        n += m
    assert _rel(torch.cat(parts).numpy(), lo.numpy()) <= 1e-5
    for f in ("conv", "ssm"):
        assert _rel(getattr(many, f).numpy(), getattr(one, f).numpy()) <= 1e-5, f


def test_padded_chunk_commits_only_n_valid(loaded):
    """A 13-token chunk padded to 16 with n_valid 13: the padding never
    reaches the conv tail or the scan state (bit for bit the same whatever
    the padded tokens are), and both are the unpadded chunk's (bit for bit
    on the card, where phase 22 checks it; on the CPU within 1e-6 of their
    largest value, as a vectorized loop of another length rounds its tail
    elements its own way). Without n_valid the padding reaches the state."""
    _, _, tp, tc = loaded
    ids = _ids(13, seed=1)
    caches = [TMB.MambaCache.create(tc, 1, 0, "cpu") for _ in range(4)]
    la = TMB.forward(tp, tc, torch.tensor([ids]), caches[0], 0)
    lb = TMB.forward(tp, tc, torch.tensor([ids + [7, 9, 11]]), caches[1], 0, n_valid=13)
    TMB.forward(tp, tc, torch.tensor([ids + [0, 0, 0]]), caches[2], 0, n_valid=13)
    TMB.forward(tp, tc, torch.tensor([ids + [7, 9, 11]]), caches[3], 0)
    a, b, c, d = caches
    assert torch.equal(b.conv, c.conv) and torch.equal(b.ssm, c.ssm)
    for f in ("conv", "ssm"):
        assert _rel(getattr(b, f).numpy(), getattr(a, f).numpy()) <= 1e-6, f
    assert _rel(lb[0, :13].numpy(), la[0].numpy()) <= 1e-5
    assert _rel(d.ssm.numpy(), a.ssm.numpy()) > 1e-3


def test_rows_with_no_tokens_keep_their_state(loaded):
    """Per-row n_valid (the JAX forward takes one scalar): a B = 2 forward
    with n_valid [5, 0] advances row 0 as a B = 1 forward over its 5 tokens
    does and leaves row 1's conv tail and state bit for bit."""
    _, _, tp, tc = loaded
    kv = TMB.MambaCache.create(tc, 2, 0, "cpu")
    TMB.forward(tp, tc, torch.tensor([_ids(8, 3), _ids(8, 4)]), kv, 0)
    before = (kv.conv[:, 1].clone(), kv.ssm[:, 1].clone())
    one = TMB.MambaCache.create(tc, 1, 0, "cpu")
    TMB.forward(tp, tc, torch.tensor([_ids(8, 3)]), one, 0)
    toks = torch.tensor([_ids(5, 5) + [0, 0, 0], [0] * 8])
    TMB.forward(tp, tc, toks, kv, [8, 8], n_valid=[5, 0])
    TMB.forward(tp, tc, toks[:1, :5], one, 8)
    assert torch.equal(kv.conv[:, 1], before[0]) and torch.equal(kv.ssm[:, 1], before[1])
    assert _rel(kv.ssm[:, 0].numpy(), one.ssm[:, 0].numpy()) <= 1e-5
    with pytest.raises(ValueError, match="n_valid"):
        TMB.forward(tp, tc, toks, kv, 0, n_valid=[9, 0])


def test_zero_row_checkpoint_restore_and_row_views(loaded):
    """zero_row resets one row; restore puts back every row or one; the
    server's row view narrows both tensors with no copy."""
    _, _, tp, tc = loaded
    kv = TMB.MambaCache.create(tc, 3, 0, "cpu")
    TMB.forward(tp, tc, torch.tensor([_ids(6, s) for s in range(3)]), kv, 0)
    ckpt = kv.checkpoint()
    assert ckpt[0].data_ptr() != kv.conv.data_ptr()
    kv.zero_row(1)
    assert not kv.conv[:, 1].any() and not kv.ssm[:, 1].any() and kv.ssm[:, 0].any()
    TMB.forward(tp, tc, torch.tensor([_ids(6, 7)] * 3), kv, 6)
    kv.restore(ckpt, 2)
    assert torch.equal(kv.ssm[:, 2], ckpt[1][:, 2]) and not torch.equal(kv.ssm[:, 0],
                                                                        ckpt[1][:, 0])
    kv.restore(ckpt)
    assert torch.equal(kv.conv, ckpt[0]) and torch.equal(kv.ssm, ckpt[1])
    view = cache_rows(kv, 1, 2)
    assert isinstance(view, TMB.MambaCache)
    for f in ("conv", "ssm"):
        t = getattr(view, f)
        assert t.shape[1] == 2 and t.data_ptr() == getattr(kv, f)[:, 1].data_ptr(), f


def test_hidden_outputs_are_a_later_slice(loaded):
    """The hidden outputs (the name is from when the forward refused them;
    they are ported now): over the same chunk from the same
    state, return_hidden's states give the logits bit for bit through the
    head, the last of return_layer_hiddens' layers gives them through the
    final norm, and all three calls leave the same state bit for bit."""
    _, _, tp, tc = loaded
    tok = torch.tensor([_ids(9, seed=4)])
    outs, states = [], []
    for kw in ({}, {"return_hidden": True}, {"return_layer_hiddens": True}):
        kv = TMB.MambaCache.create(tc, 1, 0, "cpu")
        outs.append(TMB.forward(tp, tc, tok, kv, 0, n_valid=7, **kw))
        states.append((kv.conv, kv.ssm))
    logits, hidden, layers = outs
    assert hidden.shape == (1, 9, 64) and layers.shape == (2, 1, 9, 64)
    assert torch.equal(tp["output"](hidden.to(torch.bfloat16)).float(), logits)
    last = TMB.L.rms_norm(layers[-1].to(torch.bfloat16), tp["output_norm"], tc.rms_eps)
    assert torch.equal(last.float(), hidden)
    for conv, ssm in states[1:]:
        assert torch.equal(conv, states[0][0]) and torch.equal(ssm, states[0][1])


def test_runtime_greedy_matches_jax(gguf, rt):
    """Runtime.from_gguf in both packages: the port's greedy tokens on the
    device loop and the host loop (each token a bucket-padded chunk with
    n_valid) are the same, and they are the JAX runtime's; where they part,
    the first differing pick is a tie within FLIP_TOL of the largest JAX
    logit. The JAX runtime runs with jit disabled, as in
    test_torch_qwen3next.py."""
    jr = JG.Runtime.from_gguf(gguf)
    assert jr.recurrent
    jkv = jr.new_cache(1, 64)
    kv = rt.new_cache(1, 64)
    for f in ("conv", "ssm"):
        assert tuple(getattr(kv, f).shape) == tuple(getattr(jkv, f).shape), f
    ids = _ids(23, seed=1)
    with jax.disable_jit():
        _, jt = jr.generate_greedy_on_device(ids, 6, stop_at_eos=False)
        jl = jr.all_position_logits(ids + jt[:-1], capacity=64)
    tt = rt.generate_greedy_on_device(ids, 6, stop_at_eos=False)[1]
    assert rt.generate(ids, 6, stop_at_eos=False)[1] == tt
    tl = rt.all_position_logits(ids + jt[:-1], capacity=64).numpy()
    assert _rel(tl, jl) <= FLIP_TOL
    picks = slice(len(ids) - 1, None)
    top2 = np.sort(jl[picks], axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= FLIP_TOL * np.abs(jl[picks]).max(-1)
    assert ((tl[picks].argmax(-1) == np.asarray(jt)) | tie).all()
    differ = [i for i, (a, b) in enumerate(zip(tt, jt)) if a != b]
    assert not differ or tie[differ[0]]


def test_runtime_eval_tokens_pads_without_touching_the_state(rt):
    """eval_tokens pads a 13-token prompt with zeros to a 16-token bucket
    and passes n_valid: the state is bit for bit that of the same chunk
    padded with other tokens."""
    ids = _ids(13, seed=6)
    kv = rt.new_cache(1, 64)
    _, kv, n = rt.eval_tokens(ids, kv, 0)
    own = TMB.MambaCache.create(rt.cfg, 1, 0, "cpu")
    TMB.forward(rt.params, rt.cfg, torch.tensor([ids + [5, 6, 7]]), own, 0, n_valid=13)
    assert n == 13 and torch.equal(kv.ssm, own.ssm) and torch.equal(kv.conv, own.conv)


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


def test_two_slot_engine(gguf, rt):
    """A 2-slot engine serves a 600-token prompt (two prefill chunks) and a
    short one that arrives while the first decodes: each gives the port's
    B = 1 greedy tokens; an idle row keeps its state bit for bit through
    the other's steps; after the engine drains each slot's state is a fresh
    port evaluation's of its cached tokens (1e-5 of the largest value) and
    the JAX runtime's (FLIP_TOL). The JAX engine itself is not the
    reference: its decode step folds token 0 into an idle row's recurrent
    state (test_torch_qwen3next_engine.py)."""
    eng = BatchEngine(rt, n_slots=2, capacity=1024)
    long_p, short_p = _ids(600, 1), _ids(30, 2)
    a = _submit(eng, long_p, 6)
    eng.step()
    idle = (eng.kv.conv[:, 1].clone(), eng.kv.ssm[:, 1].clone())
    eng.step()
    assert torch.equal(eng.kv.conv[:, 1], idle[0]) and torch.equal(eng.kv.ssm[:, 1], idle[1])
    b = _submit(eng, short_p, 5)
    while eng.step():
        pass
    got = [_drain(a), _drain(b)]
    assert got == [rt.generate(long_p, 6)[1], rt.generate(short_p, 5)[1]]
    jr = JG.Runtime.from_gguf(gguf)
    for s in eng.slots:
        _, ref, _ = rt.eval_tokens(s.cache_tokens, rt.new_cache(1, 1024), 0)
        _, jkv, _ = jr.eval_tokens(s.cache_tokens, jr.new_cache(1, 1024), 0)
        for f in ("conv", "ssm"):
            mine = getattr(eng.kv, f)[:, s.idx].numpy()
            assert _rel(mine, getattr(ref, f)[:, 0].numpy()) <= 1e-5, (s.idx, f)
            assert _rel(mine, np.asarray(getattr(jkv, f))[:, 0]) <= FLIP_TOL, (s.idx, f)


def test_speculative_host_loop_equals_plain_greedy(rt):
    """generate_speculative on mamba takes the host loop with its
    checkpoint: a replay draft wrong at its third token (partial
    acceptance, so restore runs) and the ngram stage both give plain greedy
    tokens; the device loop is refused."""
    ids = _ids(20, seed=11)
    plain = rt.generate(ids, 12, stop_at_eos=False)[1]

    class WrongAt(ReplayDraft):
        def propose(self, tokens, n):
            d = super().propose(tokens, n)
            if len(d) > 2:
                d[2] = (d[2] + 1) % 250
            return d

    _, out, st = generate_speculative(rt, ids, 12, n_draft=4, stop_at_eos=False,
                                      stage=WrongAt(len(ids), plain))
    assert out == plain and 0 < st.n_accept < st.n_draft
    assert generate_speculative(rt, ids, 12, n_draft=4, stop_at_eos=False)[1] == plain
    with pytest.raises(NotImplementedError, match="recurrent"):
        rt._spec_loop(4, 2)
