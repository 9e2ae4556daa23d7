"""The hybrid gated-delta-net family (qwen3next, qwen35, qwen35moe) in the
port against the JAX package on the CPU.

The tiny fixtures (4 layers: 3 delta-net, 1 attention; width 64, 4 / 2
heads of 16, 2 k heads / 4 v heads of 64, conv kernel 4) cover the fused
per-k-head ssm_in with ssm_ba (GQA repeat 0), qwen35's flat attn_qkv +
attn_gate with ssm_beta / ssm_alpha (repeat 1), the gated q, partial NEOX
rope and qwen35's imrope, MoE with a sigmoid-gated shared expert, and a
dense FFN. Over a 20-token chunk and 4 decode steps, each sublayer and the
head of the port, fed the JAX forward's residual stream, agree with the
JAX package's within 1e-3 of their largest value, and the conv tails and
delta states within 1e-5 of theirs; the whole forwards, each on its own
bf16 residual stream, within 2^-5 of the largest logit (a bf16 rounding
flip reaches every later position through the delta state; see
``test_forward_matches_jax_eager``)."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import qwen3next as JQ
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.ops import layers as JL
from ik_llama_cpp_tpu.ops.moe import moe_ffn as j_moe_ffn
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import qwen3next as TQ
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import hybrid_from_numpy, params_from_numpy
from ik_llama_cpp_tpu_torch.ops import layers as TL
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from ik_llama_cpp_tpu_torch.runtime.kshift import can_shift
from test_torch_archs import rewrite
from test_torch_moe import _assert_same, _tree

N_PROMPT, STEPS, TOL, STATE_TOL, FLIP_TOL = 20, 4, 1e-3, 1e-5, 2 ** -5

MODELS = {
    "qwen3next": lambda p: F.make_tiny_qwen3next_gguf(p, seed=3),
    "qwen35": lambda p: F.make_tiny_qwen35_gguf(p, seed=4),
    "qwen35moe": lambda p: F.make_tiny_qwen35_gguf(p, moe=True, seed=5),
}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("q3n")
    return {name: mk(d / f"{name}.gguf") for name, mk in MODELS.items()}


def _loaded(path):
    jg, tg = j_load_gguf(path), t_load_gguf(path)
    jc, tc = j_config(jg.metadata), t_config(tg.metadata)
    return JQ.load_qwen3next_params(jg, jc), jc, TQ.load_qwen3next_params(tg, tc, "cpu"), tc


def _ids(n, seed=0):
    return [int(x) for x in np.random.default_rng(seed).integers(3, 250, n)]


def _np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("name", list(MODELS))
def test_loader_matches_jax(ggufs, name):
    """The port's load equals the JAX package's carried over by
    params_from_numpy: the fused or flat projections, the f32 conv kernel,
    gates and norms, the bf16 routers and beta/alpha, the experts and the
    shared expert (or the dense FFN)."""
    jp, jc, tp, tc = _loaded(ggufs[name])
    _assert_same(params_from_numpy(_tree(jp), "cpu"), tp)
    blk0, blk3 = tp["blocks"][0], tp["blocks"][3]
    assert ("ssm_in" in blk0) == (name == "qwen3next") == ("ssm_ba" in blk0)
    assert ("wqkv_lin" in blk0) == (name != "qwen3next") == ("ssm_beta" in blk0)
    assert blk0["ssm_conv1d"].shape == (2 * 128 + 256, 4)
    assert "wq" in blk3 and "ssm_out" not in blk3
    assert ("experts" in blk0) == (name != "qwen35")


def test_loader_refuses_unknown_block_tensors(tmp_path):
    src = F.make_tiny_qwen3next_gguf(tmp_path / "src.gguf", seed=2)
    path = rewrite(src, tmp_path / "extra.gguf",
                   extra={"blk.1.ssm_unknown.weight": np.ones(64, np.float32)})
    tg = t_load_gguf(path)
    with pytest.raises(NotImplementedError, match="ssm_unknown"):
        TQ.load_qwen3next_params(tg, t_config(tg.metadata), "cpu")


def _jax_ffn(blk, h, cfg):
    """The FFN half of the JAX forward's layer loop (its code, unchanged)."""
    if "experts" not in blk:
        return blk["ffn_down"](JL.glu(blk["ffn_gate"](h), blk["ffn_up"](h),
                                      "silu").astype(jnp.bfloat16))
    b, t, e = h.shape
    y = j_moe_ffn(h.reshape(-1, e), blk["ffn_gate_inp"](h.reshape(-1, e)), blk["experts"],
                  cfg.n_expert_used, norm_topk=True).reshape(b, t, e)
    if "ffn_gate_shexp" in blk:
        sh = blk["ffn_down_shexp"](JL.glu(blk["ffn_gate_shexp"](h), blk["ffn_up_shexp"](h),
                                          "silu").astype(jnp.bfloat16))
        if "ffn_gate_inp_shexp" in blk:
            sh = sh * jax.nn.sigmoid(blk["ffn_gate_inp_shexp"](h))
        y = y + sh
    return y


def _jax_rope(cfg, q_pos):
    """The rope tables of the JAX forward (its code, unchanged)."""
    rope_dims = cfg.rope_dim or cfg.head_dim
    cos, sin = JL.rope_cache(q_pos, rope_dims, cfg.rope_freq_base)
    sections = (cfg.extra or {}).get("rope_sections") or []
    if sum(sections):
        mask = JL.imrope_text_mask(sections, rope_dims)
        cos, sin = jnp.where(mask, cos, 1.0), jnp.where(mask, sin, 0.0)
    return cos, sin


def _teacher_forced(jp, jc, tp, tc, ids):
    """The JAX forward's layer loop over a 20-token chunk and 4 decode
    steps, and at each sublayer the port's counterpart on the same bf16
    residual stream (so that a bf16 rounding flip in one package's stream
    cannot reach the other's). The port's conv tails, delta states and
    attention rows evolve on those inputs in its own cache. Returns the
    largest error a sublayer output and the logits show relative to its
    own largest value, and both caches."""
    jkv = JQ.HybridCache.create(jc, 1, 64)
    tkv = TQ.HybridCache.create(tc, 1, 64, "cpu")
    worst, n = 0.0, 0

    def cmp(j, t):
        nonlocal worst
        ref = np.asarray(j, np.float32)
        worst = max(worst, float(np.abs(t.float().numpy() - ref).max() / np.abs(ref).max()))

    def torch_of(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)

    for chunk in [ids[:N_PROMPT]] + [ids[i:i + 1] for i in range(N_PROMPT, len(ids))]:
        t = len(chunk)
        x = jp["tok_embd"][jnp.asarray(np.asarray(chunk, np.int32)[None])]
        npv = jnp.full((1,), n, jnp.int32)
        q_pos = npv[:, None] + jnp.arange(t, dtype=jnp.int32)[None, :]
        cos, sin = _jax_rope(jc, q_pos)
        tnpv = torch.tensor([n], dtype=torch.int32)
        tcos, tsin = TQ._rope_tables(tc, tnpv[:, None] + torch.arange(t, dtype=torch.int32))
        k_all, v_all, conv_all, st_all = [], [], [], []
        for i, (jb, tb) in enumerate(zip(jp["blocks"], tp["blocks"])):
            h = JL.rms_norm(x, jb["attn_norm"], jc.rms_eps)
            th = TL.rms_norm(torch_of(x), tb["attn_norm"], tc.rms_eps)
            if JQ.is_recurrent(i, JQ._interval(jc)):
                out, conv_i, st_i = JQ._delta_layer(jb, h, jc, jkv.conv[i], jkv.state[i],
                                                    jnp.int32(t))
                k_i, v_i = jkv.k[i], jkv.v[i]
                cmp(out, TQ._delta_layer(tb, th, tc, tkv.conv[i], tkv.state[i],
                                         torch.tensor([t])))
            else:
                out, k_i, v_i = JQ._gated_attention(jb, h, jc, jkv.k[i], jkv.v[i], npv,
                                                    q_pos, cos, sin)
                conv_i, st_i = jkv.conv[i], jkv.state[i]
                cmp(out, TQ._gated_attention(tb, th, tc, tkv.k[i], tkv.v[i], [n], tnpv,
                                             tcos, tsin))
            x = x + out.astype(x.dtype)
            h = JL.rms_norm(x, jb["ffn_norm"], jc.rms_eps)
            ff = _jax_ffn(jb, h, jc)
            cmp(ff, TQ._ffn(tb, TL.rms_norm(torch_of(x), tb["ffn_norm"], tc.rms_eps), tc))
            x = x + ff.astype(x.dtype)
            k_all.append(k_i), v_all.append(v_i), conv_all.append(conv_i), st_all.append(st_i)
        jkv = JQ.HybridCache(*(jnp.stack(a) for a in (k_all, v_all, conv_all, st_all)))
        xf = JL.rms_norm(x, jp["output_norm"], jc.rms_eps)
        cmp(jp["output"](xf), tp["output"](TL.rms_norm(torch_of(x), tp["output_norm"],
                                                       tc.rms_eps)))
        n += t
    return worst, jkv, tkv


@pytest.mark.parametrize("name", list(MODELS))
def test_layers_match_jax(ggufs, name):
    """Every sublayer (delta-net, gated attention, MoE or dense FFN) and
    the head over a 20-token chunk and 4 decode steps, each on the JAX
    forward's own residual stream: within TOL of its largest value; the
    conv tails and delta states within STATE_TOL and the attention rows
    to bf16 rounding."""
    jp, jc, tp, tc = _loaded(ggufs[name])
    worst, jkv, tkv = _teacher_forced(jp, jc, tp, tc, _ids(N_PROMPT + STEPS))
    assert worst <= TOL
    for f in ("conv", "state"):
        ref = _np(getattr(jkv, f))
        got = getattr(tkv, f).numpy()
        assert got.shape == ref.shape and got.dtype == np.float32
        assert float(np.abs(got - ref).max()) <= STATE_TOL * float(np.abs(ref).max()), f
    n = N_PROMPT + STEPS
    for f in ("k", "v"):
        ref = _np(getattr(jkv, f))[:, :, :n]
        got = getattr(tkv, f)[:, :, :n].float().numpy()
        assert float(np.abs(got - ref).max()) <= 2 ** -7 * float(np.abs(ref).max()), f


def _eager(jp, jc, tp, tc, ids, jkv, tkv):
    """Both eager forwards over ``ids``: the first N_PROMPT as one chunk,
    then one token a step. Returns both (n, V) logits."""
    js, ts, n = [], [], 0
    for chunk in [ids[:N_PROMPT]] + [ids[i:i + 1] for i in range(N_PROMPT, len(ids))]:
        tok = np.asarray(chunk, np.int32)[None]
        jl, jkv = JQ.forward(jp, jc, jnp.asarray(tok), jkv, jnp.int32(n))
        ts.append(TQ.forward(tp, tc, torch.from_numpy(tok).long(), tkv, n)[0].numpy())
        js.append(np.asarray(jl[0]))
        n += len(chunk)
    return np.concatenate(js), np.concatenate(ts)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax_eager(ggufs, name):
    """The two whole forwards, each on its own residual stream, over a
    20-token chunk and 4 decode steps: the same argmax at every position
    and logits within FLIP_TOL of the largest logit. The float32 products
    of the two packages differ in their last bits (4.8e-7), which now and
    then rounds one bf16 element of the residual stream the other way
    (2^-8 of it); the delta state carries that into every later position.
    Observed: 4e-4 (qwen3next), 7.8e-3 (qwen35, a flip at position 10 of
    layer 1), 7.2e-3 (qwen35moe) of the largest logit; 0 on the positions
    before a flip."""
    jp, jc, tp, tc = _loaded(ggufs[name])
    jl, tl = _eager(jp, jc, tp, tc, _ids(N_PROMPT + STEPS), JQ.HybridCache.create(jc, 1, 64),
                    TQ.HybridCache.create(tc, 1, 64, "cpu"))
    assert np.isfinite(tl).all()
    assert float(np.abs(tl - jl).max()) <= FLIP_TOL * float(np.abs(jl).max())
    assert (tl.argmax(-1) == jl.argmax(-1)).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_padded_chunk_commits_only_n_valid(ggufs, name):
    """A bucket-padded chunk (13 live tokens of 16) with n_valid 13: the
    padding never reaches the conv tail or the delta state (bit for bit the
    same whatever the padded tokens are), and both are the unpadded
    chunk's. Bit for bit on the card, where every element takes one code
    path; on the CPU within 1e-6 of their largest value (observed: 6e-8),
    because the vectorized softplus of a 13-token chunk computes its last
    elements in the scalar tail loop, which rounds differently."""
    _, _, tp, tc = _loaded(ggufs[name])
    ids = _ids(13, seed=1)
    caches = [TQ.HybridCache.create(tc, 1, 64, "cpu") for _ in range(3)]
    la = TQ.forward(tp, tc, torch.tensor([ids]), caches[0], 0)
    lb = TQ.forward(tp, tc, torch.tensor([ids + [7, 9, 11]]), caches[1], 0, n_valid=13)
    TQ.forward(tp, tc, torch.tensor([ids + [0, 0, 0]]), caches[2], 0, n_valid=13)
    a, b, c = caches
    assert torch.equal(b.conv, c.conv) and torch.equal(b.state, c.state)
    for f in ("conv", "state"):
        x, y = getattr(b, f), getattr(a, f)
        assert torch.allclose(x, y, rtol=0, atol=1e-6 * float(y.abs().max())), f
    assert torch.allclose(la[0], lb[0, :13], rtol=0, atol=1e-5 * float(la.abs().max()))
    # without n_valid the padding reaches the state
    d = TQ.HybridCache.create(tc, 1, 64, "cpu")
    TQ.forward(tp, tc, torch.tensor([ids + [7, 9, 11]]), d, 0)
    assert not torch.allclose(a.state, d.state, rtol=0, atol=1e-3 * float(a.state.abs().max()))


@pytest.mark.parametrize("name", list(MODELS))
def test_chunked_equals_one_shot(ggufs, name):
    """A 30-token prompt in chunks of 8, 16 and 6 (the conv tail and the
    state carried across chunks) gives the one-chunk logits and state."""
    _, _, tp, tc = _loaded(ggufs[name])
    ids = _ids(30, seed=2)
    one = TQ.HybridCache.create(tc, 1, 64, "cpu")
    lo = TQ.forward(tp, tc, torch.tensor([ids]), one, 0)[0]
    many = TQ.HybridCache.create(tc, 1, 64, "cpu")
    parts, n = [], 0
    for m in (8, 16, 6):
        parts.append(TQ.forward(tp, tc, torch.tensor([ids[n:n + m]]), many, n)[0])
        n += m
    scale = float(lo.abs().max())
    assert torch.allclose(torch.cat(parts), lo, rtol=0, atol=1e-5 * scale)
    for f in ("conv", "state"):
        x, y = getattr(many, f), getattr(one, f)
        assert torch.allclose(x, y, rtol=0, atol=1e-5 * float(y.abs().max())), f


def test_rows_with_no_tokens_keep_their_state(ggufs):
    """Per-row n_valid: a B = 2 forward with n_valid [5, 0] advances row 0
    as a B = 1 forward over its 5 tokens does and leaves row 1's conv tail
    and delta state bit for bit."""
    _, _, tp, tc = _loaded(ggufs["qwen3next"])
    kv = TQ.HybridCache.create(tc, 2, 64, "cpu")
    TQ.forward(tp, tc, torch.tensor([_ids(8, 3), _ids(8, 4)]), kv, 0)
    before = (kv.conv[:, 1].clone(), kv.state[:, 1].clone())
    one = TQ.HybridCache.create(tc, 1, 64, "cpu")
    TQ.forward(tp, tc, torch.tensor([_ids(8, 3)]), one, 0)
    toks = torch.tensor([_ids(5, 5) + [0, 0, 0], [0] * 8])
    TQ.forward(tp, tc, toks, kv, [8, 8], n_valid=[5, 0])
    TQ.forward(tp, tc, toks[:1, :5], one, 8)
    assert torch.equal(kv.conv[:, 1], before[0]) and torch.equal(kv.state[:, 1], before[1])
    assert torch.allclose(kv.state[:, 0], one.state[:, 0], rtol=0,
                          atol=1e-5 * float(one.state.abs().max()))
    with pytest.raises(ValueError, match="n_valid"):
        TQ.forward(tp, tc, toks, kv, 0, n_valid=[9, 0])


def test_forward_takes_the_jax_cache(ggufs):
    """A HybridCache of the JAX package carried over by hybrid_from_numpy
    continues the port's decode as the port's own cache does."""
    jp, jc, tp, tc = _loaded(ggufs["qwen3next"])
    ids = _ids(N_PROMPT + 1)
    jkv = JQ.HybridCache.create(jc, 1, 64)
    _, jkv = JQ.forward(jp, jc, jnp.asarray(np.asarray(ids[:N_PROMPT], np.int32)[None]),
                        jkv, jnp.int32(0))
    tkv = hybrid_from_numpy(*(_np(getattr(jkv, f)) for f in ("k", "v", "conv", "state")),
                            device="cpu")
    assert tkv.k.dtype == torch.bfloat16 and tkv.state.dtype == torch.float32
    own = TQ.HybridCache.create(tc, 1, 64, "cpu")
    TQ.forward(tp, tc, torch.tensor([ids[:N_PROMPT]]), own, 0)
    tok = torch.tensor([ids[N_PROMPT:]])
    a = TQ.forward(tp, tc, tok, tkv, N_PROMPT)
    b = TQ.forward(tp, tc, tok, own, N_PROMPT)
    assert torch.allclose(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def _history_logits(fwd, params, cfg, cache, ids, gen):
    """One package's eager forward over the prompt as one chunk and then the
    greedy tokens ``gen`` one at a time: the logits before each pick."""
    out, n = [], 0
    for chunk in [ids] + [[g] for g in gen[:-1]]:
        lg, cache = fwd(params, cfg, np.asarray(chunk, np.int32)[None], cache, n)
        out.append(np.asarray(lg, np.float32)[0, -1])
        n += len(chunk)
    return np.stack(out)


@pytest.mark.parametrize("name", list(MODELS))
def test_runtime_greedy_matches_jax(ggufs, name):
    """Runtime.from_gguf loads each arch in both packages with the same
    cache shapes. The port's greedy tokens on the device loop and on the
    host loop (each token a bucket-padded chunk with n_valid) are the same,
    and they are the JAX runtime's; where they part, the first differing
    pick is a tie: its top two JAX logits lie within FLIP_TOL of the
    largest logit, which one bf16 flip of the residual stream may reorder
    (see test_forward_matches_jax_eager). Over the JAX runtime's own
    history, every pick of the port is the JAX pick but at such ties.
    Observed: qwen3next and qwen35 give the JAX tokens (through gaps of
    0.4-1.8% of the largest logit); qwen35moe's first pick is a 0.09% tie
    (10.3976 against 10.3878) that the two packages break on opposite
    sides, and over the JAX history its other five picks are the JAX ones.
    The JAX runtime runs with jit disabled, as its jitted forward rounds
    its residual stream at other points than its eager forward."""
    jr = JG.Runtime.from_gguf(ggufs[name])
    tr = TG.Runtime.from_gguf(ggufs[name], device="cpu")
    assert tr.recurrent and tr.needs_n_valid and jr.recurrent
    kv, jkv = tr.new_cache(1, 64), jr.new_cache(1, 64)
    for f in ("k", "v", "conv", "state"):
        assert tuple(getattr(kv, f).shape) == tuple(getattr(jkv, f).shape), f
    ids = _ids(23, seed=1)
    with jax.disable_jit():
        _, jt = jr.generate_greedy_on_device(ids, 6, stop_at_eos=False)
    tt = tr.generate_greedy_on_device(ids, 6, stop_at_eos=False)[1]
    assert tr.generate(ids, 6, stop_at_eos=False)[1] == tt

    def j_fwd(p, c, tok, cache, n):
        return JQ.forward(p, c, jnp.asarray(tok), cache, jnp.int32(n))

    def t_fwd(p, c, tok, cache, n):
        return TQ.forward(p, c, torch.from_numpy(tok).long(), cache, n), cache

    jl = _history_logits(j_fwd, jr.params, jr.cfg, jr.new_cache(1, 64), ids, jt)
    tl = _history_logits(t_fwd, tr.params, tr.cfg, tr.new_cache(1, 64), ids, jt)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= FLIP_TOL * np.abs(jl).max(-1)
    assert ((tl.argmax(-1) == np.asarray(jt)) | tie).all()
    differ = [i for i, (a, b) in enumerate(zip(tt, jt)) if a != b]
    assert not differ or tie[differ[0]]


def test_runtime_eval_tokens_pads_without_touching_the_state(ggufs):
    """eval_tokens pads a 13-token prompt with zeros to a 16-token bucket
    and passes n_valid: the state is bit for bit that of the same chunk
    padded with other tokens."""
    tr = TG.Runtime.from_gguf(ggufs["qwen3next"], device="cpu")
    ids = _ids(13, seed=6)
    kv = tr.new_cache(1, 64)
    _, kv, n = tr.eval_tokens(ids, kv, 0)
    own = TQ.HybridCache.create(tr.cfg, 1, kv.capacity, "cpu")
    TQ.forward(tr.params, tr.cfg, torch.tensor([ids + [5, 6, 7]]), own, 0, n_valid=13)
    assert n == 13 and torch.equal(kv.state, own.state) and torch.equal(kv.conv, own.conv)


def test_cache_type_is_logged_and_kshift_refused(ggufs, caplog):
    """A KV cache type has no effect on this family (bf16 rows, float32
    state), as in the JAX runtime, and the port logs it; K-shift stays off,
    so the server re-prefills on a full cache."""
    tr = TG.Runtime.from_gguf(ggufs["qwen35moe"], device="cpu", kv_quant="q8")
    with caplog.at_level(logging.WARNING, logger="ik_llama_cpp_tpu_torch"):
        kv = tr.new_cache(1, 64)
    assert isinstance(kv, TQ.HybridCache) and kv.k.dtype == torch.bfloat16
    assert "no effect" in caplog.text
    tr.kv_quant = {"type": "q4", "first": "q8"}
    assert isinstance(tr.new_cache(1, 64), TQ.HybridCache)
    for name in MODELS:
        assert not can_shift(t_config(t_load_gguf(ggufs[name]).metadata)), name


def test_registered_archs():
    """The three archs run the hybrid forward on its cache; none is left in
    the runtime's list of architectures still to port."""
    for a in TQ.ARCHS:
        assert TG.FORWARDS[a] is TQ.forward and TG.LOADERS[a] is TQ.load_qwen3next_params
        assert a not in TG.OWN_FORWARD and JG.FORWARDS[a] is JQ.forward
