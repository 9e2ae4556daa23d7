"""The DeepSeek-2 family (deepseek2, mistral4, glm-dsa) in the port against
the JAX package on the CPU.

The tiny fixtures (2-3 layers, width 64, 4 heads of nope 32 / rope 16 / v
32, kv-lora 32) cover q-lora and the "lite" wq, YaRN rope scaling,
sigmoid and softmax gating with a selection bias, normalized top-k weights, a routed scale,
shared experts, the dense lead, and glm-dsa's pre-split attn_k_b / attn_v_b
with its lightning indexer (top-k 6, so that a 20-token prompt's selection
masks keys). The eager forwards of both packages over a prefill chunk and
4 decode steps agree within 1e-3 of the largest logit, on the latent cache
(mla=True) and the per-head cache (mla=False): the two run the same
operations in the same order, and what differs is float32 sums taken in
another order (observed: 2e-6 at logits of about 17)."""
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import deepseek2 as JD
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import deepseek2 as TD
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.models.convert import kv_from_numpy, params_from_numpy
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from ik_llama_cpp_tpu_torch.runtime.kshift import can_shift
from ik_llama_cpp_tpu_torch.runtime.sampling import SamplerParams
from ik_llama_cpp_tpu_torch.server.engine import BatchEngine, Request, cache_rows
from test_torch_archs import rewrite
from test_torch_moe import _assert_same, _tree

N_PROMPT, STEPS, TOL = 20, 4, 1e-3


def _lite(path):
    """The deepseek2 fixture with its q-lora pair replaced by one wq (the
    DeepSeek-V2-Lite layout)."""
    src = F.make_tiny_deepseek2_gguf(f"{path}.src", seed=7)
    rng = np.random.default_rng(8)
    wq = {f"blk.{i}.attn_q.weight": (rng.standard_normal((4 * 48, 64)) / 8).astype(np.float32)
          for i in range(2)}
    return rewrite(src, path, drop=("attn_q_a", "attn_q_b"), extra=wq)


def _yarn(path):
    """The deepseek2 fixture with DeepSeek-V2-Lite's rope scaling: YaRN,
    factor 40 over 4,096 positions, yarn_log_multiplier 0.0707 (the kq
    scale's mscale^2 and the rope's attention factor)."""
    src = F.make_tiny_deepseek2_gguf(f"{path}.src", seed=10, gating=1)
    return rewrite(src, path, extra_kv={
        "deepseek2.rope.scaling.type": "yarn", "deepseek2.rope.scaling.factor": 40.0,
        "deepseek2.rope.scaling.original_context_length": 4096,
        "deepseek2.rope.scaling.yarn_log_multiplier": 0.0707})


MODELS = {
    "deepseek2_sigmoid": lambda p: F.make_tiny_deepseek2_gguf(p, seed=3),
    "deepseek2_yarn": _yarn,
    "deepseek2_softmax": lambda p: F.make_tiny_deepseek2_gguf(p, seed=4, gating=1),
    "deepseek2_lite": _lite,
    "mistral4": lambda p: F.make_tiny_deepseek2_gguf(p, arch="mistral4", seed=5),
    "glm-dsa": lambda p: F.make_tiny_glmdsa_gguf(p, seed=6),
}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds2")
    return {name: mk(d / f"{name}.gguf") for name, mk in MODELS.items()}


def _loaded(path, mla: bool):
    jg, tg = j_load_gguf(path), t_load_gguf(path)
    jc, tc = j_config(jg.metadata), t_config(tg.metadata)
    return (JD.load_deepseek2_params(jg, jc, mla=mla), jc,
            TD.load_deepseek2_params(tg, tc, "cpu", mla=mla), tc)


def _ids(cfg, n=N_PROMPT + STEPS, seed=0):
    return [int(x) for x in np.random.default_rng(seed).integers(3, min(250, cfg.n_vocab), n)]


def _eager(jp, jc, tp, tc, ids, jkv, tkv):
    """Both eager forwards over ``ids``: the first N_PROMPT as one chunk,
    then one token a step. Returns both (n, V) logits."""
    js, ts, n = [], [], 0
    for chunk in [ids[:N_PROMPT]] + [ids[i:i + 1] for i in range(N_PROMPT, len(ids))]:
        tok = np.asarray(chunk, np.int32)[None]
        jl, jkv = JD.forward(jp, jc, jnp.asarray(tok), jkv, jnp.int32(n))
        ts.append(TD.forward(tp, tc, torch.from_numpy(tok).long(), tkv, n)[0].numpy())
        js.append(np.asarray(jl[0]))
        n += len(chunk)
    return np.concatenate(js), np.concatenate(ts)


@pytest.mark.parametrize("mla", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_loader_matches_jax(ggufs, name, mla):
    """The port's load equals the JAX package's, carried over by
    ``params_from_numpy``: the bf16 absorb projections wk_b / wv_b, the
    fused wkv_b (glm-dsa's rebuilt DenseLinear under mla=False), the
    indexer's unquantized linears and LayerNorm, the dense lead, the
    experts, the selection bias and the shared experts."""
    jp, _, tp, _ = _loaded(ggufs[name], mla)
    _assert_same(params_from_numpy(_tree(jp), "cpu"), tp)
    blk0, blk1 = tp["blocks"][0], tp["blocks"][1]
    assert ("wk_b" in blk0) == (mla or name == "glm-dsa")
    assert ("wkv_b" in blk0) == (not mla)
    assert ("wq" in blk0) == (name == "deepseek2_lite")
    assert ("idx_q_b" in blk0) == (name == "glm-dsa")
    assert "ffn_gate" in blk0 and "experts" in blk1 and "ffn_gate_shexp" in blk1
    assert "exp_probs_b" in blk1


def test_loader_refuses_unknown_block_tensors(tmp_path):
    src = F.make_tiny_deepseek2_gguf(tmp_path / "src.gguf", seed=2)
    path = rewrite(src, tmp_path / "extra.gguf",
                   extra={"blk.1.attn_unknown.weight": np.ones(64, np.float32)})
    tg = t_load_gguf(path)
    with pytest.raises(NotImplementedError, match="attn_unknown"):
        TD.load_deepseek2_params(tg, t_config(tg.metadata), "cpu")


def test_fused_kv_b_beside_the_presplit_pair_is_unread(tmp_path):
    """A glm-dsa file that also carries a fused attn_kv_b loads as the JAX
    loader loads it: the pre-split pair is used and attn_kv_b is not read
    (it is not refused as an unknown tensor)."""
    src = F.make_tiny_glmdsa_gguf(tmp_path / "src.gguf", seed=6)
    rng = np.random.default_rng(9)
    extra = {f"blk.{i}.attn_kv_b.weight": rng.standard_normal((4 * 64, 32)).astype(np.float32)
             for i in range(3)}
    path = rewrite(src, tmp_path / "kvb.gguf", extra=extra)
    for mla in (True, False):
        jp, _, tp, _ = _loaded(path, mla)
        _assert_same(params_from_numpy(_tree(jp), "cpu"), tp)


@pytest.mark.parametrize("mla", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax_eager(ggufs, name, mla):
    """A 20-token chunk and 4 decode steps of one token history: every
    position's logits within TOL of the largest logit, the same argmax, and
    the caches the two forwards wrote equal to bf16 rounding."""
    jp, jc, tp, tc = _loaded(ggufs[name], mla)
    absorb = "wk_b" in tp["blocks"][0]
    jkv = JD.make_cache(jc, 1, 64, mla=absorb)
    tkv = TD.make_cache(tc, 1, 64, "cpu", mla=absorb)
    if absorb and name != "glm-dsa":
        assert tkv.v is None                    # no placeholder to narrow
    jl, tl = _eager(jp, jc, tp, tc, _ids(tc), jkv, tkv)
    scale = float(np.abs(jl).max())
    assert np.isfinite(tl).all()
    assert float(np.abs(tl - jl).max()) <= TOL * scale
    assert (tl.argmax(-1) == jl.argmax(-1)).all()


def test_forward_takes_the_jax_cache(ggufs):
    """A latent cache of the JAX package (its (L, 1, 1, 1, 1) placeholder
    v included) carried over by kv_from_numpy continues the port's decode
    as the port's own cache does."""
    jp, jc, tp, tc = _loaded(ggufs["deepseek2_sigmoid"], True)
    ids = _ids(tc)
    jkv = JD.make_cache(jc, 1, 64)
    _, jkv = JD.forward(jp, jc, jnp.asarray(np.asarray(ids[:N_PROMPT], np.int32)[None]),
                        jkv, jnp.int32(0))
    tkv = kv_from_numpy(np.asarray(jkv.k.astype(jnp.float32)),
                        np.asarray(jkv.v.astype(jnp.float32)), device="cpu")
    own = TD.make_cache(tc, 1, 64, "cpu")
    TD.forward(tp, tc, torch.tensor([ids[:N_PROMPT]]), own, 0)
    tok = torch.tensor([[ids[N_PROMPT]]])
    a = TD.forward(tp, tc, tok, tkv, N_PROMPT)
    b = TD.forward(tp, tc, tok, own, N_PROMPT)
    assert torch.allclose(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_forward_later_arguments_raise(ggufs):
    _, _, tp, tc = _loaded(ggufs["deepseek2_sigmoid"], True)
    kv = TD.make_cache(tc, 1, 16, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="item 9"):
        TD.forward(tp, tc, tok, kv, 0, collect_stats=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        TD.forward(tp, tc, tok, kv, 0, tp_axis="tp")
    with pytest.raises(TypeError):
        TD.forward(tp, tc, tok, kv, 0, bogus=1)


@pytest.mark.parametrize("name,mla", [("deepseek2_sigmoid", True), ("mistral4", True),
                                      ("glm-dsa", True), ("deepseek2_sigmoid", False)])
def test_runtime_greedy_matches_jax(ggufs, name, mla):
    """Runtime.from_gguf loads the latent cache in both packages, and 6
    greedy tokens are the JAX runtime's, on the device loop and on the
    host loop; with both runtimes' parameters reloaded with mla=False,
    over the per-head cache. The JAX runtime runs with jit disabled: its
    jitted forward rounds the bf16 residual stream at other points than
    its own eager forward, and on these random weights that moves a
    near-tied sigmoid routing choice (deepseek2_sigmoid, prompt seed 1:
    one prompt position's logits move by 4.7 at a largest logit of 15
    between jit and eager JAX, while eager JAX and the port agree to 2e-6
    there)."""
    jr = JG.Runtime.from_gguf(ggufs[name])
    tr = TG.Runtime.from_gguf(ggufs[name], device="cpu")
    assert "wk_b" in tr.params["blocks"][0] and "wkv_b" not in tr.params["blocks"][0]
    cfg = tr.cfg
    if mla:
        kv = tr.new_cache(1, 64)
        assert kv.k.shape == (cfg.n_layer, 1, 256, 1, cfg.n_lora_kv + cfg.qk_rope_head_dim)
        assert kv.k.shape == tuple(jr.new_cache(1, 64).k.shape)
        if name == "glm-dsa":
            assert kv.v.shape == (cfg.n_layer, 1, 256, 1, 32)
        else:
            assert kv.v is None
    else:
        jr.params, _, tr.params, _ = _loaded(ggufs[name], False)
        kv = tr.new_cache(1, 64)
        assert kv.k.shape == (cfg.n_layer, 1, 256, cfg.n_head,
                              cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        assert kv.k.shape == tuple(jr.new_cache(1, 64).k.shape)
    ids = _ids(cfg, 23, seed=1)
    with jax.disable_jit():
        _, jt = jr.generate_greedy_on_device(ids, 6, stop_at_eos=False)
    assert tr.generate_greedy_on_device(ids, 6, stop_at_eos=False)[1] == jt
    assert tr.generate(ids, 6, stop_at_eos=False)[1] == jt


def test_kshift_is_refused(ggufs):
    """K-shift stays off for this family (the latent cache has no per-head
    roped keys to re-rotate): can_shift is False, so the server re-prefills
    on a full cache, as the JAX package does."""
    for name in MODELS:
        assert not can_shift(t_config(t_load_gguf(ggufs[name]).metadata)), name


def _drain(q, timeout=120):
    toks = []
    while True:
        tok, _, done = q.get(timeout=timeout)
        if tok >= 0:
            toks.append(tok)
        if done:
            return toks


@pytest.mark.parametrize("name", ["deepseek2_sigmoid", "glm-dsa"])
def test_batch_engine_serves_slot_one(ggufs, name):
    """Two greedy requests on a 2-slot BatchEngine over the latent cache:
    the second runs in slot 1 (a row view of the shared cache, which has no
    placeholder to narrow), and each gives Runtime.generate's tokens."""
    rt = TG.Runtime.from_gguf(ggufs[name], device="cpu")
    eng = BatchEngine(rt, n_slots=2, capacity=128)
    assert cache_rows(eng.kv, 1).k.shape[1] == 1
    prompts = [_ids(rt.cfg, 13, seed=2), _ids(rt.cfg, 9, seed=3)]
    reqs = [Request(prompt_ids=p, n_predict=10, sampler=SamplerParams(temp=0.0))
            for p in prompts]
    qs = []
    for r in reqs:
        r.stream_queue = queue.Queue()
        eng.submit(r)
        qs.append(r.stream_queue)
    while eng.step():
        pass
    got = [_drain(q, timeout=0) for q in qs]
    assert eng.slots[1].cache_tokens[:len(prompts[1])] == prompts[1]
    for p, toks in zip(prompts, got):
        assert toks == rt.generate(p, 10)[1]
