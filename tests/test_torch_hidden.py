"""The runtime's hidden-state paths in the port against the JAX package on
the CPU: the llama forward's extra inputs and outputs (``n_valid``,
``inputs_embeds``, ``positions`` with ``block_mask``,
``return_layer_hiddens``), ``Runtime.embed`` / ``layer_hiddens`` on the
llama and mamba families, ``eval_probe``, and the two families whose JAX
forward ignores the hidden-state arguments.

The JAX side runs jitted (its eager forwards take seconds each on the
CPU). Tolerance: TOL, 3% of the largest value, the rule of
test_torch_llama.py's runtime comparison: XLA's fused jit rounds the bf16
residual stream at other points than eager execution (the JAX package
against itself, jit against eager, differs by about 1%), and a float32
difference in the last place can flip one bf16 rounding, which the layers
carry on (the probe block against the eager JAX forward: 0.42%). Where
the port is held to itself the checks are bit for bit, or EXACT_TOL (1e-4)
between its two attention paths."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.runtime import generate as JG
from ik_llama_cpp_tpu.runtime.lookahead import _Layout as JLayout
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.runtime import generate as TG
from ik_llama_cpp_tpu_torch.runtime.lookahead import _Layout

TOL, EXACT_TOL = 3e-2, 1e-4
PROMPT = [int(x) for x in np.random.default_rng(17).integers(3, 250, 21)]


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    path = F.make_tiny_llama_gguf(tmp_path_factory.mktemp("hid") / "l.gguf", seed=6)
    return JG.Runtime.from_gguf(path), TG.Runtime.from_gguf(path, device="cpu")


@pytest.fixture(scope="module")
def mamba(tmp_path_factory):
    path = F.make_tiny_mamba_gguf(tmp_path_factory.mktemp("hid") / "m.gguf", seed=9)
    return JG.Runtime.from_gguf(path), TG.Runtime.from_gguf(path, device="cpu")


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _jit_forward(cfg, flags: tuple):
    return jax.jit(lambda p, t, kv, n, arrs: JLM.forward(p, cfg, t, kv, n, **dict(flags),
                                                         **arrs))


def _both(jr, tr, toks, n_past=0, jkv=None, tkv=None, **kw):
    """The jitted JAX forward and the port's over (1, T) ``toks`` with the
    same extra arguments (numpy arrays and flags); returns both outputs
    and the caches."""
    jkv = JLM.KVCache.create(jr.cfg, 1, 256) if jkv is None else jkv
    tkv = TLM.KVCache.create(tr.cfg, 1, 256, "cpu") if tkv is None else tkv
    flags = tuple(sorted((k, v) for k, v in kw.items() if isinstance(v, bool)))
    arrs = {k: v for k, v in kw.items() if not isinstance(v, bool)}
    jout, jkv = _jit_forward(jr.cfg, flags)(
        jr.params, jnp.asarray(toks, jnp.int32), jkv, jnp.int32(n_past),
        {k: jnp.asarray(v) for k, v in arrs.items()})
    tout = TLM.forward(tr.params, tr.cfg, torch.from_numpy(np.asarray(toks)).long(), tkv,
                       n_past, **dict(flags),
                       **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                          for k, v in arrs.items()})
    return np.asarray(jout), tout.numpy(), jkv, tkv


def test_n_valid_and_layer_hiddens_match_jax(llama):
    """A 16-token chunk with n_valid 11: the logits and every layer's
    output (L, B, T, E) within TOL of the JAX forward's; n_valid changes
    nothing on a plain cache (causal rows past it feed no live row)."""
    jr, tr = llama
    toks = np.asarray(PROMPT[:16])[None]
    jl, tl, _, _ = _both(jr, tr, toks, n_valid=11)
    assert _rel(tl, jl) <= TOL
    plain = TLM.forward(tr.params, tr.cfg, torch.from_numpy(toks).long(),
                        TLM.KVCache.create(tr.cfg, 1, 256, "cpu"), 0)
    np.testing.assert_array_equal(tl, plain.numpy())
    jh, th, _, _ = _both(jr, tr, toks, n_valid=11, return_layer_hiddens=True)
    assert th.shape == (tr.cfg.n_layer, 1, 16, tr.cfg.n_embd)
    assert _rel(th, jh) <= TOL


def test_inputs_embeds_match_jax(llama):
    """Embeddings in place of token ids: the JAX forward's logits within
    TOL; the token embedding's own rows give the token path's logits bit
    for bit."""
    jr, tr = llama
    emb = (np.random.default_rng(2).standard_normal((1, 12, tr.cfg.n_embd)) * 0.5
           ).astype(np.float32)
    jl, tl, _, _ = _both(jr, tr, np.zeros((1, 12), np.int64), inputs_embeds=emb)
    assert _rel(tl, jl) <= TOL
    toks = torch.tensor([PROMPT[:12]])
    via = TLM.forward(tr.params, tr.cfg, toks, TLM.KVCache.create(tr.cfg, 1, 64, "cpu"), 0,
                      inputs_embeds=tr.params["tok_embd"][toks].float())
    ref = TLM.forward(tr.params, tr.cfg, toks, TLM.KVCache.create(tr.cfg, 1, 64, "cpu"), 0)
    assert torch.equal(via, ref)


def test_probe_block_matches_jax(llama):
    """A lookahead probe (W 3, N 3, G 2: 10 rows at explicit positions
    under the lmsys mask) after a 21-token prefix: the logits of every row
    within TOL of the JAX forward's; a probe whose positions are contiguous
    and whose mask is causal gives the plain chunk's logits within
    EXACT_TOL."""
    jr, tr = llama
    lay = _Layout(3, 3, 2)
    assert lay.T == 10 and np.array_equal(lay.mask, JLayout(3, 3, 2).mask)
    _, _, jkv, tkv = _both(jr, tr, np.asarray(PROMPT)[None])
    n = len(PROMPT)
    toks = np.asarray(np.random.default_rng(3).integers(3, 250, lay.T))[None]
    pos = (n + lay.rel_pos)[None].astype(np.int32)
    jl, tl, _, _ = _both(jr, tr, toks, n, jkv, tkv, positions=pos, block_mask=lay.mask)
    assert _rel(tl, jl) <= TOL
    causal = np.tril(np.ones((lay.T, lay.T), bool))
    pos = np.arange(n, n + lay.T, dtype=np.int32)[None]
    probe = TLM.forward(tr.params, tr.cfg, torch.from_numpy(toks).long(), tkv, n,
                        positions=torch.from_numpy(pos), block_mask=torch.from_numpy(causal))
    chunk = TLM.forward(tr.params, tr.cfg, torch.from_numpy(toks).long(), tkv, n)
    assert _rel(probe.numpy(), chunk.numpy()) <= EXACT_TOL


def test_eval_probe_keeps_committed_rows(llama):
    """eval_probe writes its rows from n_past on and leaves the rows below
    bit for bit; its logits are the forward's over the same probe, bit for
    bit (the forward is held to JAX above)."""
    _, tr = llama
    lay = _Layout(4, 3, 2)
    kv = tr.new_cache(1, 64)
    _, kv, n = tr.eval_tokens(PROMPT, kv, 0)
    toks = np.random.default_rng(5).integers(3, 250, lay.T)
    twin = TLM.KVCache(kv.k.clone(), kv.v.clone())
    ref = TLM.forward(tr.params, tr.cfg, torch.from_numpy(toks)[None], twin, n,
                      positions=torch.from_numpy(n + lay.rel_pos),
                      block_mask=torch.from_numpy(lay.mask))[0]
    before = (kv.k.clone(), kv.v.clone())
    got = tr.eval_probe(toks, n + lay.rel_pos, lay.mask, kv, n)
    assert got.shape == (lay.T, tr.cfg.n_vocab) and torch.equal(got, ref)
    for new, old in zip((kv.k, kv.v), before):
        assert torch.equal(new[:, :, :n], old[:, :, :n])
        assert not torch.equal(new[:, :, n:n + lay.T], old[:, :, n:n + lay.T])
    with pytest.raises(ValueError, match="capacity"):
        tr.eval_probe(toks, n + lay.rel_pos, lay.mask, kv, kv.capacity - 4)


@pytest.mark.parametrize("pooling", ["mean", "cls", "last", "none"])
def test_embed_matches_jax_on_llama(llama, pooling):
    """A decoder's embedding: the final-norm states of a 21-token input
    padded to its bucket of 32, pooled, within TOL of the JAX runtime's."""
    jr, tr = llama
    got = tr.embed(PROMPT, pooling)
    assert got.dtype == np.float32 and _rel(got, jr.embed(PROMPT, pooling)) <= TOL


def test_layer_hiddens_match_jax_on_llama_and_mamba(llama, mamba):
    """Every layer's output at each of 21 positions, and the mean-pooled
    embedding, within TOL of the JAX runtime's, on the llama and the mamba
    fixture (mamba's state carries a bf16 flip on, as in
    test_torch_mamba.py, whose FLIP_TOL of 2^-5 TOL covers)."""
    for jr, tr in (llama, mamba):
        got = tr.layer_hiddens(PROMPT)
        assert got.shape == (tr.cfg.n_layer, len(PROMPT), tr.cfg.n_embd)
        assert _rel(got.numpy(), jr.layer_hiddens(PROMPT)) <= TOL, tr.cfg.arch
        assert _rel(tr.embed(PROMPT, "mean"), jr.embed(PROMPT, "mean")) <= TOL, tr.cfg.arch


@pytest.mark.parametrize("family", ["deepseek2", "qwen3next"])
def test_families_whose_jax_forward_ignores_hidden_raise(family, tmp_path):
    """The JAX forwards of the DeepSeek-2 and Qwen3-Next families take
    return_hidden / return_layer_hiddens and return logits; the port raises,
    naming the family, where JAX would hand logits back as states."""
    make = {"deepseek2": F.make_tiny_deepseek2_gguf, "qwen3next": F.make_tiny_qwen3next_gguf}
    tr = TG.Runtime.from_gguf(make[family](tmp_path / "m.gguf"), device="cpu")
    name = "DeepSeek-2" if family == "deepseek2" else "Qwen3-Next"
    with pytest.raises(NotImplementedError, match=name):
        tr.embed([5, 6, 7])
    with pytest.raises(NotImplementedError, match=name):
        tr.layer_hiddens([5, 6, 7])


def test_ring_cache_drops_padded_rows(tmp_path):
    """Under --swa-compress the runtime passes each chunk's live length, as
    the JAX runtime does, and a ring layer drops the padded rows' writes: a
    21-token prompt padded to 32 leaves ring slots 21-31 as they were
    (zero), where the rows were written before n_valid reached the llama
    forward."""
    path = F.make_tiny_gemma_gguf(tmp_path / "g.gguf", version=2)
    tr = TG.Runtime.from_gguf(path, device="cpu", swa_compress=True)
    assert tr.needs_n_valid
    kv = tr.new_cache(1, 900)
    assert isinstance(kv, TLM.SwaKVCache)
    tr.eval_tokens(PROMPT, kv, 0)
    n = len(PROMPT)
    assert kv.k_swa[:, 0, :n].abs().sum() > 0
    assert kv.k_swa[:, 0, n:32].abs().sum() == 0 and kv.v_swa[:, 0, n:32].abs().sum() == 0
