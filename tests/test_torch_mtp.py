"""The NextN/MTP layer of the port against the JAX package on the CPU, on
the glm4moe fixture with one trailing nextn block that the JAX package's
``tests/test_speculative.py`` builds.

``mtp_forward`` takes the same (tokens, hidden) and the same cache through
both packages' eager code: its logits, cache rows and output stream agree
to 1e-5 of their largest values. The forward's hidden outputs and
``eval_tokens_hidden`` are held to the JAX package's within 2^-5 of the
largest value (its jitted forward rounds the bf16 residual stream at other
points than eager PyTorch). ``_generate_mtp`` gives the JAX tokens and
stats, with the MTP layer's own drafts, and with drafts forced to the
greedy continuation so that rounds accept and the cache refresh writes
rows p0-1 .. p0+consumed-2 of several lengths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.models import llama as JL
from ik_llama_cpp_tpu.runtime import speculative as JS
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.models import llama as TL
from ik_llama_cpp_tpu_torch.runtime import speculative as TS
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

TOL = 2.0 ** -5
PROMPT = "one two three one two three"


@pytest.fixture(scope="module")
def rts(tmp_path_factory):
    p = F.make_tiny_moe2_gguf(tmp_path_factory.mktemp("mtp") / "mtp.gguf", arch="glm4moe",
                              seed=7, nextn=1)
    return JRuntime.from_gguf(p), TRuntime.from_gguf(p, device="cpu")


def _close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), np.abs(a - b).max()


def test_mtp_layer_is_loaded(rts):
    jr, tr = rts
    assert jr.has_mtp and tr.has_mtp and tr.cfg.n_layer == jr.cfg.n_layer == 3
    assert set(tr.params["mtp_blocks"][0]) == set(jr.params["mtp_blocks"][0])
    kv = tr.new_mtp_cache(1, 64)
    assert kv.k.shape[0] == 1 and kv.capacity == 256 and kv.device == tr.device


def test_mtp_forward_equals_jax(rts):
    """Logits, the cache rows written at n_past and the output stream of
    one MTP step over 12 (token, hidden) pairs at position 5."""
    jr, tr = rts
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 250, (1, 12)).astype(np.int32)
    hid = rng.standard_normal((1, 12, tr.cfg.n_embd)).astype(np.float32)
    jkv = jr.new_mtp_cache(1, 64)
    jlg, jkv, jh = JL.mtp_forward(jr.params, jr.cfg, jnp.asarray(toks), jnp.asarray(hid),
                                  jkv, jnp.int32(5))
    tkv = tr.new_mtp_cache(1, 64)
    tlg, tkv2, th = TL.mtp_forward(tr.params, tr.cfg, torch.from_numpy(toks).long(),
                                   torch.from_numpy(hid), tkv, 5)
    assert tkv2 is tkv and tlg.dtype == th.dtype == torch.float32
    _close(tlg, jlg, 1e-5)
    _close(th, jh, 1e-5)
    for f in ("k", "v"):
        rows = getattr(tkv, f)[0, 0].float().numpy()
        jrows = np.asarray(getattr(jkv, f)[0, 0], np.float32)
        _close(rows[5:17], jrows[5:17], 1e-5)
        assert not rows[:5].any() and not rows[17:].any()


def test_forward_hidden_outputs_equal_jax(rts):
    """return_hidden (the final-norm stream) and return_mtp_hidden (the
    pre-output-norm stream beside the logits) against the JAX forward,
    both eager, over one 16-token chunk."""
    jr, tr = rts
    toks = np.random.default_rng(1).integers(3, 250, (1, 16)).astype(np.int32)
    jlg, _, jmh = JL.forward(jr.params, jr.cfg, jnp.asarray(toks), jr.new_cache(1, 64),
                             jnp.int32(0), return_mtp_hidden=True)
    jh, _ = JL.forward(jr.params, jr.cfg, jnp.asarray(toks), jr.new_cache(1, 64),
                       jnp.int32(0), return_hidden=True)
    t = torch.from_numpy(toks).long()
    tlg, tmh = TL.forward(tr.params, tr.cfg, t, tr.new_cache(1, 64), 0, return_mtp_hidden=True)
    th = TL.forward(tr.params, tr.cfg, t, tr.new_cache(1, 64), 0, return_hidden=True)
    assert tmh.dtype == th.dtype == torch.float32 and tmh.shape == (1, 16, tr.cfg.n_embd)
    _close(tlg, jlg, TOL)
    _close(tmh, jmh, TOL)
    _close(th, jh, TOL)
    # the stream is the norm's input: the final norm of it gives return_hidden
    normed = TL._norm(tmh.to(torch.bfloat16), tr.params.get("output_norm"), None, tr.cfg)
    assert torch.equal(normed.float(), th)


def test_eval_tokens_hidden_equals_jax(rts):
    jr, tr = rts
    ids = tr._ids(PROMPT)
    jl, jh, _, jn = jr.eval_tokens_hidden(ids, jr.new_cache(1, 64), 0)
    tl, th, _, tn = tr.eval_tokens_hidden(ids, tr.new_cache(1, 64), 0)
    assert tn == jn == len(ids) and th.shape == (len(ids), tr.cfg.n_embd)
    _close(tl, jl, TOL)
    _close(th, jh, TOL)
    full, _, _ = tr.eval_tokens(ids, tr.new_cache(1, 64), 0, all_logits=True)
    assert torch.equal(full, tl)


def test_generate_mtp_equals_jax(rts):
    """The MTP layer's own drafts (on random weights it rarely agrees with
    the model): the JAX tokens and stats, which are the plain greedy ones."""
    jr, tr = rts
    _, plain = tr.generate(PROMPT, 16, stop_at_eos=False)
    for n_draft in (3, 1):
        _, jt, js = JS.generate_speculative(jr, PROMPT, 16, stage="mtp", n_draft=n_draft,
                                            stop_at_eos=False)
        _, tt, ts = TS.generate_speculative(tr, PROMPT, 16, stage="mtp", n_draft=n_draft,
                                            stop_at_eos=False)
        assert tt == jt == plain
        assert (ts.n_draft, ts.n_accept, ts.n_rounds) == (js.n_draft, js.n_accept, js.n_rounds)


def test_generate_mtp_accepting_rounds_equal_jax(rts, monkeypatch):
    """Drafts forced to the greedy continuation (the MTP step's logits
    replaced by a one-hot of the token its row predicts, its cache and
    stream kept) and wrong at every third position of the chain: rounds
    accept 0-2 tokens, and the MTP cache that the refreshes leave holds
    JAX's rows."""
    jr, tr = rts
    ids, plain = tr.generate(PROMPT, 16, stop_at_eos=False)
    seq = ids + plain
    n_v = tr.cfg.n_vocab
    caches = {}

    def forced(lg_shape, pos, t):
        out = np.full(lg_shape, -1e4, np.float32)
        for j in range(lg_shape[1]):
            p = pos + j + 2                  # MTP row p predicts t_{p+2}
            tok = seq[p] if p < len(seq) else 0
            out[0, j, (tok + (1 if p % 3 == 0 else 0)) % n_v] = 0.0
        return out

    real_j = jr._mtp_step

    def j_step(chunk):
        step = real_j(chunk)

        def wrapped(params, tokens, hidden, kv, n_past):
            lg, kv, h = step(params, tokens, hidden, kv, n_past)
            caches["jax"] = kv
            return jnp.asarray(forced(lg.shape, int(n_past), None)), kv, h
        return wrapped

    real_t = TL.mtp_forward

    def t_forward(params, cfg, tokens, hidden, kv, n_past):
        lg, kv, h = real_t(params, cfg, tokens, hidden, kv, n_past)
        caches["port"] = kv
        return torch.from_numpy(forced(tuple(lg.shape), int(n_past), None)), kv, h

    monkeypatch.setattr(jr, "_mtp_step", j_step)
    monkeypatch.setattr(TL, "mtp_forward", t_forward)
    _, jt, js = JS.generate_speculative(jr, PROMPT, 16, stage="mtp", n_draft=3,
                                        stop_at_eos=False)
    _, tt, ts = TS.generate_speculative(tr, PROMPT, 16, stage="mtp", n_draft=3,
                                        stop_at_eos=False)
    assert tt == jt == plain
    assert (ts.n_draft, ts.n_accept, ts.n_rounds) == (js.n_draft, js.n_accept, js.n_rounds)
    assert 0 < ts.n_accept < ts.n_draft
    # the rows below the MTP cache's fill: refreshed with the main hiddens
    n = len(ids) + len(plain) - 2
    for f in ("k", "v"):
        _close(getattr(caches["port"], f)[0, 0, :n].float(),
               np.asarray(getattr(caches["jax"], f)[0, 0, :n], np.float32), TOL)
