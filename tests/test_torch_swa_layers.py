"""A per-layer sliding window in the port against the JAX package on the
CPU: a llama GGUF whose every other layer has a 16-token window (and, in
one case, its own rope base), over a 40-token prompt and 8 greedy steps."""
from dataclasses import replace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fixtures import make_tiny_llamalike_gguf
from ik_llama_cpp_tpu.gguf.reader import load_gguf as j_load_gguf
from ik_llama_cpp_tpu.models import llama as JLM
from ik_llama_cpp_tpu.models.config import config_from_gguf as j_config
from ik_llama_cpp_tpu.runtime.generate import Runtime as JRuntime
from ik_llama_cpp_tpu_torch.gguf.reader import load_gguf as t_load_gguf
from ik_llama_cpp_tpu_torch.models import llama as TLM
from ik_llama_cpp_tpu_torch.models.config import config_from_gguf as t_config
from ik_llama_cpp_tpu_torch.runtime.generate import Runtime as TRuntime

WINDOW = 16
SWA_KV = {"llama.attention.sliding_window": WINDOW,
          "llama.attention.sliding_window_pattern": 2}
CASES = {"window": SWA_KV, "window+rope_base": {**SWA_KV, "llama.rope.freq_base_swa": 1000.0}}
PROMPT = [int(x) for x in np.random.default_rng(3).integers(3, 250, 40)]


@pytest.fixture(scope="module", params=list(CASES))
def swa_gguf(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("swa") / f"{request.param}.gguf"
    return make_tiny_llamalike_gguf(path, arch="llama", extra_kv=CASES[request.param],
                                    seed=7, n_layer=2, n_embd=64, n_head=4, n_head_kv=2)


def _forwards(path):
    """One un-jitted JAX forward and the port's over the prompt, with the
    port's config and the one that puts the window on every layer."""
    jg, tg = j_load_gguf(path), t_load_gguf(path)
    jc, tc = j_config(jg.metadata), t_config(tg.metadata)
    assert tc.swa_window == WINDOW and tc.swa_layer_mask == (True, False)
    assert tc.rope_freq_base_swa == jc.rope_freq_base_swa
    jp = JLM.load_llama_params(jg, jc)
    tp = TLM.load_llama_params(tg, tc, "cpu")
    toks = np.asarray(PROMPT, np.int32)[None]
    jlog, _ = JLM.forward(jp, jc, jnp.asarray(toks), JLM.KVCache.create(jc, 1, 64), jnp.int32(0))

    def port(cfg):
        return TLM.forward(tp, cfg, torch.from_numpy(toks),
                           TLM.KVCache.create(cfg, 1, 64, "cpu"), 0).numpy()
    return np.asarray(jlog), port(tc), port(replace(tc, swa_layer_mask=()))


def test_sliding_window_layers_match_jax_forward(swa_gguf):
    """The same operations in the same order: the eager JAX forward's
    tolerance of tests/test_torch_llama.py. A window on every layer, what
    the port did before (with the one rope base), is far outside it: the
    prompt is longer than the window."""
    jlog, got, every_layer = _forwards(swa_gguf)
    tol = 1e-4 * float(np.abs(jlog).max())
    np.testing.assert_allclose(got, jlog, rtol=0, atol=tol)
    assert np.abs(every_layer - jlog).max() > 100 * tol


def test_sliding_window_greedy_matches_jax_runtime(swa_gguf):
    """8 greedy steps after the 40-token prompt give the JAX runtime's
    tokens, and the prompt's logits agree within the runtime tolerance of
    tests/test_torch_llama.py (3% of the largest logit: jit rounds the bf16
    residual stream at other points than eager execution)."""
    jr = JRuntime.from_gguf(swa_gguf)
    tr = TRuntime.from_gguf(swa_gguf, device="cpu")
    _, jt = jr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    _, tt = tr.generate_greedy_on_device(PROMPT, 8, stop_at_eos=False)
    assert tt == jt and len(tt) == 8
    jl, _, _ = jr.eval_tokens(PROMPT, jr.new_cache(1, 64), 0, all_logits=True)
    tl, _, _ = tr.eval_tokens(PROMPT, tr.new_cache(1, 64), 0, all_logits=True)
    assert np.abs(tl.numpy() - jl).max() <= 3e-2 * np.abs(jl).max()
