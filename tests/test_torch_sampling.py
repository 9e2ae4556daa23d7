"""The port's host sampler chain against the JAX package's, bit for bit: the
same numpy logits and the same ``np.random.Generator`` seed give the same
tokens (and the same surviving candidates) through every chain; and the
engine's top-k readback (``torch.topk`` + ``logsumexp``) against the JAX
readback (``lax.top_k`` + ``logsumexp``) on the same logits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu.runtime import sampling as JS
from ik_llama_cpp_tpu_torch.runtime import sampling as TS
from ik_llama_cpp_tpu_torch.server.engine import TOPK_FETCH, topk_readback

V = 512

CHAINS = {
    "greedy": dict(temp=0.0),
    "default": dict(),
    "top_k/top_p/min_p": dict(temp=1.1, top_k=20, top_p=0.8, min_p=0.1),
    "penalties": dict(temp=0.9, penalty_repeat=1.3, penalty_freq=0.2,
                      penalty_present=0.4, penalty_last_n=16),
    "penalties greedy": dict(temp=0.0, penalty_repeat=1.5),
    "no newline penalty": dict(temp=0.8, penalty_repeat=1.4, penalize_nl=False,
                               nl_token_id=7),
    "dry": dict(temp=0.8, dry_multiplier=2.0, dry_base=1.75, dry_allowed_length=2,
                dry_sequence_breaker_ids=(5,)),
    "mirostat v1": dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.0, mirostat=1,
                        mirostat_tau=4.0, mirostat_eta=0.2),
    "mirostat v2": dict(temp=1.0, mirostat=2, mirostat_tau=3.0),
    "adaptive-p": dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.0,
                       adaptive_target=0.4, adaptive_decay=0.8),
    "tfs/typical/xtc": dict(temp=0.7, tfs_z=0.9, typical_p=0.9,
                            xtc_probability=0.5, xtc_threshold=0.05),
    "top-n-sigma, dynatemp": dict(temp=0.9, top_n_sigma=1.5, dynatemp_range=0.4),
    "order and bias": dict(temp=2.0, samplers=("min_p", "temperature", "top_k"),
                           logit_bias={3: 5.0, 4: -101.0}),
}


def _params(mod, kw):
    return mod.SamplerParams(**kw)


def _run(mod, kw, seed, steps=24, return_probs=False):
    """A run of ``steps`` picks over logits drawn from seed 0 each step, with
    the picks fed back as history and one SamplerState across the run."""
    p = _params(mod, kw)
    rng = np.random.default_rng(seed)
    logits_rng = np.random.default_rng(0)
    state = mod.SamplerState()
    history = [1, 2, 3, 5, 2, 3, 5, 2, 3]
    out = []
    for _ in range(steps):
        logits = (logits_rng.standard_normal(V) * 3).astype(np.float32)
        logits[history[-1]] += 2.0                  # something to penalize
        r = mod.sample(logits, p, rng, history=history, state=state,
                       return_probs=return_probs)
        tok = r[0] if return_probs else r
        out.append(r if not return_probs else
                   (int(r[0]), np.asarray(r[1]).tolist(), np.asarray(r[2]).tolist()))
        history.append(int(tok))
    return out, dataclasses.asdict(state)


@pytest.mark.parametrize("name", sorted(CHAINS))
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_bit_for_bit(name, seed):
    kw = CHAINS[name]
    assert _run(JS, kw, seed) == _run(TS, kw, seed)


@pytest.mark.parametrize("name", ["default", "top_k/top_p/min_p", "mirostat v2"])
def test_sample_return_probs_bit_for_bit(name):
    kw = CHAINS[name]
    assert _run(JS, kw, 3, steps=6, return_probs=True) == \
        _run(TS, kw, 3, steps=6, return_probs=True)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_topk_chain_compatible_matches(name):
    kw = CHAINS[name]
    assert JS.topk_chain_compatible(_params(JS, kw)) == \
        TS.topk_chain_compatible(_params(TS, kw))


def _jax_readback(logits: np.ndarray, k: int):
    row = jnp.asarray(logits, jnp.float32)
    vals, idx = jax.lax.top_k(row, k)
    lse = jax.scipy.special.logsumexp(row, axis=-1)
    return np.asarray(vals), np.asarray(idx), np.asarray(lse)


def test_topk_readback_matches_jax():
    logits = np.random.default_rng(4).standard_normal((4, 32000)).astype(np.float32) * 4
    jv, ji, jl = _jax_readback(logits, TOPK_FETCH)
    tv, ti, tl = topk_readback(torch.from_numpy(logits), TOPK_FETCH)
    assert tv.shape == (4, TOPK_FETCH) and tl.shape == (4,)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


@pytest.mark.parametrize("name", ["greedy", "default", "top_k/top_p/min_p",
                                  "penalties", "penalties greedy"])
def test_sample_topk_bit_for_bit(name):
    """sample_topk on the port's readback gives the JAX sample_topk's tokens
    on the JAX readback, and the full-row sample's tokens."""
    kw = CHAINS[name]
    logits_rng = np.random.default_rng(1)
    rngs = {m: np.random.default_rng(5) for m in ("j", "t", "full")}
    states = {m: TS.SamplerState() for m in rngs}
    hist = [10, 11, 12]
    for _ in range(16):
        logits = (logits_rng.standard_normal((1, 4096)) * 3).astype(np.float32)
        jv, ji, jl = _jax_readback(logits[0], TOPK_FETCH)
        tv, ti, tl = topk_readback(torch.from_numpy(logits), TOPK_FETCH)
        a = JS.sample_topk(jv, ji, float(jl), _params(JS, kw), rngs["j"], history=hist,
                           state=states["j"])
        b = TS.sample_topk(tv[0], ti[0], float(tl[0]), _params(TS, kw), rngs["t"],
                           history=hist, state=states["t"])
        c = TS.sample(logits[0], _params(TS, kw), rngs["full"], history=hist,
                      state=states["full"])
        assert a == b == c
        hist.append(b)
