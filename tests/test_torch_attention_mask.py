"""The DSA sparse attention's pieces in the port against the JAX package on
the CPU: ``attend``'s allow mask, the plain attention at an MLA shape (one
kv head, v a view of k's first columns), and the lightning indexer's top-k
key selection, whose ties the port breaks as ``jax.lax.top_k`` does (toward
the lower key).

Attention results are held to one bf16 ulp (the rule of
test_torch_flash_attention.py: both sides take bf16 inputs, compute in
float32 and round once); the indexer's masks must be equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import fixtures as F
from ik_llama_cpp_tpu.models import deepseek2 as JD
from ik_llama_cpp_tpu.models import weights as JW
from ik_llama_cpp_tpu.ops import layers as JL
from ik_llama_cpp_tpu.ops.attention import attend as j_attend
from ik_llama_cpp_tpu_torch.models import deepseek2 as TD
from ik_llama_cpp_tpu_torch.models.weights import DenseLinear
from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA
from ik_llama_cpp_tpu_torch.ops import layers as TL
from ik_llama_cpp_tpu_torch.ops.attention import attend as t_attend
from test_torch_deepseek2 import _loaded
from test_torch_flash_attention import assert_within_ulp


def _qkv(b, t, s, h, hkv, dk, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, dk)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dk)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (4, 1)])
def test_attend_allow_mask_matches_jax(h, hkv):
    """A random allow mask ANDed into the causal / fill mask (every query
    keeps its own key, as the indexer's selection does)."""
    b, t, s, d = 2, 6, 24, 32
    q, k, v = _qkv(b, t, s, h, hkv, d, d, 0)
    qpos = np.asarray([[5, 6, 7, 8, 9, 10], [12, 13, 14, 15, 16, 17]], np.int32)
    kvlen = np.asarray([11, 18], np.int32)
    rng = np.random.default_rng(1)
    allow = rng.random((b, t, s)) < 0.4
    allow[np.arange(b)[:, None], np.arange(t)[None, :], qpos] = True
    got = t_attend(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                   q_pos=torch.from_numpy(qpos), kv_len=torch.from_numpy(kvlen), scale=0.2,
                   allow_mask=torch.from_numpy(allow))
    ref = j_attend(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                   q_pos=jnp.asarray(qpos), kv_len=jnp.asarray(kvlen), scale=0.2,
                   allow_mask=jnp.asarray(allow))
    assert_within_ulp(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    unmasked = t_attend(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                        q_pos=torch.from_numpy(qpos), kv_len=torch.from_numpy(kvlen),
                        scale=0.2)
    assert not torch.equal(got, unmasked)


def test_attention_ref_at_an_mla_shape_matches_jax():
    """The plain version of the MLA form: four heads over one kv head of
    head dim 80 whose values are a view of its first 64 columns."""
    q, k, _ = _qkv(2, 5, 40, 4, 1, 80, 64, 2)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = tk[..., :64]
    assert tv.data_ptr() == tk.data_ptr()
    got = TFA.attention_ref(tq, tk, tv, torch.tensor([20, 33]), torch.tensor([25, 38]),
                            scale=0.11)
    qpos = np.asarray([20, 33], np.int32)[:, None] + np.arange(5, dtype=np.int32)[None]
    jk = jnp.asarray(k, jnp.bfloat16)
    ref = j_attend(jnp.asarray(q, jnp.bfloat16), jk, jk[..., :64], q_pos=jnp.asarray(qpos),
                   kv_len=jnp.asarray([25, 38], jnp.int32), scale=0.11)
    assert got.shape == (2, 5, 4, 64)
    assert_within_ulp(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_top_k_breaks_ties_toward_the_lower_index():
    """The port's rule against ``jax.lax.top_k`` on rows of exact ties: the
    indexer's zero scores (relus that are all 0), its masked -inf and the
    boosted first key."""
    rng = np.random.default_rng(3)
    score = np.zeros((3, 7, 40), np.float32)
    score[..., ::5] = rng.random((3, 7, 8)).astype(np.float32)   # a few positive keys
    score[..., 30:] = -np.inf
    score[..., 0] += 1e20
    score[1] = 0.0                                               # a row of ties only
    got = TD._top_k_lowest_first(torch.from_numpy(score), 12).numpy()
    _, want = jax.lax.top_k(jnp.asarray(score), 12)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[1] == np.arange(12)).all()


def _indexer_inputs(tc, t, seed):
    rng = np.random.default_rng(seed)
    hcur = rng.standard_normal((1, t, tc.n_embd)).astype(np.float32)
    q_lat = rng.standard_normal((1, t, tc.n_lora_q)).astype(np.float32)
    return hcur, q_lat


@pytest.mark.parametrize("zero_weights", [True, False])
def test_dsa_topk_mask_matches_jax(tmp_path, zero_weights):
    """glm-dsa's indexer over a 20-token chunk after 5 cached tokens, top-k
    6: the port's allow mask and indexer keys equal the JAX package's. With
    the per-head weights zeroed every score ties at 0 and the selection is
    the first key (boosted) and then the lowest keys, which only a tie
    rule like JAX's gives."""
    jp, jc, tp, tc = _loaded(F.make_tiny_glmdsa_gguf(tmp_path / "g.gguf", seed=6), True)
    jb, tb = dict(jp["blocks"][0]), dict(tp["blocks"][0])
    if zero_weights:
        jb["idx_proj"] = JW.DenseLinear(jnp.zeros_like(jb["idx_proj"].w))
        tb["idx_proj"] = DenseLinear(torch.zeros_like(tb["idx_proj"].w))
    n_past, t, s = 5, 20, 32
    hcur, q_lat = _indexer_inputs(tc, t, 4)
    qpos = (n_past + np.arange(t, dtype=np.int32))[None]
    kr0 = np.random.default_rng(5).standard_normal((1, s, 1, 32)).astype(np.float32)
    kr0[:, n_past + t:] = 0.0
    jcos, jsin = JL.rope_cache(jnp.asarray(qpos), tc.qk_rope_head_dim, tc.rope_freq_base)
    tcos, tsin = TL.rope_cache(torch.from_numpy(qpos), tc.qk_rope_head_dim, tc.rope_freq_base)
    jallow, jkr = JD._dsa_topk_mask(
        jb, jnp.asarray(hcur, jnp.bfloat16), jnp.asarray(q_lat), jc,
        jnp.asarray(kr0, jnp.bfloat16), jnp.asarray([n_past], jnp.int32), jnp.asarray(qpos),
        jcos, jsin)
    tkr = torch.from_numpy(kr0).to(torch.bfloat16)
    tallow = TD._dsa_topk_mask(
        tb, torch.from_numpy(hcur).to(torch.bfloat16), torch.from_numpy(q_lat), tc, tkr,
        [n_past], torch.tensor([n_past], dtype=torch.int32), torch.from_numpy(qpos),
        tcos, tsin)
    np.testing.assert_array_equal(tallow.numpy(), np.asarray(jallow))
    np.testing.assert_array_equal(tkr.float().numpy(), np.asarray(jkr.astype(jnp.float32)))
    assert (tallow.sum(-1) == 6).all()                # every query past 6 keys is cut
    if zero_weights:
        assert tallow[0, :, :6].all() and not tallow[0, :, 6:].any()
