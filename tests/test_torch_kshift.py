"""The port's K-shift against the JAX package's ``runtime/kshift.py``, on a
bf16 cache and on every codec.

Rows that are only moved (V, the V scales, the kept head, the filler at the
end) must be identical. The re-rotated K rows go through cos/sin tables that
the two frameworks compute to about 1e-6 of each other, so a re-encoded code
may land on the other side of a rounding step now and then: at most 0.5% of
the codes may differ, each by one step, the row scales agree to 1e-5, and
the decoded rows to one step of the codec's grid. bf16 rows agree to one
bf16 ulp."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.models.config import ModelConfig as JConfig
from ik_llama_cpp_tpu.models.llama import KVCache as JKV
from ik_llama_cpp_tpu.ops import kv_quant as JQ
from ik_llama_cpp_tpu.runtime import kshift as JK
from ik_llama_cpp_tpu_torch.models.config import ModelConfig as TConfig
from ik_llama_cpp_tpu_torch.models.convert import kv_from_numpy
from ik_llama_cpp_tpu_torch.models.llama import KVCache as TKV, MixedKVCache
from ik_llama_cpp_tpu_torch.ops import kv_quant as TQ
from ik_llama_cpp_tpu_torch.ops import layers as TL
from ik_llama_cpp_tpu_torch.runtime import kshift as TK

CFG = dict(arch="llama", n_layer=2, n_embd=256, n_head=4, n_head_kv=2, n_ff=128,
           n_vocab=100, n_ctx_train=512, head_dim=64)
STEP = {"q8": 1, "q4": 1, "q6": 1, "nl4": 24}      # widest grid step, in code units


def filled(codec, cfg, cap, n_fill, seed):
    """A JAX cache with n_fill real rows per layer (numpy arrays)."""
    rng = np.random.default_rng(seed)
    shape = (cfg["n_layer"], 1, n_fill, cfg["n_head_kv"], cfg["head_dim"])
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    kv = JKV.create(JConfig(**cfg), 1, cap, quant=codec or False)
    if not codec:
        return (np.asarray(kv.k.at[:, :, :n_fill].set(k.astype(jnp.bfloat16))),
                np.asarray(kv.v.at[:, :, :n_fill].set(v.astype(jnp.bfloat16))), None, None)
    kq, ks = JQ.KV_ENCODERS[codec](jnp.asarray(k))
    vq, vs = JQ.KV_ENCODERS[codec](jnp.asarray(v))
    return (np.asarray(kv.k.at[:, :, :n_fill].set(kq)), np.asarray(kv.v.at[:, :, :n_fill].set(vq)),
            np.asarray(kv.k_scale.at[:, :, :n_fill].set(ks)),
            np.asarray(kv.v_scale.at[:, :, :n_fill].set(vs)))


def as_jax(arrs):
    return JKV(*[None if a is None else jnp.asarray(a) for a in arrs])


@pytest.mark.parametrize("rope_dim", [0, 32])
@pytest.mark.parametrize("codec", [None, "q8", "q4", "q6", "nl4"])
def test_k_shift_matches_jax(codec, rope_dim):
    cfg = dict(CFG, rope_dim=rope_dim)
    n_keep, n_discard, n_past, cap = 3, 5, 20, 32
    arrs = filled(codec, cfg, cap, n_past, seed=7)
    with jax.disable_jit():       # op by op, as the port runs: see ops/kv_quant.py
        jkv, jn = JK.k_shift(as_jax(arrs), JConfig(**cfg), n_keep, n_discard, n_past)
    tkv = kv_from_numpy(*arrs, device="cpu")
    ptr = tkv.k.data_ptr()
    tkv, tn = TK.k_shift(tkv, TConfig(**cfg), n_keep, n_discard, n_past)
    assert tn == jn == n_past - n_discard and tkv.k.data_ptr() == ptr     # in place
    # moved, not re-coded: identical
    np.testing.assert_array_equal(tkv.v.float().numpy(), np.asarray(jkv.v, np.float32))
    np.testing.assert_array_equal(tkv.k[:, :, :n_keep].float().numpy(),
                                  np.asarray(jkv.k[:, :, :n_keep], np.float32))
    np.testing.assert_array_equal(tkv.k[:, :, cap - n_discard:].float().numpy(),
                                  np.asarray(jkv.k[:, :, cap - n_discard:], np.float32))
    live = slice(n_keep, n_past - n_discard)
    if codec is None:
        got, ref = tkv.k[:, :, live].float().numpy(), np.asarray(jkv.k[:, :, live], np.float32)
        assert np.abs(got - ref).max() <= 2.0 ** -8 * np.abs(ref).max()
        assert (got != ref).mean() < 0.01
        return
    np.testing.assert_array_equal(tkv.v_scale.numpy(), np.asarray(jkv.v_scale))
    np.testing.assert_allclose(tkv.k_scale.numpy(), np.asarray(jkv.k_scale), rtol=1e-5, atol=0)
    differ = (tkv.k[:, :, live].numpy() != np.asarray(jkv.k[:, :, live])).mean()
    assert differ <= 5e-3, f"{differ:.2%} of the re-encoded bytes differ"
    dec_t = TQ.KV_DECODERS[codec](tkv.k[:, :, live], tkv.k_scale[:, :, live]).numpy()
    dec_j = np.asarray(JQ.KV_DECODERS[codec](jkv.k[:, :, live], jkv.k_scale[:, :, live]))
    step = STEP[codec] * np.abs(np.asarray(jkv.k_scale[:, :, live]))[..., None]
    assert (np.abs(dec_t - dec_j) <= step * 1.0001 + 1e-7).all()


@pytest.mark.parametrize("codec", [None, "q8", "nl4"])
def test_k_shift_rebases_positions(codec):
    """rope(x, p) shifted by -n equals rope(x, p - n), to the codec's error."""
    cfg = TConfig(**CFG)
    n_keep, n_discard, n_past, cap = 2, 4, 12, 16
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, n_past, 2, 64)).astype(np.float32))

    def roped(pos0):
        pos = torch.arange(pos0, pos0 + n_past, dtype=torch.int32)[None]
        cos, sin = TL.rope_cache(pos, 64, cfg.rope_freq_base)
        return TL.apply_rope(x, cos, sin, cfg.rope_type)

    kv = TKV.create(dataclasses.replace(cfg, n_layer=1), 1, cap, "cpu", quant=codec or False)
    k0 = roped(0)
    if codec:
        kv.k[0, :, :n_past], kv.k_scale[0, :, :n_past] = TQ.KV_ENCODERS[codec](k0)
    else:
        kv.k[0, :, :n_past] = k0.to(torch.bfloat16)
    kv, n = TK.k_shift(kv, dataclasses.replace(cfg, n_layer=1), n_keep, n_discard, n_past)
    got = (TQ.KV_DECODERS[codec](kv.k[0], kv.k_scale[0]) if codec else kv.k[0].float())
    want = roped(-n_discard)[:, n_keep + n_discard:]
    err = (got[:, n_keep:n] - want).abs().max()
    assert n == 8 and float(err) <= {None: 0.03, "q8": 0.06, "nl4": 0.8}[codec]


def test_k_shift_on_a_mixed_cache():
    cfg = TConfig(**dict(CFG, n_layer=4))
    kv = MixedKVCache.create(cfg, 1, 16, "cpu", mid="q4", override="q8")
    rng = np.random.default_rng(2)
    for i in range(4):
        codec = TQ.kv_codec_of(kv.k[i], 64)
        assert codec == ("q8" if i in (0, 3) else "q4")
        x = torch.from_numpy(rng.standard_normal((1, 10, 2, 64)).astype(np.float32))
        kv.k[i][:, :10], kv.k_scale[i][:, :10] = TQ.KV_ENCODERS[codec](x)
        kv.v[i][:, :10], kv.v_scale[i][:, :10] = TQ.KV_ENCODERS[codec](x)
    before = [kv.v[i].clone() for i in range(4)]
    kv, n = TK.k_shift(kv, cfg, 2, 3, 10)
    assert n == 7
    for i in range(4):
        assert torch.equal(kv.v[i][:, 2:7], before[i][:, 5:10])
        assert torch.equal(kv.v[i][:, :2], before[i][:, :2])
        assert float(kv.k_scale[i][:, 2:7].abs().min()) > 0


@pytest.mark.parametrize("field,value,ok", [
    (None, None, True), ("k_hadamard", True, False), ("v_hadamard", True, True),
    ("attn_chunk", 64, False), ("alibi_max_bias", 8.0, False), ("use_rope", False, False),
    ("n_lora_kv", 16, False), ("no_rope_step", 4, False), ("arch", "mamba", False),
    ("extra", {"rope_sections": [1, 2]}, False)])
def test_can_shift_gates(field, value, ok):
    kw = dict(CFG) if field is None else dict(CFG, **{field: value})
    assert TK.can_shift(TConfig(**kw)) is ok
    assert JK.can_shift(JConfig(**kw)) is ok
