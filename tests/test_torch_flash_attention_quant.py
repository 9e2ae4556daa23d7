"""The port's attention over a quantized KV cache against the JAX package.

The plain version (what a CPU tensor runs for ``flash_attention_decode_q8``
and ``flash_attention_q8``) is held against the Pallas kernels in interpret
mode and against ``attend`` over the dequantized cache. Tolerance: two bf16
ulps of the largest output. All sides score in float32 over code * scale;
the Pallas kernels round the probabilities and V to bf16 before the PV
product, the plain version rounds V only, ``attend`` neither, and each
rounds its output to bf16 once. The CUDA kernels are held against the plain
version on the card (skipped without one)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import kv_quant as JQ
from ik_llama_cpp_tpu.ops.attention import attend as j_attend
from ik_llama_cpp_tpu.ops.flash_attention import (
    flash_attention_decode_q8 as j_fa_dec_q, flash_attention_q8 as j_fa_q8)
from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA
from ik_llama_cpp_tpu_torch.ops import kv_quant as TQ

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")
CODECS = ("q8", "q4", "q6", "nl4")


def make(codec, b, t, s, h, hkv, d, seed):
    """q in bf16 and a cache quantized by the port's encoder (bit-identical
    to the JAX one), as torch tensors and as jnp arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    kq, ks = TQ.KV_ENCODERS[codec](torch.from_numpy(k))
    vq, vs = TQ.KV_ENCODERS[codec](torch.from_numpy(v))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    jcache = [jnp.asarray(a.numpy()) for a in (kq, ks, vq, vs)]
    return (tq, kq, ks, vq, vs), (jnp.asarray(q, jnp.bfloat16), *jcache)


def assert_close(got, ref, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    tol = 2.0 ** -7 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, \
        f"{what}: max diff {np.abs(got - ref).max():.3e} > {tol:.3e}"


def _kw(extra, h, d, seed):
    kw = dict(extra, scale=1.0 / float(np.sqrt(d)))
    if kw.get("sinks"):
        kw["sinks"] = torch.from_numpy(
            np.random.default_rng(seed).normal(size=h).astype(np.float32))
    return kw


def run_both(fn_t, codec, targs, jargs, qpos, kvlen, t, j_kernel, **kw):
    got = fn_t(*targs, torch.tensor(qpos, dtype=torch.int32),
               torch.tensor(kvlen, dtype=torch.int32), **kw).float().numpy()
    q_pos = np.asarray(qpos, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]
    sinks = kw.pop("sinks", None)
    jsinks = None if sinks is None else jnp.asarray(sinks.numpy())
    jq, jkq, jks, jvq, jvs = jargs
    dec = JQ.KV_DECODERS[codec]
    ref = j_attend(jq, dec(jkq, jks), dec(jvq, jvs), q_pos=jnp.asarray(q_pos),
                   kv_len=jnp.asarray(kvlen, jnp.int32), sinks=jsinks, **kw)
    assert_close(got, ref, "attend over the dequantized cache")
    if j_kernel is not None:
        ker = j_kernel(*jargs, jnp.asarray(qpos, jnp.int32),
                       jnp.asarray(kvlen, jnp.int32), sinks=jsinks, **kw)
        assert ker is not None
        assert_close(got, ker, "Pallas kernel, interpret mode")


DECODE = {
    # b, t, s, h, hkv, d, q_pos0, kv_len, extra, also against the Pallas
    # kernel (it takes S % 128 == 0 and D == 128; interpret mode costs
    # seconds a case, so a covering subset per codec)
    "step": (1, 1, 128, 8, 2, 128, [63], [64], {}, True),
    "verify_t8": (1, 8, 256, 8, 2, 128, [40], [48], {}, True),
    "t16_batch": (2, 16, 256, 4, 4, 128, [100, 200], [116, 216], {}, False),
    "softcap": (1, 2, 128, 4, 1, 128, [50], [52], {"softcap": 5.0}, False),
    "swa": (1, 1, 256, 8, 2, 128, [200], [201], {"swa_window": 64}, True),
    "chunk": (1, 1, 256, 8, 2, 128, [140], [141], {"attn_chunk": 64}, False),
    "sinks": (1, 4, 256, 8, 2, 128, [77], [81], {"sinks": True}, True),
    "head_dim_64": (2, 1, 96, 4, 2, 64, [10, 60], [11, 61], {}, False),
}


@pytest.mark.parametrize("case", list(DECODE))
@pytest.mark.parametrize("codec", CODECS)
def test_decode_plain_matches_jax(codec, case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, pallas = DECODE[case]
    targs, jargs = make(codec, b, t, s, h, hkv, d, seed=20 + len(case))

    def j_kernel(*a, **kw):
        return j_fa_dec_q(*a, block_kv=128, interpret=True, **kw)

    run_both(TFA.flash_attention_decode_q8, codec, targs, jargs, qpos, kvlen, t,
             j_kernel if pallas else None, **_kw(extra, h, d, len(case)))


PREFILL = {
    # b, t, s, h, hkv, d, q_pos0, kv_len, extra, Pallas too (S % 128 == 0)
    "gqa": (1, 32, 128, 4, 2, 64, [0], [32], {}, True),
    "continuation": (1, 24, 128, 4, 1, 64, [40], [64], {}, False),
    "batch_rows": (2, 32, 128, 4, 2, 64, [0, 20], [32, 52], {}, True),
    "softcap": (1, 32, 128, 4, 2, 64, [40], [72], {"softcap": 5.0}, False),
    "swa": (1, 32, 128, 4, 2, 64, [40], [72], {"swa_window": 24}, True),
    "chunk": (1, 32, 128, 4, 2, 64, [16], [48], {"attn_chunk": 32}, False),
    "sinks": (1, 32, 128, 4, 2, 128, [48], [80], {"sinks": True, "softcap": 5.0}, True),
}


@pytest.mark.parametrize("case", list(PREFILL))
def test_prefill_q8_plain_matches_jax(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, pallas = PREFILL[case]
    targs, jargs = make("q8", b, t, s, h, hkv, d, seed=40 + len(case))

    def j_kernel(*a, **kw):
        return j_fa_q8(*a, block_q=16, block_kv=128, interpret=True, **kw)

    run_both(TFA.flash_attention_q8, "q8", targs, jargs, qpos, kvlen, t,
             j_kernel if pallas else None, **_kw(extra, h, d, len(case)))


@pytest.mark.parametrize("codec", CODECS)
def test_plain_takes_views_of_a_stacked_cache(codec):
    """The model passes kv.k[i] and kv.k_scale[i], views of the stacks."""
    (q, kq, ks, vq, vs), _ = make(codec, 1, 1, 64, 4, 2, 32, seed=3)
    stack = [torch.stack([torch.zeros_like(a), a]) for a in (kq, ks, vq, vs)]
    a = TFA.flash_attention_decode_q8(q, *(x[1] for x in stack), 30, 31, scale=0.2)
    b = TFA.flash_attention_decode_q8(q, kq, ks, vq, vs, 30, 31, scale=0.2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert TFA.attention_quant_ref(q, kq, ks, vq, vs, 30, 31, scale=0.2).dtype == torch.bfloat16


# ------------------------------------------------------------------ card --
def _card(targs, qpos, kvlen, kw):
    args = [a.cuda() for a in targs]
    if "sinks" in kw:
        kw = dict(kw, sinks=kw["sinks"].cuda())
    return (*args, torch.tensor(qpos, dtype=torch.int32, device="cuda"),
            torch.tensor(kvlen, dtype=torch.int32, device="cuda")), kw


@needs_cuda
@pytest.mark.parametrize("case", list(DECODE))
@pytest.mark.parametrize("codec", CODECS)
def test_decode_kernel_matches_plain(codec, case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, _ = DECODE[case]
    targs, _ = make(codec, b, t, s, h, hkv, d, seed=2)
    args, kw = _card(targs, qpos, kvlen, _kw(extra, h, d, 2))
    got = TFA.flash_attention_decode_q8(*args, **kw).float()
    ref = TFA.attention_quant_ref(*args, **kw).float()
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


@needs_cuda
@pytest.mark.parametrize("case", list(PREFILL))
def test_prefill_q8_kernel_matches_plain(case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, _ = PREFILL[case]
    targs, _ = make("q8", b, t, s, h, hkv, d, seed=1)
    args, kw = _card(targs, qpos, kvlen, _kw(extra, h, d, 1))
    got = TFA.flash_attention_q8(*args, **kw).float()
    ref = TFA.attention_quant_ref(*args, **kw).float()
    assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())


@needs_cuda
def test_kernels_raise_on_what_they_do_not_take():
    """Where the TPU kernel returned None the port's raises: packed codecs
    with k and v head dims that differ or are no multiple of 32; the prefill
    kernel on anything but int8 codes; T above 16 on the decode kernel."""
    (q, kq, ks, vq, vs), _ = make("q4", 1, 1, 64, 4, 2, 48, seed=4)
    args = [a.cuda() for a in (q, kq, ks, vq, vs)]
    with pytest.raises(ValueError, match="multiples of 32"):
        TFA.flash_attention_decode_q8(*args, 30, 31, scale=0.2)
    (q, kq, ks, vq, vs), _ = make("q4", 1, 32, 64, 4, 2, 64, seed=4)
    args = [a.cuda() for a in (q, kq, ks, vq, vs)]
    with pytest.raises(ValueError, match="int8"):
        TFA.flash_attention_q8(*args, 0, 32, scale=0.2)
    with pytest.raises(ValueError, match="T=32"):
        TFA.flash_attention_decode_q8(*args, 0, 32, scale=0.2)
