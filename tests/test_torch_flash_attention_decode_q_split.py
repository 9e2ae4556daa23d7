"""Kernel 5, the split-K decode attention over a quantized slab
(``csrc/flash_attention_decode_q.cu``): a plain model of its partition and
merge over each codec's decoded slab, held against the JAX package's
Pallas ``flash_attention_decode_q8`` (interpret mode, as
tests/test_torch_flash_attention_quant.py runs it) and the port's plain
version ``attention_quant_ref`` on the CPU; the kernel itself against the
plain version on the card (skipped without one).

Kernel 5 runs kernel C's split frame (``decode_split_plan``,
``decode_key_ranges``, the merge in split order), so the model is C's
(tests/test_torch_flash_attention_decode_split.py) over K = code * k_scale
in float32 and V = bf16(code * v_scale), what the kernel multiplies.

Tolerances, as for C:
- the model with unrounded probabilities against the plain version in
  float32: 1e-5 max|ref|; both take the same exact K and V and differ only
  in the order of their float32 sums and in the rescaling of partial sums
  by exp(m_split - m) (the kernel scores q . code, then scales once: a
  float32 reassociation of the same product);
- the model (probabilities rounded to bf16 before the PV product) and the
  kernel against bf16 results: 2^-7 max|ref|, phase 3's rule: two bf16
  ulps at the largest output."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops.flash_attention import flash_attention_decode_q8 as j_fa_dec_q
from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA
from ik_llama_cpp_tpu_torch.ops import kv_quant as TQ
from test_torch_flash_attention_decode_split import split_model

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")
CODECS = ("q8", "q4", "q6", "nl4")


def make(codec, b, t, s, h, hkv, d, seed):
    """q in bf16 and a cache quantized by the port's encoder (bit-identical
    to the JAX one)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    kq, ks = TQ.KV_ENCODERS[codec](k)
    vq, vs = TQ.KV_ENCODERS[codec](v)
    return q.to(torch.bfloat16), kq, ks, vq, vs


def decoded(codec, kq, ks, vq, vs):
    """What the kernel multiplies: K = code * k_scale in float32, V rounded
    to bf16."""
    dec = TQ.KV_DECODERS[codec]
    return dec(kq, ks).float(), dec(vq, vs).to(torch.bfloat16).float()


def _kw(extra, h, d, seed):
    kw = dict(extra, scale=1.0 / float(np.sqrt(d)))
    if kw.get("sinks"):
        kw["sinks"] = torch.from_numpy(
            np.random.default_rng(seed).normal(size=h).astype(np.float32))
    return kw


# b, t, s, h, hkv, d, q_pos0, kv_len, extra, also against the Pallas kernel
# (S % 128 == 0, D == 128; seconds a case in interpret mode). The 8/2 head
# layout at S 1024 splits 4 ways at T 1 (round 256) and 8 ways at T 8.
CASES = {
    "kv200_whole": (1, 1, 1024, 8, 2, 128, [199], [200], {}, False),
    "kv257": (1, 1, 1024, 8, 2, 128, [256], [257], {}, False),
    "kv1000": (1, 1, 1024, 8, 2, 128, [999], [1000], {}, True),
    "t8": (1, 8, 1024, 8, 2, 128, [505], [513], {}, False),
    "sinks_swa": (1, 1, 1024, 8, 2, 128, [999], [1000],
                  {"sinks": True, "swa_window": 300}, True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("codec", CODECS)
def test_split_model_matches_jax_and_plain(codec, case):
    b, t, s, h, hkv, d, qpos, kvlen, extra, pallas = CASES[case]
    q, kq, ks, vq, vs = make(codec, b, t, s, h, hkv, d, seed=30 + len(case))
    kd, vd = decoded(codec, kq, ks, vq, vs)
    kw = _kw(extra, h, d, 9)
    qp, kl = torch.tensor(qpos, dtype=torch.int32), torch.tensor(kvlen, dtype=torch.int32)
    plan = TFA.decode_split_plan(b, t, h, hkv, s, d, d)
    key_start = max(0, qpos[0] - kw.get("swa_window", 0) + 1) if "swa_window" in kw else 0
    ranges = TFA.decode_key_ranges(plan, key_start, kvlen[0])
    assert (len(ranges) == 1) == case.endswith("whole"), ranges
    # the algebra: unrounded probabilities against the plain version in float32
    exact = split_model(q, kd, vd, qp, kl, round_p=False, **kw)
    ref32 = TFA.attention_ref(q.float(), kd, vd, qp, kl, **kw)
    assert float((exact - ref32).abs().max()) <= 1e-5 * float(ref32.abs().max())
    # the kernel's rounding against the port's plain version and the Pallas kernel
    got = split_model(q, kd, vd, qp, kl, **kw)
    refs = [TFA.attention_quant_ref(q, kq, ks, vq, vs, qp, kl, **kw).float()]
    if pallas:
        sinks = kw.pop("sinks", None)
        jout = j_fa_dec_q(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                          *(jnp.asarray(a.numpy()) for a in (kq, ks, vq, vs)),
                          jnp.asarray(qpos, jnp.int32), jnp.asarray(kvlen, jnp.int32),
                          sinks=None if sinks is None else jnp.asarray(sinks.numpy()),
                          block_kv=128, interpret=True, **kw)
        assert jout is not None
        refs.append(torch.from_numpy(np.asarray(jout, np.float32)))
    for r in refs:
        assert float((got - r).abs().max()) <= 2.0 ** -7 * float(r.abs().max())


# ------------------------------------------------------- on the card --
# b, t, s, h, hkv, d, q_pos0, kv_len, extra: one range (the first port's
# partition), split boundaries, the long context kernel 5 exists for, head
# dims 64 and 256, the 16/16 layout, a batch whose rows take either path,
# every mask
CARD = {
    "kv256_whole": (1, 1, 4096, 32, 8, 128, [255], [256], {}),
    "kv257_split": (1, 1, 4096, 32, 8, 128, [256], [257], {}),
    "kv513": (1, 1, 1024, 32, 8, 128, [512], [513], {}),
    "kv4000": (1, 1, 4096, 32, 8, 128, [3999], [4000], {}),
    "t8_kv4000": (1, 8, 4096, 32, 8, 128, [3992], [4000], {}),
    "t16_kv2000": (1, 16, 4096, 32, 8, 128, [1984], [2000], {}),
    "d64_kv1500": (1, 1, 2048, 32, 8, 64, [1499], [1500], {}),
    "d256_kv1500": (1, 2, 2048, 8, 2, 256, [1498], [1500], {}),
    "h16x16_kv3000": (1, 1, 4096, 16, 16, 128, [2999], [3000], {}),
    "b2_mixed": (2, 1, 1024, 32, 8, 128, [200, 999], [201, 1000], {}),
    "sinks_swa": (1, 1, 4096, 32, 8, 128, [3999], [4000], {"sinks": True, "swa_window": 1000}),
    "chunk_softcap": (1, 4, 4096, 32, 8, 128, [3000], [3004],
                      {"attn_chunk": 2048, "softcap": 30.0}),
}


@needs_cuda
@pytest.mark.parametrize("case", list(CARD))
@pytest.mark.parametrize("codec", CODECS)
def test_decode_q_kernel_split_matches_plain(codec, case):
    b, t, s, h, hkv, d, qpos, kvlen, extra = CARD[case]
    args = [a.cuda() for a in make(codec, b, t, s, h, hkv, d, seed=len(case))]
    args += [torch.tensor(qpos, dtype=torch.int32, device="cuda"),
             torch.tensor(kvlen, dtype=torch.int32, device="cuda")]
    kw = _kw(extra, h, d, len(case))
    if "sinks" in kw:
        kw["sinks"] = kw["sinks"].cuda()
    got = TFA.flash_attention_decode_q8(*args, **kw)
    ref = TFA.attention_quant_ref(*args, **kw).float()
    assert got.shape == ref.shape and bool(torch.isfinite(got.float()).all())
    # probabilities enter the PV product in bf16: two bf16 ulps at the max
    assert float((got.float() - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    for _ in range(3):
        assert torch.equal(TFA.flash_attention_decode_q8(*args, **kw), got)


@needs_cuda
@pytest.mark.parametrize("codec", CODECS)
def test_decode_q_kernel_on_a_slab_of_a_stacked_cache(codec):
    """The model passes kv.k[i] and kv.k_scale[i], strided views of the
    stacks, and the split path reads them in place."""
    q, kq, ks, vq, vs = make(codec, 2, 1, 2048, 32, 8, 128, seed=4)
    stack = [torch.stack([torch.zeros_like(a), a]).cuda() for a in (kq, ks, vq, vs)]
    qp = torch.tensor([1499, 700], dtype=torch.int32).cuda()
    kl = torch.tensor([1500, 701], dtype=torch.int32).cuda()
    kw = dict(scale=1.0 / np.sqrt(128))
    views = [x[1] for x in stack]
    got = TFA.flash_attention_decode_q8(q.cuda(), *views, qp, kl, **kw)
    ref = TFA.attention_quant_ref(q.cuda(), *views, qp, kl, **kw).float()
    assert float((got.float() - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    assert torch.equal(TFA.flash_attention_decode_q8(q.cuda(), *views, qp, kl, **kw), got)
