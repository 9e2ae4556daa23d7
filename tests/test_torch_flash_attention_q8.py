"""Kernel 6 (``flash_attention_q8``, prefill attention over an int8 cache):
the rule that picks the query heads a block takes and the unpacking of its
int8 codes on the CPU; on the card (skipped without one) the kernel against
its plain version at head dims 64, 72 (rows only 8-byte aligned), 128 and
256 and Dk != Dv, over 4,000 keys, with sinks, a sliding window, llama4
chunks, a softcap, batch 2 and a layer slab of a stacked cache. Every card
case checks that two calls repeat bit for bit and that blocks of 1 and 2
query heads give the same bits (each warp's arithmetic is the same)."""
import numpy as np
import pytest
import torch

from ik_llama_cpp_tpu_torch.ops import flash_attention as TFA

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="CUDA kernel: needs an NVIDIA GPU")


@pytest.mark.parametrize("heads,h,hkv,dmax,want", [
    (1, 32, 8, 128, 1), (2, 32, 8, 128, 2),
    (2, 32, 4, 128, 2),            # a group of 8: a block takes a quarter of it
    (2, 28, 4, 128, 1),            # a group of 7: no form but 1 divides it
    (2, 12, 2, 64, 2), (2, 12, 4, 64, 1),
    (2, 16, 16, 128, 1),           # no grouped queries
    (2, 64, 8, 72, 2),             # head dim 72: rows of 8-byte copies
    (2, 8, 1, 256, 1), (2, 32, 8, 256, 1)])    # head dim 256: one head's warps
def test_prefill_q8_heads(monkeypatch, heads, h, hkv, dmax, want):
    monkeypatch.setattr(TFA, "Q8_HEADS", heads)
    assert TFA.prefill_q8_heads(h, hkv, dmax) == want


def test_unpack_gives_every_code_exactly():
    """The kernel's unpacking of a K code b without a conversion
    instruction: the byte b ^ 0x80 in the mantissa of 2^23, minus 2^23 +
    128, is float(b), and the upper 16 bits of that float are bf16(b), for
    all 256 codes; V's bf16(code * scale) then rounds one float32 product."""
    b = np.arange(-128, 128, dtype=np.int32)
    u = (b & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, b.astype(np.float32))
    upper = (f.view(np.uint32) >> 16).astype(np.uint16)
    want = torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(upper, want.astype(np.uint16))


# b, t, s, h, hkv, dk, dv, q_pos0, kv_len, extra, stacked
CARD = {
    "d64": (1, 100, 256, 8, 2, 64, 64, [0], [100], {}, False),
    "d72_rows_8_byte_aligned": (1, 64, 128, 4, 1, 72, 72, [20], [84], {}, False),
    "d128_4000_keys": (1, 512, 4096, 32, 8, 128, 128, [3488], [4000], {}, True),
    "d256": (1, 80, 512, 8, 2, 256, 256, [300], [380], {}, False),
    "dk128_dv64": (1, 70, 256, 8, 2, 128, 64, [10], [80], {}, False),
    "sinks_window_softcap": (2, 130, 512, 8, 2, 128, 128, [0, 200], [130, 330],
                             {"sinks": True, "swa_window": 100, "softcap": 20.0}, True),
    "chunk": (1, 200, 512, 8, 4, 128, 128, [100], [300], {"attn_chunk": 128}, False),
    "no_grouped_queries": (1, 96, 256, 4, 4, 128, 128, [0], [96], {}, False),
}


def card_case(b, t, s, h, hkv, dk, dv, qpos, kvlen, extra, stacked, seed=0):
    """q bf16, random int8 codes with positive f32 row scales (a layer slab
    of a (2, B, S, Hkv, D) cache where ``stacked``), positions and lengths,
    on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 2 if stacked else 1

    def codes(d):
        c = torch.randint(-127, 128, (n, b, s, hkv, d), generator=g, device="cuda",
                          dtype=torch.int8)
        sc = torch.rand((n, b, s, hkv), generator=g, device="cuda") * 0.02 + 1e-3
        return c[n - 1], sc[n - 1]
    kq, ks = codes(dk)
    vq, vs = codes(dv)
    q = torch.randn((b, t, h, dk), generator=g, device="cuda").to(torch.bfloat16)
    kw = dict(extra, scale=1.0 / float(np.sqrt(dk)))
    if kw.get("sinks"):
        kw["sinks"] = torch.randn(h, generator=g, device="cuda")
    qp = torch.tensor(qpos, dtype=torch.int32, device="cuda")
    kl = torch.tensor(kvlen, dtype=torch.int32, device="cuda")
    return (q, kq, ks, vq, vs, qp, kl), kw


@needs_cuda
@pytest.mark.parametrize("case", list(CARD))
def test_prefill_q8_kernel_cases(monkeypatch, case):
    """Within two bf16 ulps of the largest output of the plain version (the
    probabilities enter the PV product in bf16); bit repeats; the same bits
    from blocks of 1 and 2 query heads."""
    args, kw = card_case(*CARD[case])
    got = TFA.flash_attention_q8(*args, **kw)
    ref = TFA.attention_quant_ref(*args, **kw).float()
    assert float((got.float() - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
    assert torch.equal(got, TFA.flash_attention_q8(*args, **kw))
    for heads in (1, 2):
        monkeypatch.setattr(TFA, "Q8_HEADS", heads)
        assert torch.equal(got, TFA.flash_attention_q8(*args, **kw)), heads
