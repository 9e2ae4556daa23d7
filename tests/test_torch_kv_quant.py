"""The port's KV cache codecs and Hadamard rotation against the JAX
package's ``ops/kv_quant.py``: the codecs are integer functions, so codes
and scales must agree bit for bit on the same float32 input (the JAX
functions run op by op here, as the port's do)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ik_llama_cpp_tpu.ops import kv_quant as JQ
from ik_llama_cpp_tpu_torch.ops import kv_quant as TQ

CODECS = ("q8", "q4", "q6", "nl4")
LEVELS = {"q8": 127.0, "q4": 7.0, "q6": 31.0, "nl4": 127.0}


def rows(seed, b=2, t=9, h=3, d=128):
    """Rows over five decades of magnitude, one all-zero row, one row whose
    extreme is positive and one whose extreme is negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, d)) * 10.0 ** rng.uniform(-3, 2, (b, t, h, 1))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0, 5] = np.abs(x[0, 1, 0]).max() * 2      # positive extreme
    x[0, 2, 0, 7] = -np.abs(x[0, 2, 0]).max() * 2     # negative extreme
    x[0, 3, 0, :2] = (3.0, -3.0)                       # tie: the positive one wins
    x[0, 3, 0, 2:] *= 1e-3 / np.abs(x[0, 3, 0, 2:]).max()
    return x


def assert_same_bits(got: torch.Tensor, ref, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8)), what


@pytest.mark.parametrize("d", [128, 64, 32])
@pytest.mark.parametrize("codec", CODECS)
def test_encoder_bit_exact(codec, d):
    x = rows(seed=d, d=d)
    jq, js = JQ.KV_ENCODERS[codec](jnp.asarray(x))
    tq, ts = TQ.KV_ENCODERS[codec](torch.from_numpy(x))
    assert_same_bits(tq, jq, f"{codec} codes")
    assert_same_bits(ts, js, f"{codec} scales")
    # the all-zero row: scale 0, and it decodes to zeros
    assert float(ts[0, 0, 0]) == 0.0
    assert float(TQ.KV_DECODERS[codec](tq, ts)[0, 0, 0].abs().max()) == 0.0


@pytest.mark.parametrize("codec", CODECS)
def test_encoder_ties_round_half_to_even(codec):
    """Rows built so that x / scale lands exactly on .5 boundaries (q8, q4,
    q6) or on the midpoints between IQ4_NL levels (nl4, strict > there)."""
    lv = LEVELS[codec]
    d = 64
    if codec == "nl4":
        half = np.asarray(JQ._IQ4NL_MIDS, np.float32)
        x = np.concatenate([[-127.0], half, half, np.zeros(d - 31)]).astype(np.float32)
    else:
        half = np.arange(-int(lv), int(lv)) + 0.5
        x = np.resize(np.concatenate([[lv], half]), d).astype(np.float32)
    x = x[None, None, None, :]
    jq, js = JQ.KV_ENCODERS[codec](jnp.asarray(x))
    tq, ts = TQ.KV_ENCODERS[codec](torch.from_numpy(x))
    assert abs(float(ts[0, 0, 0])) == 1.0
    assert_same_bits(tq, jq, codec)
    assert_same_bits(ts, js, codec)


@pytest.mark.parametrize("codec", CODECS)
def test_encoder_takes_bf16_and_decoder_bit_exact(codec):
    x = rows(seed=3)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    xb_j = jnp.asarray(x).astype(jnp.bfloat16)
    jq, js = JQ.KV_ENCODERS[codec](xb_j)
    tq, ts = TQ.KV_ENCODERS[codec](xb_t)
    assert_same_bits(tq, jq, codec)
    assert_same_bits(ts, js, codec)
    assert_same_bits(TQ.KV_DECODERS[codec](tq, ts), JQ.KV_DECODERS[codec](jq, js), codec)
    # the stacked-cache layout decodes the same way
    assert_same_bits(TQ.KV_DECODERS[codec](tq[None], ts[None])[0],
                     JQ.KV_DECODERS[codec](jq, js), codec)


def test_nl4_signed_extreme():
    x = rows(seed=4)
    tq, ts = TQ.quantize_kv_rows_nl4(torch.from_numpy(x))
    assert float(ts[0, 1, 0]) < 0 < float(ts[0, 2, 0])    # positive / negative extreme
    assert float(ts[0, 3, 0]) == float(np.float32(3.0) / np.float32(-127.0))            # tie: the positive one
    back = TQ.dequantize_kv_nl4(tq, ts)
    assert float(back[0, 1, 0, 5]) == pytest.approx(float(x[0, 1, 0, 5]), rel=1e-6)
    assert float(back[0, 2, 0, 7]) == pytest.approx(float(x[0, 2, 0, 7]), rel=1e-6)
    assert tq.dtype == torch.int8 and int(tq.min()) < 0   # bytes above 0x7f wrap


def test_unpackers_match_jax():
    rng = np.random.default_rng(5)
    p6 = rng.integers(0, 256, (2, 3, 4, 96), dtype=np.uint8)
    assert_same_bits(TQ.unpack_kv_q6(torch.from_numpy(p6)).to(torch.int32),
                     JQ.unpack_kv_q6(jnp.asarray(p6)), "q6")
    p4 = rng.integers(-128, 128, (2, 3, 4, 64), dtype=np.int8)
    assert_same_bits(TQ.unpack_kv_nl4(torch.from_numpy(p4)),
                     JQ.unpack_kv_nl4(jnp.asarray(p4)), "nl4")
    assert TQ.IQ4NL_VALUES == JQ.IQ4NL_VALUES and TQ._IQ4NL_MIDS == JQ._IQ4NL_MIDS


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("codec", CODECS)
def test_kv_codec_of(codec, d):
    x = torch.from_numpy(rows(seed=6, d=d))
    tq, _ = TQ.KV_ENCODERS[codec](x)
    assert TQ.kv_codec_of(tq, d) == codec
    assert TQ.kv_codec_of(tq[None], d) == codec           # stacked cache
    assert tq.dtype == TQ.KV_CODEC_DTYPE[codec]
    assert tq.shape[-1] == TQ.KV_CODEC_WIDTH[codec](d)
    assert JQ.kv_codec_of(jnp.asarray(tq.numpy()), d) == codec


@pytest.mark.parametrize("d", [2, 64, 128])
def test_hadamard_matrix(d):
    hm = TQ.hadamard_matrix(d)
    np.testing.assert_array_equal(hm, np.asarray(JQ.hadamard_matrix(d)))
    np.testing.assert_allclose(hm @ hm.T, np.eye(d), atol=1e-5)     # orthogonal
    np.testing.assert_array_equal(hm, hm.T)                         # symmetric
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((3, 5, d)).astype(np.float32))
    back = TQ.hadamard_rotate(TQ.hadamard_rotate(x))                # involution
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hadamard_rotate_matches_jax(dtype):
    """A float32 product with the same constant matrix: sums in another
    order, so 1e-6 of the largest value; the bf16 result one bf16 ulp."""
    x = np.random.default_rng(7).standard_normal((2, 5, 3, 128)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    got = TQ.hadamard_rotate(tx)
    ref = np.asarray(JQ.hadamard_rotate(jx).astype(jnp.float32))
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def test_hadamard_needs_power_of_two():
    with pytest.raises(AssertionError, match="power-of-two"):
        TQ.hadamard_matrix(96)
    with pytest.raises(AssertionError, match="power-of-two"):
        TQ.hadamard_rotate(torch.zeros(2, 96))
