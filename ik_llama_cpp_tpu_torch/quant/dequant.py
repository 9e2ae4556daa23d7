"""Reference dequantizers: GGUF quant bytes -> float32, vectorized numpy.

These are the numerical oracles of the whole framework: every Pallas kernel
and every load-time repack is validated against them, and they themselves are
validated bit-for-bit against the reference C implementations
(ggml-quants.c `dequantize_row_*`, iqk_quantize.cpp `dequantize_row_*`)
via golden files in tests/golden/.

Conventions:
  * input  `data`: np.uint8 buffer of shape (nrows * row_bytes,) or
    (nrows, row_bytes) — the exact GGUF on-disk bytes;
  * `n` is the number of elements per row;
  * output: float32 of shape (nrows, n).

All bit-layout comments cite the reference implementation they mirror.
"""
from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, GEOMETRY, QK_K
from . import luts


def _rows(data: np.ndarray, ggml_type: GGMLType, n: int) -> np.ndarray:
    geom = GEOMETRY[ggml_type]
    rb = geom.row_bytes(n)
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1, rb)
    return data


def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian fp16 bytes (last dim even) as float32, halving the last dim."""
    return np.ascontiguousarray(b).view(np.float16).astype(np.float32)


def _f32le(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.float32)


def _u16le(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.uint16)


def _u32le(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.uint32)


def _i8(b: np.ndarray) -> np.ndarray:
    return b.view(np.int8)


# ---------------------------------------------------------------------------
# float / int passthrough
# ---------------------------------------------------------------------------

def dequant_f32(data, n):
    return _rows(data, GGMLType.F32, n).view(np.float32).reshape(-1, n).copy()


def dequant_f16(data, n):
    return _rows(data, GGMLType.F16, n).view(np.float16).reshape(-1, n).astype(np.float32)


def dequant_bf16(data, n):
    raw = _rows(data, GGMLType.BF16, n).view(np.uint16).reshape(-1, n)
    return (raw.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# legacy 32-element blocks
# ---------------------------------------------------------------------------

def dequant_q4_0(data, n):
    """ggml-quants.c:1581 — y[j]=d*((q&0xF)-8), y[j+16]=d*((q>>4)-8)."""
    b = _rows(data, GGMLType.Q4_0, n).reshape(-1, 18)
    d = _f16(b[:, :2])  # (nb,1)
    qs = b[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    y = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return y.reshape(-1, n)


def dequant_q4_1(data, n):
    b = _rows(data, GGMLType.Q4_1, n).reshape(-1, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    y = np.concatenate([lo, hi], axis=1) * d + m
    return y.reshape(-1, n)


def dequant_q5_0(data, n):
    """ggml-quants.c:1622 — 5th bits from a packed u32."""
    b = _rows(data, GGMLType.Q5_0, n).reshape(-1, 22)
    d = _f16(b[:, :2])
    qh = _u32le(b[:, 2:6]).astype(np.uint32)  # (nb,1)
    qs = b[:, 6:]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10
    xh1 = (qh >> (j + 12)) & 0x10
    lo = ((qs & 0x0F) | xh0.astype(np.uint8)).astype(np.int16) - 16
    hi = ((qs >> 4) | xh1.astype(np.uint8)).astype(np.int16) - 16
    y = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return y.reshape(-1, n)


def dequant_q5_1(data, n):
    b = _rows(data, GGMLType.Q5_1, n).reshape(-1, 24)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = _u32le(b[:, 4:8]).astype(np.uint32)
    qs = b[:, 8:]
    j = np.arange(16, dtype=np.uint32)
    xh0 = ((qh >> j) << 4) & 0x10
    xh1 = (qh >> (j + 12)) & 0x10
    lo = ((qs & 0x0F) | xh0.astype(np.uint8)).astype(np.float32)
    hi = ((qs >> 4) | xh1.astype(np.uint8)).astype(np.float32)
    y = np.concatenate([lo, hi], axis=1) * d + m
    return y.reshape(-1, n)


def dequant_q6_0(data, n):
    """ggml-quants.c:1675 — h=qh[j%8]>>4*(j/8); lo|=(h<<4)&0x30, hi|=(h<<2)&0x30."""
    b = _rows(data, GGMLType.Q6_0, n).reshape(-1, 26)
    d = _f16(b[:, :2])
    qh = b[:, 2:10]
    qs = b[:, 10:]
    h = np.concatenate([qh, qh >> 4], axis=1)  # h[j] for j in 0..15
    lo = ((qs & 0x0F) | ((h << 4) & 0x30)).astype(np.int16) - 32
    hi = ((qs >> 4) | ((h << 2) & 0x30)).astype(np.int16) - 32
    y = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return y.reshape(-1, n)


def dequant_q8_0(data, n):
    b = _rows(data, GGMLType.Q8_0, n).reshape(-1, 34)
    d = _f16(b[:, :2])
    y = _i8(b[:, 2:]).astype(np.float32) * d
    return y.reshape(-1, n)


def dequant_mxfp4(data, n):
    """block_mxfp4 (ggml-common.h:182): E8M0 shared exponent + e2m1 nibbles (doubled LUT)."""
    b = _rows(data, GGMLType.MXFP4, n).reshape(-1, 17)
    e = b[:, 0:1].astype(np.int32)
    # E8M0 exponent: value = 2^(e-127); LUT values are doubled e2m1 so halve once.
    d = (np.float32(2.0) ** (e - 127)).astype(np.float32) * np.float32(0.5)
    qs = b[:, 1:]
    lo = luts.KVALUES_MXFP4[qs & 0x0F].astype(np.float32)
    hi = luts.KVALUES_MXFP4[qs >> 4].astype(np.float32)
    y = np.concatenate([lo, hi], axis=1) * d
    return y.reshape(-1, n)


def dequant_iq4_nl(data, n):
    b = _rows(data, GGMLType.IQ4_NL, n).reshape(-1, 18)
    d = _f16(b[:, :2])
    qs = b[:, 2:]
    lo = luts.KVALUES_IQ4NL[qs & 0x0F].astype(np.float32)
    hi = luts.KVALUES_IQ4NL[qs >> 4].astype(np.float32)
    y = np.concatenate([lo, hi], axis=1) * d
    return y.reshape(-1, n)


# ---------------------------------------------------------------------------
# k-quants (256-element superblocks)
# ---------------------------------------------------------------------------

def _kscale_min(scales: np.ndarray):
    """get_scale_min_k4 (ggml-quants.c:2036) for all 8 sub-blocks at once.

    scales: (nb, 12) uint8 -> (sc, m): each (nb, 8) uint8.
    """
    q = scales
    sc = np.empty(q.shape[:-1] + (8,), dtype=np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = q[..., 0:4] & 63
    m[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0x0F) | ((q[..., 0:4] >> 6) << 4)
    m[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc, m


def dequant_q4_K(data, n):
    """ggml-quants.c:2797."""
    b = _rows(data, GGMLType.Q4_K, n).reshape(-1, 144)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, m = _kscale_min(b[:, 4:16])
    qs = b[:, 16:]  # (nb,128)
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for c in range(4):  # 64-element chunks
        blk = qs[:, c * 32:(c + 1) * 32]
        d1 = d * sc[:, 2 * c:2 * c + 1]
        m1 = dmin * m[:, 2 * c:2 * c + 1]
        d2 = d * sc[:, 2 * c + 1:2 * c + 2]
        m2 = dmin * m[:, 2 * c + 1:2 * c + 2]
        y[:, c * 64:c * 64 + 32] = (blk & 0x0F).astype(np.float32) * d1 - m1
        y[:, c * 64 + 32:c * 64 + 64] = (blk >> 4).astype(np.float32) * d2 - m2
    return y.reshape(-1, n)


def dequant_q5_K(data, n):
    """ggml-quants.c:3015."""
    b = _rows(data, GGMLType.Q5_K, n).reshape(-1, 176)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, m = _kscale_min(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for c in range(4):
        blk = qs[:, c * 32:(c + 1) * 32]
        u1 = np.uint8(1 << (2 * c))
        u2 = np.uint8(2 << (2 * c))
        q1 = (blk & 0x0F).astype(np.float32) + ((qh & u1) != 0) * np.float32(16)
        q2 = (blk >> 4).astype(np.float32) + ((qh & u2) != 0) * np.float32(16)
        y[:, c * 64:c * 64 + 32] = q1 * (d * sc[:, 2 * c:2 * c + 1]) - dmin * m[:, 2 * c:2 * c + 1]
        y[:, c * 64 + 32:c * 64 + 64] = q2 * (d * sc[:, 2 * c + 1:2 * c + 2]) - dmin * m[:, 2 * c + 1:2 * c + 2]
    return y.reshape(-1, n)


def dequant_q6_K(data, n):
    """ggml-quants.c:3231."""
    b = _rows(data, GGMLType.Q6_K, n).reshape(-1, 210)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = _i8(b[:, 192:208]).astype(np.float32)
    d = _f16(b[:, 208:210])
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for i128 in range(2):
        l_ = np.arange(32)
        qlb = ql[:, i128 * 64:]
        qhb = qh[:, i128 * 32:i128 * 32 + 32]
        q1 = ((qlb[:, :32] & 0x0F) | ((qhb & 0x03) << 4)).astype(np.int16) - 32
        q2 = ((qlb[:, 32:64] & 0x0F) | (((qhb >> 2) & 0x03) << 4)).astype(np.int16) - 32
        q3 = ((qlb[:, :32] >> 4) | (((qhb >> 4) & 0x03) << 4)).astype(np.int16) - 32
        q4 = ((qlb[:, 32:64] >> 4) | (((qhb >> 6) & 0x03) << 4)).astype(np.int16) - 32
        is_ = i128 * 8 + l_ // 16  # (32,) scale idx base
        for k, q in enumerate((q1, q2, q3, q4)):
            scale = sc[:, is_ + 2 * k]  # (nb,32)
            y[:, i128 * 128 + k * 32:i128 * 128 + (k + 1) * 32] = d * scale * q.astype(np.float32)
    return y.reshape(-1, n)


def dequant_q2_K(data, n):
    """ggml-quants.c:2162 — x = d*(sc&0xF)*q - dmin*(sc>>4)."""
    b = _rows(data, GGMLType.Q2_K, n).reshape(-1, 84)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for n128 in range(2):
        q = qs[:, n128 * 32:(n128 + 1) * 32]
        for j in range(4):
            q2 = (q >> (2 * j)) & 3  # (nb,32)
            for half in range(2):
                is_ = n128 * 8 + j * 2 + half
                dl = d * (scales[:, is_:is_ + 1] & 0x0F).astype(np.float32)
                ml = dmin * (scales[:, is_:is_ + 1] >> 4).astype(np.float32)
                sl = q2[:, half * 16:(half + 1) * 16].astype(np.float32)
                o = n128 * 128 + j * 32 + half * 16
                y[:, o:o + 16] = dl * sl - ml
    return y.reshape(-1, n)


def _q3k_scales(raw: np.ndarray) -> np.ndarray:
    """Unpack q3_K 12-byte packed 6-bit scales -> (nb,16) int8-32 (ggml-quants.c:2563)."""
    a = _u32le(raw)  # (nb,3)
    km1, km2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    tmp = a[:, 2]
    out = np.empty((raw.shape[0], 4), dtype=np.uint32)
    out[:, 0] = (a[:, 0] & km2) | (((tmp >> 0) & km1) << 4)
    out[:, 1] = (a[:, 1] & km2) | (((tmp >> 2) & km1) << 4)
    out[:, 2] = ((a[:, 0] >> 4) & km2) | (((tmp >> 4) & km1) << 4)
    out[:, 3] = ((a[:, 1] >> 4) & km2) | (((tmp >> 6) & km1) << 4)
    return out.view(np.int8).astype(np.int16) - 32  # (nb,16)


def dequant_q3_K(data, n):
    b = _rows(data, GGMLType.Q3_K, n).reshape(-1, 110)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    sc16 = _q3k_scales(b[:, 96:108]).astype(np.float32)
    d = _f16(b[:, 108:110])
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for n128 in range(2):
        q = qs[:, n128 * 32:(n128 + 1) * 32]
        for j in range(4):
            mbit = np.uint8(1 << (n128 * 4 + j))
            q2 = ((q >> (2 * j)) & 3).astype(np.int16)
            hi = ((hmask & mbit) == 0) * np.int16(4)
            q3 = (q2 - hi).astype(np.float32)
            for half in range(2):
                is_ = n128 * 8 + j * 2 + half
                dl = d * sc16[:, is_:is_ + 1]
                o = n128 * 128 + j * 32 + half * 16
                y[:, o:o + 16] = dl * q3[:, half * 16:(half + 1) * 16]
    return y.reshape(-1, n)


def dequant_iq4_xs(data, n):
    """ggml-quants.c:3931."""
    b = _rows(data, GGMLType.IQ4_XS, n).reshape(-1, 136)
    d = _f16(b[:, 0:2])
    scales_h = _u16le(b[:, 2:4]).astype(np.uint16)  # (nb,1)
    scales_l = b[:, 4:8]
    qs = b[:, 8:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for ib in range(8):
        ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F).astype(np.int32) \
            | (((scales_h[:, 0] >> (2 * ib)) & 3).astype(np.int32) << 4)
        dl = d[:, 0] * (ls - 32)
        blk = qs[:, 16 * ib:16 * (ib + 1)]
        y[:, 32 * ib:32 * ib + 16] = luts.KVALUES_IQ4NL[blk & 0x0F] * dl[:, None]
        y[:, 32 * ib + 16:32 * ib + 32] = luts.KVALUES_IQ4NL[blk >> 4] * dl[:, None]
    return y.reshape(-1, n)


# ---------------------------------------------------------------------------
# IQK non-linear quants (ik_llama.cpp; iqk_quantize.cpp)
# ---------------------------------------------------------------------------

def dequant_iq2_k(data, n):
    """iqk_quantize.cpp:1356."""
    b = _rows(data, GGMLType.IQ2_K, n).reshape(-1, 76)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    scales = b[:, 4:12]
    qs = b[:, 12:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for ib32 in range(8):
        blk = qs[:, 32 * (ib32 // 4):32 * (ib32 // 4) + 32]
        q2 = (blk >> (2 * (ib32 % 4))) & 3
        dl1 = d * np.asarray(((scales[:, ib32] & 0x0F).astype(np.int32) - 8), dtype=np.float32)
        dl2 = d * np.asarray(((scales[:, ib32] >> 4).astype(np.int32) - 8), dtype=np.float32)
        off1 = ((extra >> (2 * ib32)) & 1) * 4
        off2 = ((extra >> (2 * ib32 + 1)) & 1) * 4
        v1 = luts.IQ2NL_VALUES[q2[:, :16] + off1[:, None]].astype(np.float32)
        v2 = luts.IQ2NL_VALUES[q2[:, 16:] + off2[:, None]].astype(np.float32)
        y[:, 32 * ib32:32 * ib32 + 16] = dl1[:, None] * v1
        y[:, 32 * ib32 + 16:32 * ib32 + 32] = dl2[:, None] * v2
    return y.reshape(-1, n)


def dequant_iq2_ks(data, n):
    """iqk_quantize.cpp:1877 — row-level f16 scale header."""
    geom = GEOMETRY[GGMLType.IQ2_KS]
    rows = _rows(data, GGMLType.IQ2_KS, n)
    d = _f16(rows[:, 0:2])[:, 0]  # (nrows,)
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 70)
    extra = _u16le(blocks[..., 0:2]).astype(np.int32)[..., 0]  # (nr, nb)
    scales = blocks[..., 2:6]
    qs = blocks[..., 6:]
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib64 in range(4):
        sh = extra >> (2 * ib64)
        ls1 = d[:, None] * np.asarray((((scales[..., ib64] & 0x0F).astype(np.int32) | ((sh >> 4) & 0x10)) - 16), dtype=np.float32)
        ls2 = d[:, None] * np.asarray((((scales[..., ib64] >> 4).astype(np.int32) | ((sh >> 5) & 0x10)) - 16), dtype=np.float32)
        off1 = (sh & 1) * 4
        off2 = ((sh >> 1) & 1) * 4
        blk = qs[..., 32 * (ib64 // 2):32 * (ib64 // 2) + 32]
        shift = 4 * (ib64 % 2)
        q1 = (blk >> shift) & 3
        q2 = (blk >> (shift + 2)) & 3
        v1 = luts.IQ2NL_VALUES[q1 + off1[..., None]].astype(np.float32)
        v2 = luts.IQ2NL_VALUES[q2 + off2[..., None]].astype(np.float32)
        y[..., 64 * ib64:64 * ib64 + 32] = ls1[..., None] * v1
        y[..., 64 * ib64 + 32:64 * ib64 + 64] = ls2[..., None] * v2
    return y.reshape(rows.shape[0], n)


def dequant_iq2_kl(data, n):
    """iqk_quantize.cpp:2243 — 5-bit index into a table of int8 *pairs*."""
    rows = _rows(data, GGMLType.IQ2_KL, n)
    d = _f16(rows[:, 0:2])[:, 0]
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 86)
    scales_h = _u16le(blocks[..., 0:2]).astype(np.int32)[..., 0]
    scales_l = blocks[..., 2:6]
    qs = blocks[..., 6:70]
    qh = blocks[..., 70:86]
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib64 in range(4):
        sl1 = (scales_l[..., (2 * ib64) % 4] >> (4 * (ib64 // 2))) & 0x0F
        sl2 = (scales_l[..., (2 * ib64 + 1) % 4] >> (4 * (ib64 // 2))) & 0x0F
        dl1 = d[:, None] * np.asarray(((sl1.astype(np.int32) | (((scales_h >> (4 * ib64)) & 3) << 4)) - 32), dtype=np.float32)
        dl2 = d[:, None] * np.asarray(((sl2.astype(np.int32) | (((scales_h >> (4 * ib64 + 2)) & 3) << 4)) - 32), dtype=np.float32)
        blk = qs[..., 16 * ib64:16 * ib64 + 16]
        idx1 = (blk & 0x0F).astype(np.int32) | (((qh >> (2 * ib64)) & 1).astype(np.int32) << 4)
        idx2 = (blk >> 4).astype(np.int32) | (((qh >> (2 * ib64 + 1)) & 1).astype(np.int32) << 4)
        pair1 = luts.IQ2KL_PAIRS[idx1].astype(np.float32)  # (...,16,2)
        pair2 = luts.IQ2KL_PAIRS[idx2].astype(np.float32)
        y[..., 64 * ib64:64 * ib64 + 32] = (dl1[..., None, None] * pair1).reshape(nr, nb, 32)
        y[..., 64 * ib64 + 32:64 * ib64 + 64] = (dl2[..., None, None] * pair2).reshape(nr, nb, 32)
    return y.reshape(rows.shape[0], n)


def dequant_iq3_k(data, n):
    """iqk_quantize.cpp:2534."""
    b = _rows(data, GGMLType.IQ3_K, n).reshape(-1, 110)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    sh = _u16le(b[:, 4:6]).astype(np.int32)[:, 0]
    scales_l = b[:, 6:14]
    qs = b[:, 14:78]
    qh = b[:, 78:110]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for ib32 in range(8):
        sgn1 = np.where((sh >> (2 * ib32)) & 1, -1.0, 1.0).astype(np.float32)
        sgn2 = np.where((sh >> (2 * ib32 + 1)) & 1, -1.0, 1.0).astype(np.float32)
        dl1 = d * (2 * (scales_l[:, ib32] & 0x0F).astype(np.float32) + 1) * sgn1
        dl2 = d * (2 * (scales_l[:, ib32] >> 4).astype(np.float32) + 1) * sgn2
        off1 = ((extra >> (2 * ib32)) & 1) * 8
        off2 = ((extra >> (2 * ib32 + 1)) & 1) * 8
        blk = qs[:, 32 * (ib32 // 4):32 * (ib32 // 4) + 32]
        shift_l = 2 * (ib32 % 4)
        hbit = (qh >> (ib32 % 8)) & 1
        q3 = ((blk >> shift_l) & 3).astype(np.int32) | (hbit.astype(np.int32) << 2)
        v1 = luts.IQ3NL_VALUES[q3[:, :16] + off1[:, None]].astype(np.float32)
        v2 = luts.IQ3NL_VALUES[q3[:, 16:] + off2[:, None]].astype(np.float32)
        y[:, 32 * ib32:32 * ib32 + 16] = dl1[:, None] * v1
        y[:, 32 * ib32 + 16:32 * ib32 + 32] = dl2[:, None] * v2
    return y.reshape(-1, n)


def dequant_iq3_ks(data, n):
    """iqk_quantize.cpp:2774 — row f16 header."""
    rows = _rows(data, GGMLType.IQ3_KS, n)
    d = _f16(rows[:, 0:2])[:, 0]
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 102)
    extra = _u16le(blocks[..., 0:2]).astype(np.int32)[..., 0]
    scales = blocks[..., 2:6]
    qs = blocks[..., 6:70]
    qh = blocks[..., 70:102]
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    dl = np.empty((nr, nb, 8), dtype=np.float32)
    for j in range(4):
        ls1 = (scales[..., j] & 0x0F).astype(np.int32) | (((extra >> j) & 1) << 4)
        ls2 = (scales[..., j] >> 4).astype(np.int32) | (((extra >> (j + 4)) & 1) << 4)
        dl[..., j] = d[:, None] * np.asarray(ls1 - 16, dtype=np.float32)
        dl[..., j + 4] = d[:, None] * np.asarray(ls2 - 16, dtype=np.float32)
    for i128 in range(2):
        blk = qs[..., 32 * i128:32 * i128 + 32]
        for ib in range(4):
            k = 4 * i128 + ib
            off = ((extra >> (8 + k)) & 1) * 8
            q3 = ((blk >> (2 * ib)) & 3).astype(np.int32) | (((qh >> k) & 1).astype(np.int32) << 2)
            v = luts.IQ3NL_VALUES[q3 + off[..., None]].astype(np.float32)
            y[..., 32 * k:32 * k + 32] = dl[..., k:k + 1] * v
    return y.reshape(rows.shape[0], n)


def dequant_iq4_k(data, n):
    """iqk_quantize.cpp:2822."""
    b = _rows(data, GGMLType.IQ4_K, n).reshape(-1, 144)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    scales_h = b[:, 4:8]
    scales_l = b[:, 8:16]
    qs = b[:, 16:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for ib in range(8):
        sh = (scales_h[:, ib // 2] >> (4 * (ib % 2))).astype(np.int32)
        dl1 = d * np.asarray((((scales_l[:, ib] & 0x0F).astype(np.int32) | ((sh << 4) & 0x30)) - 32), dtype=np.float32)
        dl2 = d * np.asarray((((scales_l[:, ib] >> 4).astype(np.int32) | ((sh << 2) & 0x30)) - 32), dtype=np.float32)
        off1 = ((extra >> (2 * ib)) & 1) * 16
        off2 = ((extra >> (2 * ib + 1)) & 1) * 16
        blk = qs[:, 16 * ib:16 * (ib + 1)]
        v1 = luts.IQ4K_VALUES[(blk & 0x0F) + off1[:, None]].astype(np.float32)
        v2 = luts.IQ4K_VALUES[(blk >> 4) + off2[:, None]].astype(np.float32)
        y[:, 32 * ib:32 * ib + 16] = dl1[:, None] * v1
        y[:, 32 * ib + 16:32 * ib + 32] = dl2[:, None] * v2
    return y.reshape(-1, n)


def dequant_iq4_ks(data, n):
    """iqk_quantize.cpp:4555 — row f32 scale; per-32 scale byte: 7 bits scale, 1 bit LUT select."""
    rows = _rows(data, GGMLType.IQ4_KS, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 136)
    scales = blocks[..., 0:8]
    qs = blocks[..., 8:]
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib in range(8):
        dl = d[:, None] * np.asarray(((scales[..., ib] & 254).astype(np.int32) - 127), dtype=np.float32)
        off = (scales[..., ib] & 1).astype(np.int32) * 16
        blk = qs[..., 16 * ib:16 * (ib + 1)]
        v1 = luts.IQ4K_VALUES[(blk & 0x0F) + off[..., None]].astype(np.float32)
        v2 = luts.IQ4K_VALUES[(blk >> 4) + off[..., None]].astype(np.float32)
        y[..., 32 * ib:32 * ib + 16] = dl[..., None] * v1
        y[..., 32 * ib + 16:32 * ib + 32] = dl[..., None] * v2
    return y.reshape(rows.shape[0], n)


def dequant_iq4_kss(data, n):
    """iqk_quantize.cpp:5161 — scale bits spread over the low bit of 8 u32 words."""
    rows = _rows(data, GGMLType.IQ4_KSS, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 128)
    qs = _u16le(blocks.reshape(rows.shape[0], -1)).reshape(rows.shape[0], -1, 64)
    nr, nb = qs.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib in range(8):
        w = qs[..., 8 * ib:8 * ib + 8]  # (nr, nb, 8) u16
        aux16 = (w & np.uint16(0xFFFE)).astype(np.uint16)
        aux16 ^= aux16 >> 1
        lsbits = (w & 1).astype(np.int32)
        ls = np.zeros(lsbits.shape[:-1], dtype=np.int32)
        for k in range(8):
            ls |= lsbits[..., k] << k
        aux8 = aux16.view(np.uint8).reshape(nr, nb, 16)
        dl = d[:, None] * np.asarray(((ls & 254) - 127), dtype=np.float32)
        off = (ls & 1) * 16
        v1 = luts.IQ4K_VALUES[(aux8 & 0x0F) + off[..., None]].astype(np.float32)
        v2 = luts.IQ4K_VALUES[(aux8 >> 4) + off[..., None]].astype(np.float32)
        y[..., 32 * ib:32 * ib + 16] = dl[..., None] * v1
        y[..., 32 * ib + 16:32 * ib + 32] = dl[..., None] * v2
    return y.reshape(rows.shape[0], n)


def dequant_iq5_k(data, n):
    """iqk_quantize.cpp:3112."""
    b = _rows(data, GGMLType.IQ5_K, n).reshape(-1, 176)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    scales_h = b[:, 4:8]
    scales_l = b[:, 8:16]
    qs = b[:, 16:144]
    qh = b[:, 144:176]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for ib64 in range(4):
        shift = 2 * ib64
        sl0 = scales_l[:, 2 * ib64].astype(np.int32)
        sl1 = scales_l[:, 2 * ib64 + 1].astype(np.int32)
        shh = scales_h[:, ib64].astype(np.int32)
        dls = [((sl0 & 0x0F) | ((shh << 4) & 0x30)) - 32,
               ((sl0 >> 4) | ((shh << 2) & 0x30)) - 32,
               ((sl1 & 0x0F) | ((shh >> 0) & 0x30)) - 32,
               ((sl1 >> 4) | ((shh >> 2) & 0x30)) - 32]
        offs = [((extra >> (4 * ib64 + k)) & 1) * 32 for k in range(4)]
        blkA = qs[:, 32 * ib64:32 * ib64 + 16]
        blkB = qs[:, 32 * ib64 + 16:32 * ib64 + 32]
        hA = qh[:, 0:16]
        hB = qh[:, 16:32]
        q = [
            (blkA & 0x0F).astype(np.int32) | (((hA >> shift) & 1).astype(np.int32) << 4),
            (blkB & 0x0F).astype(np.int32) | (((hB >> shift) & 1).astype(np.int32) << 4),
            (blkA >> 4).astype(np.int32) | (((hA >> shift) & 2).astype(np.int32) << 3),
            (blkB >> 4).astype(np.int32) | (((hB >> shift) & 2).astype(np.int32) << 3),
        ]
        for k in range(4):
            v = luts.IQ5NL_VALUES[q[k] + offs[k][:, None]].astype(np.float32)
            o = 64 * ib64 + 16 * k
            y[:, o:o + 16] = (d * dls[k])[:, None] * v
    return y.reshape(-1, n)


def dequant_iq5_ks(data, n):
    """iqk_quantize.cpp:4798 — row f32 scale."""
    rows = _rows(data, GGMLType.IQ5_KS, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 168)
    scales = blocks[..., 0:8]
    qs = blocks[..., 8:136]
    qh = blocks[..., 136:168]
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib64 in range(4):
        s1 = scales[..., 2 * ib64].astype(np.int32)
        s2 = scales[..., 2 * ib64 + 1].astype(np.int32)
        dl1 = d[:, None] * np.asarray(((s1 & 254) - 127), dtype=np.float32)
        dl2 = d[:, None] * np.asarray(((s2 & 254) - 127), dtype=np.float32)
        off1 = (s1 & 1) * 32
        off2 = (s2 & 1) * 32
        blk = qs[..., 32 * ib64:32 * ib64 + 32]
        q1 = (blk & 0x0F).astype(np.int32) | (((qh >> (2 * ib64)) & 1).astype(np.int32) << 4)
        q2 = (blk >> 4).astype(np.int32) | (((qh >> (2 * ib64 + 1)) & 1).astype(np.int32) << 4)
        v1 = luts.IQ5NL_VALUES[q1 + off1[..., None]].astype(np.float32)
        v2 = luts.IQ5NL_VALUES[q2 + off2[..., None]].astype(np.float32)
        y[..., 64 * ib64:64 * ib64 + 32] = dl1[..., None] * v1
        y[..., 64 * ib64 + 32:64 * ib64 + 64] = dl2[..., None] * v2
    return y.reshape(rows.shape[0], n)


def dequant_iq6_k(data, n):
    """iqk_quantize.cpp:3448 — cubic-polynomial codebook."""
    b = _rows(data, GGMLType.IQ6_K, n).reshape(-1, 212)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    sl = _i8(b[:, 4:20]).astype(np.float32)
    qs = b[:, 20:148]
    qh = b[:, 148:212]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), dtype=np.float32)
    A = np.float32(luts.IQ6K_A)
    B = np.float32(luts.IQ6K_B)
    C = np.float32(luts.IQ6K_C)
    D = np.float32(luts.IQ6K_D)
    S = np.float32(luts.IQ6K_S)
    for ib64 in range(4):
        shift = 4 * (ib64 % 2)
        qhb = qh[:, 32 * (ib64 // 2):32 * (ib64 // 2) + 32]
        blkA = qs[:, 32 * ib64:32 * ib64 + 16]
        blkB = qs[:, 32 * ib64 + 16:32 * ib64 + 32]
        hA, hB = qhb[:, 0:16], qhb[:, 16:32]
        q = [
            ((blkA & 0x0F) | (((hA >> shift) & 0x03) << 4)).astype(np.float32),
            ((blkB & 0x0F) | (((hB >> shift) & 0x03) << 4)).astype(np.float32),
            ((blkA >> 4) | (((hA >> shift) & 0x0C) << 2)).astype(np.float32),
            ((blkB >> 4) | (((hB >> shift) & 0x0C) << 2)).astype(np.float32),
        ]
        for k in range(4):
            dl = d * sl[:, 4 * ib64 + k]
            m = ((extra >> (4 * ib64 + k)) & 1).astype(np.float32) * S
            qq = q[k].astype(np.float64)
            # gcc -O3 contracts the Horner chain into FMAs; emulate each
            # fma(q, t, c) as an exact f64 mul-add rounded once to f32
            t = (qq * np.float64(D) - np.float64(C)).astype(np.float32)
            t = (qq * t.astype(np.float64) + np.float64(B)).astype(np.float32)
            t = (qq * t.astype(np.float64) + np.float64(A)).astype(np.float32)
            val = t + m[:, None]
            o = 64 * ib64 + 16 * k
            y[:, o:o + 16] = dl[:, None] * val
    return y.reshape(-1, n)


# ---------------------------------------------------------------------------
# KT trellis quants (integer "3INST" generator; iqk_quantize.cpp:8626-8653)
# ---------------------------------------------------------------------------

_KT_MULT = np.uint32(0xCBAC1FED)


def _kt_values(idx: np.ndarray, group_size: int) -> np.ndarray:
    """Trellis codebook values for indices (already offset): (..., group_size) f32.

    x_{k+1} = 0xCBAC1FED * x_k (mod 2^32); v_k = sum of 4 bytes of
    (x_{k+1} & 0x3f3f3f3f) - 126.
    """
    x = idx.astype(np.uint32)
    out = np.empty(idx.shape + (group_size,), dtype=np.float32)
    for k in range(group_size):
        x = x * _KT_MULT
        s = x & np.uint32(0x3F3F3F3F)
        tot = (s & 0xFF) + ((s >> 8) & 0xFF) + ((s >> 16) & 0xFF) + ((s >> 24) & 0xFF)
        out[..., k] = tot.astype(np.float32) - 126.0
    return out


def dequant_iq1_kt(data, n):
    """iqk_quantize.cpp:9470 — 13-bit trellis indices, iq4k block scales."""
    rows = _rows(data, GGMLType.IQ1_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 56)
    sh = blocks[..., 0:8]
    ql = blocks[..., 8:40]
    qh = blocks[..., 40:56]
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib in range(8):  # kNblock=8 blocks of 32
        sl = d[:, None] * luts.IQ4K_VALUES[sh[..., ib] & 0x0F].astype(np.float32)
        for ig in range(4):  # kNg=4 groups of 8
            idx = ql[..., ib * 4 + ig].astype(np.int32) \
                | ((qh[..., (ib % 4) * 4 + ig].astype(np.int32) << (8 - 4 * (ib // 4))) & 0xF00) \
                | ((sh[..., ib].astype(np.int32) << (8 - ig)) & 0x1000)
            vals = _kt_values(idx + 4096, 8)
            o = ib * 32 + ig * 8
            y[..., o:o + 8] = sl[..., None] * vals
    return y.reshape(rows.shape[0], n)


def dequant_iq2_kt(data, n):
    """iqk_quantize.cpp:9751 — 16-bit trellis indices, iq4k nibble scales."""
    rows = _rows(data, GGMLType.IQ2_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 68)
    scales = blocks[..., 0:4]
    ql = _u16le(blocks[..., 4:68])  # (nr, nb, 32)
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib in range(4):  # kNblock/2
        sl = d[:, None] * luts.IQ4K_VALUES[scales[..., ib] & 0x0F].astype(np.float32)
        shi = d[:, None] * luts.IQ4K_VALUES[scales[..., ib] >> 4].astype(np.float32)
        for ig in range(4):
            idx_l = ql[..., ib * 4 + ig].astype(np.int32)
            idx_h = ql[..., 16 + ib * 4 + ig].astype(np.int32)
            ol = ib * 32 + ig * 8
            y[..., ol:ol + 8] = sl[..., None] * _kt_values(idx_l + 4096, 8)
            y[..., 128 + ol:128 + ol + 8] = shi[..., None] * _kt_values(idx_h + 4096, 8)
    return y.reshape(rows.shape[0], n)


def dequant_iq3_kt(data, n):
    """iqk_quantize.cpp:10021 — |trellis| magnitudes with separate sign bits."""
    rows = _rows(data, GGMLType.IQ3_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 100)
    scales = blocks[..., 0:4]
    ql = _u16le(blocks[..., 4:68])
    qh = blocks[..., 68:100]  # 32 sign-bit bytes
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib in range(4):
        sl = d[:, None] * (scales[..., ib] & 0x0F).astype(np.float32)
        shi = d[:, None] * (scales[..., ib] >> 4).astype(np.float32)
        for ig in range(4):
            idx_l = ql[..., ib * 4 + ig].astype(np.int32)
            idx_h = ql[..., 16 + ib * 4 + ig].astype(np.int32)
            vl = np.abs(_kt_values(idx_l + 4096, 8))
            vh = np.abs(_kt_values(idx_h + 4096, 8))
            sbits = qh[..., ig * 8:(ig + 1) * 8]
            sgn_l = np.where((sbits >> ib) & 1, -1.0, 1.0).astype(np.float32)
            sgn_h = np.where((sbits >> (ib + 4)) & 1, -1.0, 1.0).astype(np.float32)
            ol = ib * 32 + ig * 8
            y[..., ol:ol + 8] = sl[..., None] * vl * sgn_l
            y[..., 128 + ol:128 + ol + 8] = shi[..., None] * vh * sgn_h
    return y.reshape(rows.shape[0], n)


def dequant_iq4_kt(data, n):
    """iqk_quantize.cpp:10286 — 15-bit trellis indices, groups of 4."""
    rows = _rows(data, GGMLType.IQ4_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 128)
    shb = _u32le(blocks[..., 0:32])  # (nr, nb, 8)
    ql = blocks[..., 32:96].astype(np.int32)   # 64 low bytes
    qh = blocks[..., 96:128].astype(np.int32)  # 32 high-nibble bytes
    nr, nb = blocks.shape[:2]
    y = np.empty((nr, nb, QK_K), dtype=np.float32)
    for ib in range(8):
        word = shb[..., ib].astype(np.int64)
        offset = np.where(word & 1, 32768 + 4096, 4096).astype(np.int32)
        ls = ((word & 0xFF) >> 1).astype(np.int32) - 64
        sl = d[:, None] * ls.astype(np.float32)
        for ig in range(8):  # kNg = 8 groups of 4
            jj = ib * 8 + ig
            idx = ql[..., jj] | ((qh[..., jj % 32] << (8 - 4 * (jj // 32))) & 0xF00) \
                | (((word >> (8 + 3 * ig)) & 7).astype(np.int32) << 12)
            vals = _kt_values(idx + offset, 4)
            o = ib * 32 + ig * 4
            y[..., o:o + 4] = sl[..., None] * vals
    return y.reshape(rows.shape[0], n)


# ---------------------------------------------------------------------------
# Q8_KV — per-row 8-bit (iqk_quantize.cpp:8399)
# ---------------------------------------------------------------------------

def dequant_q8_kv(data, n):
    rows = _rows(data, GGMLType.Q8_KV, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    q = _i8(rows[:, 8:]).astype(np.float32)
    return q * d[:, None]


def dequant_iq1_bn(data: np.ndarray, n_per_row: int) -> np.ndarray:
    """BitNet 1.625 bpw ternary (iqk_quantize.cpp quantize_one_row_1bn /
    dequantize_row_iq1_bn): row = f16 scale + 13-byte blocks of 64; each
    block packs 4x(3 base-243 bytes -> 15 trits) + extra byte -> 16th trit
    per 16-group. Values in {-1, 0, +1} * row scale."""
    rows = data.reshape(-1, GEOMETRY[GGMLType.IQ1_BN].row_bytes(n_per_row))
    d = rows[:, :2].copy().view(np.float16).astype(np.float32)    # (R, 1)
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 13)
    ql = blocks[:, :, :12].reshape(rows.shape[0], -1, 4, 3)       # (R,NB,4,3)
    extra = blocks[:, :, 12]                                      # (R,NB)
    k_mult = np.array([81, 27, 9, 3, 1], np.uint8)
    # v = ql * k_mult[j] (uint8 wrap); trit = ((v + (v>>1)) >> 7) - 1
    v = (ql[..., None] * k_mult).astype(np.uint8).astype(np.uint16)  # (R,NB,4,3,5)
    trits = (((v + (v >> 1)) >> 7).astype(np.int8) - 1)           # in {-1,0,1}
    # extra's k_mult index is the 16-group index i16 (0..3)
    ve = (extra[..., None] * k_mult[None, None, :4]).astype(np.uint8).astype(np.uint16)
    te = (((ve + (ve >> 1)) >> 7).astype(np.int8) - 1)
    out = np.empty((rows.shape[0], blocks.shape[1], 4, 16), np.float32)
    out[..., :15] = trits.reshape(rows.shape[0], -1, 4, 15)
    out[..., 15] = te
    return (out.reshape(rows.shape[0], -1) * d).astype(np.float32)


def dequant_iq2_bn(data: np.ndarray, n_per_row: int) -> np.ndarray:
    """BitNet 2.0 bpw ternary (dequantize_row_iq2_bn): row = f32 scale +
    16-byte blocks of 64; 4 bit-planes of 2-bit codes, value = code - 1."""
    rows = data.reshape(-1, GEOMETRY[GGMLType.IQ2_BN].row_bytes(n_per_row))
    d = rows[:, :4].copy().view(np.float32).astype(np.float32)    # (R, 1)
    qs = rows[:, 4:].reshape(rows.shape[0], -1, 16)               # (R,NB,16)
    out = np.empty((rows.shape[0], qs.shape[1], 4, 16), np.float32)
    out[..., 0, :] = (qs & 0x03) - 1.0
    out[..., 1, :] = ((qs >> 2) & 0x03) - 1.0
    out[..., 2, :] = ((qs >> 4) & 0x03) - 1.0
    out[..., 3, :] = ((qs >> 6) & 0x03) - 1.0
    return (out.reshape(rows.shape[0], -1) * d).astype(np.float32)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

DEQUANT_FNS = {
    GGMLType.F32: dequant_f32,
    GGMLType.F16: dequant_f16,
    GGMLType.BF16: dequant_bf16,
    GGMLType.Q4_0: dequant_q4_0,
    GGMLType.Q4_1: dequant_q4_1,
    GGMLType.Q5_0: dequant_q5_0,
    GGMLType.Q5_1: dequant_q5_1,
    GGMLType.Q6_0: dequant_q6_0,
    GGMLType.Q8_0: dequant_q8_0,
    GGMLType.MXFP4: dequant_mxfp4,
    GGMLType.IQ1_BN: dequant_iq1_bn,
    GGMLType.IQ2_BN: dequant_iq2_bn,
    GGMLType.Q2_K: dequant_q2_K,
    GGMLType.Q3_K: dequant_q3_K,
    GGMLType.Q4_K: dequant_q4_K,
    GGMLType.Q5_K: dequant_q5_K,
    GGMLType.Q6_K: dequant_q6_K,
    GGMLType.IQ4_NL: dequant_iq4_nl,
    GGMLType.IQ4_XS: dequant_iq4_xs,
    GGMLType.IQ2_K: dequant_iq2_k,
    GGMLType.IQ2_KS: dequant_iq2_ks,
    GGMLType.IQ2_KL: dequant_iq2_kl,
    GGMLType.IQ3_K: dequant_iq3_k,
    GGMLType.IQ3_KS: dequant_iq3_ks,
    GGMLType.IQ4_K: dequant_iq4_k,
    GGMLType.IQ4_KS: dequant_iq4_ks,
    GGMLType.IQ4_KSS: dequant_iq4_kss,
    GGMLType.IQ5_K: dequant_iq5_k,
    GGMLType.IQ5_KS: dequant_iq5_ks,
    GGMLType.IQ6_K: dequant_iq6_k,
    GGMLType.IQ1_KT: dequant_iq1_kt,
    GGMLType.IQ2_KT: dequant_iq2_kt,
    GGMLType.IQ3_KT: dequant_iq3_kt,
    GGMLType.IQ4_KT: dequant_iq4_kt,
    GGMLType.Q8_KV: dequant_q8_kv,
}


def dequantize(data: np.ndarray, ggml_type: GGMLType, n_per_row: int) -> np.ndarray:
    """Dequantize raw GGUF tensor bytes -> float32 rows (nrows, n_per_row)."""
    fn = DEQUANT_FNS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"dequantize: unsupported ggml type {ggml_type!r}")
    # Fuzzed/garbage blocks can hold f16 scales that decode to inf/NaN; the
    # products legitimately propagate non-finite values exactly like the
    # reference's C decoders (no FP traps there either). Silencing numpy's
    # over/invalid warnings here keeps the suite's warning channel clear for
    # REAL masked-NaN bugs. Golden tests compare the full output, so a wrong
    # non-finite pattern would still fail.
    with np.errstate(over="ignore", invalid="ignore"):
        return fn(data, n_per_row)
