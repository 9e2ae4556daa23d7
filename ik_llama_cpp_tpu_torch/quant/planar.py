"""Planar decode: GGUF quant bytes -> (int8 codes, f32 group scales[, bias]).

This is the TPU-native replacement for the reference's row-interleaved
`_R4/_R8` repacking (`iqk_repack_tensor`, iqk_quantize.h:327): instead of
re-ordering bytes for SIMD lanes, every supported format is decoded ONCE at
load time into a canonical planar layout that maps directly onto TPU tiles:

    w[r, k] = codes[r, k] * scale[r, k // G]  (+ bias[r, k // G])

with codes int8 (LUT lookups already applied, so non-linear codebooks become
plain integers) and scale/bias float32. G is 16 or 32 depending on the
format's native sub-block size. The Pallas fused dequant-matmul consumes
this, and `planar_dequant` reproduces `dequant.dequantize` exactly (tested).

Formats whose codebooks are not integral (IQ6_K's cubic polynomial) fall
back to float repack (handled by the loader, not here).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gguf.constants import GGMLType, GEOMETRY, QK_K
from . import luts
from .dequant import (
    _rows, _f16, _f32le, _u16le, _u32le, _i8, _kt_values, _q3k_scales, _kscale_min,
)


@dataclass
class PlanarWeight:
    """Canonical planar quantized rows (numpy, row-major: (nrows, K))."""

    codes: np.ndarray              # int8 (nrows, K)
    scale: np.ndarray              # float32 (nrows, K // group)
    bias: np.ndarray | None        # float32 (nrows, K // group) or None
    group: int

    def dequant(self) -> np.ndarray:
        g = self.group
        nr, k = self.codes.shape
        s = np.repeat(self.scale, g, axis=1)
        # garbage/fuzz blocks decode to inf/NaN scales; propagate silently
        # like the reference C decoders (see dequant.dequantize)
        with np.errstate(over="ignore", invalid="ignore"):
            y = self.codes.astype(np.float32) * s
            if self.bias is not None:
                y += np.repeat(self.bias, g, axis=1)
        return y


# ---------------------------------------------------------------------------
# legacy formats (32-element blocks -> G=32)
# ---------------------------------------------------------------------------

def planar_q8_0(data, n):
    b = _rows(data, GGMLType.Q8_0, n).reshape(-1, 34)
    d = _f16(b[:, :2])
    codes = _i8(b[:, 2:]).copy()
    return codes.reshape(-1, n), d.reshape(-1, n // 32), None, 32


def planar_q4_0(data, n):
    b = _rows(data, GGMLType.Q4_0, n).reshape(-1, 18)
    d = _f16(b[:, :2])
    qs = b[:, 2:]
    codes = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.int8) - 8
    return codes.reshape(-1, n), d.reshape(-1, n // 32), None, 32


def planar_q4_1(data, n):
    b = _rows(data, GGMLType.Q4_1, n).reshape(-1, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:]
    codes = np.concatenate([(qs & 0x0F), (qs >> 4)], axis=1).astype(np.int8)
    return codes.reshape(-1, n), d.reshape(-1, n // 32), m.reshape(-1, n // 32), 32


def planar_q5_0(data, n):
    b = _rows(data, GGMLType.Q5_0, n).reshape(-1, 22)
    d = _f16(b[:, :2])
    qh = _u32le(b[:, 2:6]).astype(np.uint32)
    qs = b[:, 6:]
    j = np.arange(16, dtype=np.uint32)
    xh0 = (((qh >> j) << 4) & 0x10).astype(np.uint8)
    xh1 = ((qh >> (j + 12)) & 0x10).astype(np.uint8)
    lo = ((qs & 0x0F) | xh0).astype(np.int8) - 16
    hi = ((qs >> 4) | xh1).astype(np.int8) - 16
    return np.concatenate([lo, hi], axis=1).reshape(-1, n), d.reshape(-1, n // 32), None, 32


def planar_q5_1(data, n):
    b = _rows(data, GGMLType.Q5_1, n).reshape(-1, 24)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = _u32le(b[:, 4:8]).astype(np.uint32)
    qs = b[:, 8:]
    j = np.arange(16, dtype=np.uint32)
    xh0 = (((qh >> j) << 4) & 0x10).astype(np.uint8)
    xh1 = ((qh >> (j + 12)) & 0x10).astype(np.uint8)
    lo = ((qs & 0x0F) | xh0).astype(np.int8)
    hi = ((qs >> 4) | xh1).astype(np.int8)
    return np.concatenate([lo, hi], axis=1).reshape(-1, n), d.reshape(-1, n // 32), m.reshape(-1, n // 32), 32


def planar_q6_0(data, n):
    b = _rows(data, GGMLType.Q6_0, n).reshape(-1, 26)
    d = _f16(b[:, :2])
    qh = b[:, 2:10]
    qs = b[:, 10:]
    h = np.concatenate([qh, qh >> 4], axis=1)
    lo = ((qs & 0x0F) | ((h << 4) & 0x30)).astype(np.int8) - 32
    hi = ((qs >> 4) | ((h << 2) & 0x30)).astype(np.int8) - 32
    return np.concatenate([lo, hi], axis=1).reshape(-1, n), d.reshape(-1, n // 32), None, 32


def planar_iq4_nl(data, n):
    b = _rows(data, GGMLType.IQ4_NL, n).reshape(-1, 18)
    d = _f16(b[:, :2])
    qs = b[:, 2:]
    codes = np.concatenate([luts.KVALUES_IQ4NL[qs & 0x0F], luts.KVALUES_IQ4NL[qs >> 4]], axis=1)
    return codes.reshape(-1, n), d.reshape(-1, n // 32), None, 32


def planar_mxfp4(data, n):
    b = _rows(data, GGMLType.MXFP4, n).reshape(-1, 17)
    e = b[:, 0:1].astype(np.int32)
    d = (np.float32(2.0) ** (e - 127)).astype(np.float32) * np.float32(0.5)
    qs = b[:, 1:]
    codes = np.concatenate([luts.KVALUES_MXFP4[qs & 0x0F], luts.KVALUES_MXFP4[qs >> 4]], axis=1)
    return codes.reshape(-1, n), d.reshape(-1, n // 32), None, 32


def planar_q8_kv(data, n):
    rows = _rows(data, GGMLType.Q8_KV, n)
    d = _f32le(rows[:, 0:4])
    codes = _i8(rows[:, 8:]).copy()
    # Q8_KV has one scale per ROW; expose as per-32 groups for kernel uniformity
    scale = np.repeat(d, n // 32, axis=1)
    return codes, scale, None, 32


# ---------------------------------------------------------------------------
# k-quants
# ---------------------------------------------------------------------------

def planar_q4_K(data, n):
    b = _rows(data, GGMLType.Q4_K, n).reshape(-1, 144)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, m = _kscale_min(b[:, 4:16])
    qs = b[:, 16:]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    for c in range(4):
        blk = qs[:, c * 32:(c + 1) * 32]
        codes[:, c * 64:c * 64 + 32] = (blk & 0x0F).astype(np.int8)
        codes[:, c * 64 + 32:c * 64 + 64] = (blk >> 4).astype(np.int8)
    scale = d * sc.astype(np.float32)       # (nb, 8)
    bias = -(dmin * m.astype(np.float32))
    return codes.reshape(-1, n), _sb(scale, n), _sb(bias, n), 32


def planar_q5_K(data, n):
    b = _rows(data, GGMLType.Q5_K, n).reshape(-1, 176)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, m = _kscale_min(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    for c in range(4):
        blk = qs[:, c * 32:(c + 1) * 32]
        u1 = np.uint8(1 << (2 * c))
        u2 = np.uint8(2 << (2 * c))
        codes[:, c * 64:c * 64 + 32] = ((blk & 0x0F) + ((qh & u1) != 0) * np.uint8(16)).astype(np.int8)
        codes[:, c * 64 + 32:c * 64 + 64] = ((blk >> 4) + ((qh & u2) != 0) * np.uint8(16)).astype(np.int8)
    scale = d * sc.astype(np.float32)
    bias = -(dmin * m.astype(np.float32))
    return codes.reshape(-1, n), _sb(scale, n), _sb(bias, n), 32


def planar_q6_K(data, n):
    b = _rows(data, GGMLType.Q6_K, n).reshape(-1, 210)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = _i8(b[:, 192:208]).astype(np.float32)
    d = _f16(b[:, 208:210])
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 16), dtype=np.float32)
    for i128 in range(2):
        qlb = ql[:, i128 * 64:]
        qhb = qh[:, i128 * 32:i128 * 32 + 32]
        qq = [((qlb[:, :32] & 0x0F) | ((qhb & 0x03) << 4)).astype(np.int8) - 32,
              ((qlb[:, 32:64] & 0x0F) | (((qhb >> 2) & 0x03) << 4)).astype(np.int8) - 32,
              ((qlb[:, :32] >> 4) | (((qhb >> 4) & 0x03) << 4)).astype(np.int8) - 32,
              ((qlb[:, 32:64] >> 4) | (((qhb >> 6) & 0x03) << 4)).astype(np.int8) - 32]
        for k in range(4):
            codes[:, i128 * 128 + k * 32:i128 * 128 + (k + 1) * 32] = qq[k]
            scale[:, i128 * 8 + 2 * k] = d[:, 0] * sc[:, i128 * 8 + 2 * k]
            scale[:, i128 * 8 + 2 * k + 1] = d[:, 0] * sc[:, i128 * 8 + 2 * k + 1]
    return codes.reshape(-1, n), _sb16(scale, n), None, 16


def planar_q2_K(data, n):
    b = _rows(data, GGMLType.Q2_K, n).reshape(-1, 84)
    scales = b[:, 0:16]
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 16), dtype=np.float32)
    bias = np.empty((nb, 16), dtype=np.float32)
    for n128 in range(2):
        q = qs[:, n128 * 32:(n128 + 1) * 32]
        for j in range(4):
            q2 = ((q >> (2 * j)) & 3).astype(np.int8)
            for half in range(2):
                is_ = n128 * 8 + j * 2 + half
                codes[:, n128 * 128 + j * 32 + half * 16:n128 * 128 + j * 32 + half * 16 + 16] = \
                    q2[:, half * 16:(half + 1) * 16]
                scale[:, is_] = d[:, 0] * (scales[:, is_] & 0x0F).astype(np.float32)
                bias[:, is_] = -(dmin[:, 0] * (scales[:, is_] >> 4).astype(np.float32))
    return codes.reshape(-1, n), _sb16(scale, n), _sb16(bias, n), 16


def planar_q3_K(data, n):
    b = _rows(data, GGMLType.Q3_K, n).reshape(-1, 110)
    hmask = b[:, 0:32]
    qs = b[:, 32:96]
    sc16 = _q3k_scales(b[:, 96:108]).astype(np.float32)
    d = _f16(b[:, 108:110])
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = d * sc16  # (nb,16)
    for n128 in range(2):
        q = qs[:, n128 * 32:(n128 + 1) * 32]
        for j in range(4):
            mbit = np.uint8(1 << (n128 * 4 + j))
            q2 = ((q >> (2 * j)) & 3).astype(np.int8)
            q3 = q2 - ((hmask & mbit) == 0) * np.int8(4)
            o = n128 * 128 + j * 32
            codes[:, o:o + 32] = q3
    return codes.reshape(-1, n), _sb16(scale, n), None, 16


def planar_iq4_xs(data, n):
    b = _rows(data, GGMLType.IQ4_XS, n).reshape(-1, 136)
    d = _f16(b[:, 0:2])
    scales_h = _u16le(b[:, 2:4]).astype(np.uint16)
    scales_l = b[:, 4:8]
    qs = b[:, 8:]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 8), dtype=np.float32)
    for ib in range(8):
        ls = ((scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0x0F).astype(np.int32) \
            | (((scales_h[:, 0] >> (2 * ib)) & 3).astype(np.int32) << 4)
        scale[:, ib] = d[:, 0] * (ls - 32)
        blk = qs[:, 16 * ib:16 * (ib + 1)]
        codes[:, 32 * ib:32 * ib + 16] = luts.KVALUES_IQ4NL[blk & 0x0F]
        codes[:, 32 * ib + 16:32 * ib + 32] = luts.KVALUES_IQ4NL[blk >> 4]
    return codes.reshape(-1, n), _sb(scale, n), None, 32


# ---------------------------------------------------------------------------
# IQK non-linear formats
# ---------------------------------------------------------------------------

def planar_iq2_k(data, n):
    b = _rows(data, GGMLType.IQ2_K, n).reshape(-1, 76)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    scales = b[:, 4:12]
    qs = b[:, 12:]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 16), dtype=np.float32)
    for ib32 in range(8):
        blk = qs[:, 32 * (ib32 // 4):32 * (ib32 // 4) + 32]
        q2 = (blk >> (2 * (ib32 % 4))) & 3
        off1 = ((extra >> (2 * ib32)) & 1) * 4
        off2 = ((extra >> (2 * ib32 + 1)) & 1) * 4
        codes[:, 32 * ib32:32 * ib32 + 16] = luts.IQ2NL_VALUES[q2[:, :16] + off1[:, None]]
        codes[:, 32 * ib32 + 16:32 * ib32 + 32] = luts.IQ2NL_VALUES[q2[:, 16:] + off2[:, None]]
        scale[:, 2 * ib32] = d * np.asarray(((scales[:, ib32] & 0x0F).astype(np.int32) - 8), dtype=np.float32)
        scale[:, 2 * ib32 + 1] = d * np.asarray(((scales[:, ib32] >> 4).astype(np.int32) - 8), dtype=np.float32)
    return codes.reshape(-1, n), _sb16(scale, n), None, 16


def planar_iq2_ks(data, n):
    rows = _rows(data, GGMLType.IQ2_KS, n)
    d = _f16(rows[:, 0:2])[:, 0]
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 70)
    extra = _u16le(blocks[..., 0:2]).astype(np.int32)[..., 0]
    scales = blocks[..., 2:6]
    qs = blocks[..., 6:]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib64 in range(4):
        sh = extra >> (2 * ib64)
        ls1 = ((scales[..., ib64] & 0x0F).astype(np.int32) | ((sh >> 4) & 0x10)) - 16
        ls2 = ((scales[..., ib64] >> 4).astype(np.int32) | ((sh >> 5) & 0x10)) - 16
        off1 = (sh & 1) * 4
        off2 = ((sh >> 1) & 1) * 4
        blk = qs[..., 32 * (ib64 // 2):32 * (ib64 // 2) + 32]
        shift = 4 * (ib64 % 2)
        codes[..., 64 * ib64:64 * ib64 + 32] = luts.IQ2NL_VALUES[((blk >> shift) & 3) + off1[..., None]]
        codes[..., 64 * ib64 + 32:64 * ib64 + 64] = luts.IQ2NL_VALUES[((blk >> (shift + 2)) & 3) + off2[..., None]]
        scale[..., 2 * ib64] = d[:, None] * ls1
        scale[..., 2 * ib64 + 1] = d[:, None] * ls2
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq2_kl(data, n):
    rows = _rows(data, GGMLType.IQ2_KL, n)
    d = _f16(rows[:, 0:2])[:, 0]
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 86)
    scales_h = _u16le(blocks[..., 0:2]).astype(np.int32)[..., 0]
    scales_l = blocks[..., 2:6]
    qs = blocks[..., 6:70]
    qh = blocks[..., 70:86]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib64 in range(4):
        sl1 = (scales_l[..., (2 * ib64) % 4] >> (4 * (ib64 // 2))) & 0x0F
        sl2 = (scales_l[..., (2 * ib64 + 1) % 4] >> (4 * (ib64 // 2))) & 0x0F
        dl1 = (sl1.astype(np.int32) | (((scales_h >> (4 * ib64)) & 3) << 4)) - 32
        dl2 = (sl2.astype(np.int32) | (((scales_h >> (4 * ib64 + 2)) & 3) << 4)) - 32
        blk = qs[..., 16 * ib64:16 * ib64 + 16]
        idx1 = (blk & 0x0F).astype(np.int32) | (((qh >> (2 * ib64)) & 1).astype(np.int32) << 4)
        idx2 = (blk >> 4).astype(np.int32) | (((qh >> (2 * ib64 + 1)) & 1).astype(np.int32) << 4)
        codes[..., 64 * ib64:64 * ib64 + 32] = luts.IQ2KL_PAIRS[idx1].reshape(nr, nb, 32)
        codes[..., 64 * ib64 + 32:64 * ib64 + 64] = luts.IQ2KL_PAIRS[idx2].reshape(nr, nb, 32)
        scale[..., 2 * ib64] = d[:, None] * np.asarray(dl1, dtype=np.float32)
        scale[..., 2 * ib64 + 1] = d[:, None] * np.asarray(dl2, dtype=np.float32)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq3_k(data, n):
    b = _rows(data, GGMLType.IQ3_K, n).reshape(-1, 110)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    sh = _u16le(b[:, 4:6]).astype(np.int32)[:, 0]
    scales_l = b[:, 6:14]
    qs = b[:, 14:78]
    qh = b[:, 78:110]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 16), dtype=np.float32)
    for ib32 in range(8):
        sgn1 = np.where((sh >> (2 * ib32)) & 1, -1.0, 1.0).astype(np.float32)
        sgn2 = np.where((sh >> (2 * ib32 + 1)) & 1, -1.0, 1.0).astype(np.float32)
        scale[:, 2 * ib32] = d * (2 * (scales_l[:, ib32] & 0x0F).astype(np.float32) + 1) * sgn1
        scale[:, 2 * ib32 + 1] = d * (2 * (scales_l[:, ib32] >> 4).astype(np.float32) + 1) * sgn2
        off1 = ((extra >> (2 * ib32)) & 1) * 8
        off2 = ((extra >> (2 * ib32 + 1)) & 1) * 8
        blk = qs[:, 32 * (ib32 // 4):32 * (ib32 // 4) + 32]
        hbit = (qh >> (ib32 % 8)) & 1
        q3 = ((blk >> (2 * (ib32 % 4))) & 3).astype(np.int32) | (hbit.astype(np.int32) << 2)
        codes[:, 32 * ib32:32 * ib32 + 16] = luts.IQ3NL_VALUES[q3[:, :16] + off1[:, None]]
        codes[:, 32 * ib32 + 16:32 * ib32 + 32] = luts.IQ3NL_VALUES[q3[:, 16:] + off2[:, None]]
    return codes.reshape(-1, n), _sb16(scale, n), None, 16


def planar_iq3_ks(data, n):
    rows = _rows(data, GGMLType.IQ3_KS, n)
    d = _f16(rows[:, 0:2])[:, 0]
    blocks = rows[:, 2:].reshape(rows.shape[0], -1, 102)
    extra = _u16le(blocks[..., 0:2]).astype(np.int32)[..., 0]
    scales = blocks[..., 2:6]
    qs = blocks[..., 6:70]
    qh = blocks[..., 70:102]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    dl = np.empty((nr, nb, 8), dtype=np.float32)
    for j in range(4):
        ls1 = (scales[..., j] & 0x0F).astype(np.int32) | (((extra >> j) & 1) << 4)
        ls2 = (scales[..., j] >> 4).astype(np.int32) | (((extra >> (j + 4)) & 1) << 4)
        dl[..., j] = ls1 - 16
        dl[..., j + 4] = ls2 - 16
    for i128 in range(2):
        blk = qs[..., 32 * i128:32 * i128 + 32]
        for ib in range(4):
            k = 4 * i128 + ib
            off = ((extra >> (8 + k)) & 1) * 8
            q3 = ((blk >> (2 * ib)) & 3).astype(np.int32) | (((qh >> k) & 1).astype(np.int32) << 2)
            codes[..., 32 * k:32 * k + 32] = luts.IQ3NL_VALUES[q3 + off[..., None]]
            scale[..., k] = d[:, None] * dl[..., k]  # dl already f32
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq4_k(data, n):
    b = _rows(data, GGMLType.IQ4_K, n).reshape(-1, 144)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    scales_h = b[:, 4:8]
    scales_l = b[:, 8:16]
    qs = b[:, 16:]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 16), dtype=np.float32)
    for ib in range(8):
        shh = (scales_h[:, ib // 2] >> (4 * (ib % 2))).astype(np.int32)
        scale[:, 2 * ib] = d * np.asarray((((scales_l[:, ib] & 0x0F).astype(np.int32) | ((shh << 4) & 0x30)) - 32), dtype=np.float32)
        scale[:, 2 * ib + 1] = d * np.asarray((((scales_l[:, ib] >> 4).astype(np.int32) | ((shh << 2) & 0x30)) - 32), dtype=np.float32)
        off1 = ((extra >> (2 * ib)) & 1) * 16
        off2 = ((extra >> (2 * ib + 1)) & 1) * 16
        blk = qs[:, 16 * ib:16 * (ib + 1)]
        codes[:, 32 * ib:32 * ib + 16] = luts.IQ4K_VALUES[(blk & 0x0F) + off1[:, None]]
        codes[:, 32 * ib + 16:32 * ib + 32] = luts.IQ4K_VALUES[(blk >> 4) + off2[:, None]]
    return codes.reshape(-1, n), _sb16(scale, n), None, 16


def planar_iq4_ks(data, n):
    rows = _rows(data, GGMLType.IQ4_KS, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 136)
    scales = blocks[..., 0:8]
    qs = blocks[..., 8:]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib in range(8):
        dl = (scales[..., ib] & 254).astype(np.int32) - 127
        off = (scales[..., ib] & 1).astype(np.int32) * 16
        blk = qs[..., 16 * ib:16 * (ib + 1)]
        codes[..., 32 * ib:32 * ib + 16] = luts.IQ4K_VALUES[(blk & 0x0F) + off[..., None]]
        codes[..., 32 * ib + 16:32 * ib + 32] = luts.IQ4K_VALUES[(blk >> 4) + off[..., None]]
        scale[..., ib] = d[:, None] * np.asarray(dl, dtype=np.float32)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq4_kss(data, n):
    rows = _rows(data, GGMLType.IQ4_KSS, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 128)
    qs = _u16le(blocks.reshape(rows.shape[0], -1)).reshape(rows.shape[0], -1, 64)
    nr, nb = qs.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib in range(8):
        w = qs[..., 8 * ib:8 * ib + 8]
        aux16 = (w & np.uint16(0xFFFE)).astype(np.uint16)
        aux16 ^= aux16 >> 1
        lsbits = (w & 1).astype(np.int32)
        ls = np.zeros(lsbits.shape[:-1], dtype=np.int32)
        for k in range(8):
            ls |= lsbits[..., k] << k
        aux8 = aux16.view(np.uint8).reshape(nr, nb, 16)
        off = (ls & 1) * 16
        codes[..., 32 * ib:32 * ib + 16] = luts.IQ4K_VALUES[(aux8 & 0x0F) + off[..., None]]
        codes[..., 32 * ib + 16:32 * ib + 32] = luts.IQ4K_VALUES[(aux8 >> 4) + off[..., None]]
        scale[..., ib] = d[:, None] * np.asarray(((ls & 254) - 127), dtype=np.float32)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq5_k(data, n):
    b = _rows(data, GGMLType.IQ5_K, n).reshape(-1, 176)
    d = _f16(b[:, 0:2])[:, 0]
    extra = _u16le(b[:, 2:4]).astype(np.int32)[:, 0]
    scales_h = b[:, 4:8]
    scales_l = b[:, 8:16]
    qs = b[:, 16:144]
    qh = b[:, 144:176]
    nb = b.shape[0]
    codes = np.empty((nb, QK_K), dtype=np.int8)
    scale = np.empty((nb, 16), dtype=np.float32)
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
        hA, hB = qh[:, 0:16], qh[:, 16:32]
        q = [
            (blkA & 0x0F).astype(np.int32) | (((hA >> shift) & 1).astype(np.int32) << 4),
            (blkB & 0x0F).astype(np.int32) | (((hB >> shift) & 1).astype(np.int32) << 4),
            (blkA >> 4).astype(np.int32) | (((hA >> shift) & 2).astype(np.int32) << 3),
            (blkB >> 4).astype(np.int32) | (((hB >> shift) & 2).astype(np.int32) << 3),
        ]
        for k in range(4):
            codes[:, 64 * ib64 + 16 * k:64 * ib64 + 16 * (k + 1)] = \
                luts.IQ5NL_VALUES[q[k] + offs[k][:, None]]
            scale[:, 4 * ib64 + k] = d * dls[k]
    return codes.reshape(-1, n), _sb16(scale, n), None, 16


def planar_iq5_ks(data, n):
    rows = _rows(data, GGMLType.IQ5_KS, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 168)
    scales = blocks[..., 0:8]
    qs = blocks[..., 8:136]
    qh = blocks[..., 136:168]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib64 in range(4):
        s1 = scales[..., 2 * ib64].astype(np.int32)
        s2 = scales[..., 2 * ib64 + 1].astype(np.int32)
        off1 = (s1 & 1) * 32
        off2 = (s2 & 1) * 32
        blk = qs[..., 32 * ib64:32 * ib64 + 32]
        q1 = (blk & 0x0F).astype(np.int32) | (((qh >> (2 * ib64)) & 1).astype(np.int32) << 4)
        q2 = (blk >> 4).astype(np.int32) | (((qh >> (2 * ib64 + 1)) & 1).astype(np.int32) << 4)
        codes[..., 64 * ib64:64 * ib64 + 32] = luts.IQ5NL_VALUES[q1 + off1[..., None]]
        codes[..., 64 * ib64 + 32:64 * ib64 + 64] = luts.IQ5NL_VALUES[q2 + off2[..., None]]
        scale[..., 2 * ib64] = d[:, None] * np.asarray(((s1 & 254) - 127), dtype=np.float32)
        scale[..., 2 * ib64 + 1] = d[:, None] * np.asarray(((s2 & 254) - 127), dtype=np.float32)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


# ---------------------------------------------------------------------------
# KT trellis — codes are the generated int values themselves
# ---------------------------------------------------------------------------

def planar_iq1_kt(data, n):
    rows = _rows(data, GGMLType.IQ1_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 56)
    sh = blocks[..., 0:8]
    ql = blocks[..., 8:40]
    qh = blocks[..., 40:56]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib in range(8):
        scale[..., ib] = d[:, None] * luts.IQ4K_VALUES[sh[..., ib] & 0x0F]
        for ig in range(4):
            idx = ql[..., ib * 4 + ig].astype(np.int32) \
                | ((qh[..., (ib % 4) * 4 + ig].astype(np.int32) << (8 - 4 * (ib // 4))) & 0xF00) \
                | ((sh[..., ib].astype(np.int32) << (8 - ig)) & 0x1000)
            codes[..., ib * 32 + ig * 8:ib * 32 + ig * 8 + 8] = \
                _kt_values(idx + 4096, 8).astype(np.int8)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq2_kt(data, n):
    rows = _rows(data, GGMLType.IQ2_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 68)
    scales = blocks[..., 0:4]
    ql = _u16le(blocks[..., 4:68].reshape(rows.shape[0], -1)).reshape(rows.shape[0], -1, 32)
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib in range(4):
        scale[..., ib] = d[:, None] * luts.IQ4K_VALUES[scales[..., ib] & 0x0F]
        scale[..., 4 + ib] = d[:, None] * luts.IQ4K_VALUES[scales[..., ib] >> 4]
        for ig in range(4):
            o = ib * 32 + ig * 8
            codes[..., o:o + 8] = _kt_values(ql[..., ib * 4 + ig].astype(np.int32) + 4096, 8).astype(np.int8)
            codes[..., 128 + o:128 + o + 8] = _kt_values(ql[..., 16 + ib * 4 + ig].astype(np.int32) + 4096, 8).astype(np.int8)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq3_kt(data, n):
    rows = _rows(data, GGMLType.IQ3_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 100)
    scales = blocks[..., 0:4]
    ql = _u16le(blocks[..., 4:68].reshape(rows.shape[0], -1)).reshape(rows.shape[0], -1, 32)
    qh = blocks[..., 68:100]
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib in range(4):
        scale[..., ib] = d[:, None] * (scales[..., ib] & 0x0F).astype(np.float32)
        scale[..., 4 + ib] = d[:, None] * (scales[..., ib] >> 4).astype(np.float32)
        for ig in range(4):
            vl = np.abs(_kt_values(ql[..., ib * 4 + ig].astype(np.int32) + 4096, 8))
            vh = np.abs(_kt_values(ql[..., 16 + ib * 4 + ig].astype(np.int32) + 4096, 8))
            sbits = qh[..., ig * 8:(ig + 1) * 8]
            sgn_l = np.where((sbits >> ib) & 1, -1.0, 1.0).astype(np.float32)
            sgn_h = np.where((sbits >> (ib + 4)) & 1, -1.0, 1.0).astype(np.float32)
            o = ib * 32 + ig * 8
            codes[..., o:o + 8] = (vl * sgn_l).astype(np.int8)
            codes[..., 128 + o:128 + o + 8] = (vh * sgn_h).astype(np.int8)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


def planar_iq4_kt(data, n):
    rows = _rows(data, GGMLType.IQ4_KT, n)
    d = _f32le(rows[:, 0:4])[:, 0]
    blocks = rows[:, 4:].reshape(rows.shape[0], -1, 128)
    shb = _u32le(blocks[..., 0:32].reshape(rows.shape[0], -1)).reshape(rows.shape[0], -1, 8)
    ql = blocks[..., 32:96].astype(np.int32)
    qh = blocks[..., 96:128].astype(np.int32)
    nr, nb = blocks.shape[:2]
    codes = np.empty((nr, nb, QK_K), dtype=np.int8)
    scale = np.empty((nr, nb, 8), dtype=np.float32)
    for ib in range(8):
        word = shb[..., ib].astype(np.int64)
        offset = np.where(word & 1, 32768 + 4096, 4096).astype(np.int32)
        scale[..., ib] = d[:, None] * np.asarray((((word & 0xFF) >> 1).astype(np.int32) - 64), dtype=np.float32)
        for ig in range(8):
            jj = ib * 8 + ig
            idx = ql[..., jj] | ((qh[..., jj % 32] << (8 - 4 * (jj // 32))) & 0xF00) \
                | (((word >> (8 + 3 * ig)) & 7).astype(np.int32) << 12)
            o = ib * 32 + ig * 4
            codes[..., o:o + 4] = _kt_values(idx + offset, 4).astype(np.int8)
    return codes.reshape(nr, n), _sb(scale.reshape(nr, -1), n, flat=True), None, 32


# ---------------------------------------------------------------------------
# helpers for spreading per-subblock scales to (nrows, K//G)
# ---------------------------------------------------------------------------

def _sb(scale_per_block: np.ndarray, n: int, flat: bool = False) -> np.ndarray:
    """Per-superblock scales (nb, 8) for G=32 -> (nrows, n//32)."""
    return scale_per_block.reshape(-1, n // 32).astype(np.float32)


def _sb16(scale_per_block: np.ndarray, n: int) -> np.ndarray:
    """Per-superblock scales (nb, 16) for G=16 -> (nrows, n//16)."""
    return scale_per_block.reshape(-1, n // 16).astype(np.float32)


PLANAR_FNS = {
    GGMLType.Q4_0: planar_q4_0,
    GGMLType.Q4_1: planar_q4_1,
    GGMLType.Q5_0: planar_q5_0,
    GGMLType.Q5_1: planar_q5_1,
    GGMLType.Q6_0: planar_q6_0,
    GGMLType.Q8_0: planar_q8_0,
    GGMLType.MXFP4: planar_mxfp4,
    GGMLType.Q8_KV: planar_q8_kv,
    GGMLType.Q2_K: planar_q2_K,
    GGMLType.Q3_K: planar_q3_K,
    GGMLType.Q4_K: planar_q4_K,
    GGMLType.Q5_K: planar_q5_K,
    GGMLType.Q6_K: planar_q6_K,
    GGMLType.IQ4_NL: planar_iq4_nl,
    GGMLType.IQ4_XS: planar_iq4_xs,
    GGMLType.IQ2_K: planar_iq2_k,
    GGMLType.IQ2_KS: planar_iq2_ks,
    GGMLType.IQ2_KL: planar_iq2_kl,
    GGMLType.IQ3_K: planar_iq3_k,
    GGMLType.IQ3_KS: planar_iq3_ks,
    GGMLType.IQ4_K: planar_iq4_k,
    GGMLType.IQ4_KS: planar_iq4_ks,
    GGMLType.IQ4_KSS: planar_iq4_kss,
    GGMLType.IQ5_K: planar_iq5_k,
    GGMLType.IQ5_KS: planar_iq5_ks,
    GGMLType.IQ1_KT: planar_iq1_kt,
    GGMLType.IQ2_KT: planar_iq2_kt,
    GGMLType.IQ3_KT: planar_iq3_kt,
    GGMLType.IQ4_KT: planar_iq4_kt,
}


def planar_decode(data: np.ndarray, ggml_type: GGMLType, n_per_row: int) -> PlanarWeight:
    fn = PLANAR_FNS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"planar_decode: unsupported type {ggml_type!r}")
    # inf/NaN f16 scales from garbage blocks propagate silently, matching the
    # reference C decoders (see dequant.dequantize for the rationale)
    with np.errstate(over="ignore", invalid="ignore"):
        codes, scale, bias, group = fn(data, n_per_row)
    return PlanarWeight(codes=codes, scale=scale, bias=bias, group=group)
