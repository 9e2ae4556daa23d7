"""Codebook i-quant decoders: IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M.

Semantics mirror ggml-quants.c dequantize_row_iq* (:3674-3910); the learned
codebook grids live in grids.npz, the same file as the JAX package's. The
port's copy of the JAX package's ``quant/iquants.py`` (numpy only):
``quant/__init__`` registers ``IQUANT_FNS`` into ``dequant.DEQUANT_FNS``. No
planar form exists for these formats, so ``models/weights.load_linear``
loads such a tensor as a bf16 ``DenseLinear``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..gguf.constants import GGMLType, QK_K
from .dequant import _rows, _f16, _u16le, _u32le

IQ1S_DELTA = np.float32(0.125)

_G = np.load(Path(__file__).parent / "grids.npz")
# grids as (n_entries, 8) byte values
GRID_IQ2XXS = _G["iq2xxs_grid"].view(np.uint8).reshape(-1, 8)
GRID_IQ2XS = _G["iq2xs_grid"].view(np.uint8).reshape(-1, 8)
GRID_IQ2S = _G["iq2s_grid"].view(np.uint8).reshape(-1, 8)
GRID_IQ3XXS = _G["iq3xxs_grid"].view(np.uint8).reshape(-1, 4)
GRID_IQ3S = _G["iq3s_grid"].view(np.uint8).reshape(-1, 4)
GRID_IQ1S = _G["iq1s_grid"].view(np.int8).reshape(-1, 8)

# ksigns_iq2xs: entry i has bit j = sign of element j; bit 7 = odd parity.
_i = np.arange(128, dtype=np.uint8)
_par = np.zeros(128, np.uint8)
for _b in range(7):
    _par ^= (_i >> _b) & 1
KSIGNS = (_i | (_par << 7)).astype(np.uint8)
KMASK = (1 << np.arange(8, dtype=np.uint8)).astype(np.uint8)


def _signs8(sign_bytes):
    """sign byte array (...,) -> (-1/+1) f32 (..., 8)."""
    bits = (sign_bytes[..., None] & KMASK) != 0
    return np.where(bits, np.float32(-1.0), np.float32(1.0))


def dequant_iq2_xxs(data, n):
    b = _rows(data, GGMLType.IQ2_XXS, n).reshape(-1, 66)
    d = _f16(b[:, :2])[:, 0]
    q16 = _u16le(b[:, 2:])  # (nb, 32)
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for ib32 in range(8):
        w = q16[:, 4 * ib32:4 * ib32 + 4]
        aux8 = w[:, :2].copy().view(np.uint8)          # (nb, 4) grid indices
        aux32 = w[:, 2:].copy().view(np.uint32)[:, 0]  # signs + scale
        db = d * (0.5 + (aux32 >> 28).astype(np.float32)) * np.float32(0.25)
        for l in range(4):
            grid = GRID_IQ2XXS[aux8[:, l]].astype(np.float32)  # (nb, 8)
            signs = _signs8(KSIGNS[(aux32 >> (7 * l)) & 127])
            y[:, 32 * ib32 + 8 * l:32 * ib32 + 8 * l + 8] = db[:, None] * grid * signs
    return y.reshape(-1, n)


def dequant_iq2_xs(data, n):
    b = _rows(data, GGMLType.IQ2_XS, n).reshape(-1, 74)
    d = _f16(b[:, :2])[:, 0]
    q16 = _u16le(b[:, 2:66])
    scales = b[:, 66:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for ib32 in range(8):
        db = [d * (0.5 + (scales[:, ib32] & 0xF).astype(np.float32)) * np.float32(0.25),
              d * (0.5 + (scales[:, ib32] >> 4).astype(np.float32)) * np.float32(0.25)]
        for l in range(4):
            w = q16[:, 4 * ib32 + l]
            grid = GRID_IQ2XS[w & 511].astype(np.float32)
            signs = _signs8(KSIGNS[(w >> 9).astype(np.uint8)])
            y[:, 32 * ib32 + 8 * l:32 * ib32 + 8 * l + 8] = \
                db[l // 2][:, None] * grid * signs
    return y.reshape(-1, n)


def dequant_iq2_s(data, n):
    b = _rows(data, GGMLType.IQ2_S, n).reshape(-1, 82)
    d = _f16(b[:, :2])[:, 0]
    qs = b[:, 2:66]                 # 32 idx bytes then 32 sign bytes
    qh = b[:, 66:74]
    scales = b[:, 74:]
    idx_b = qs[:, :32]
    sign_b = qs[:, 32:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for ib32 in range(8):
        db = [d * (0.5 + (scales[:, ib32] & 0xF).astype(np.float32)) * np.float32(0.25),
              d * (0.5 + (scales[:, ib32] >> 4).astype(np.float32)) * np.float32(0.25)]
        for l in range(4):
            idx = idx_b[:, 4 * ib32 + l].astype(np.int32) | \
                ((qh[:, ib32].astype(np.int32) << (8 - 2 * l)) & 0x300)
            grid = GRID_IQ2S[idx].astype(np.float32)
            signs = _signs8(sign_b[:, 4 * ib32 + l])
            y[:, 32 * ib32 + 8 * l:32 * ib32 + 8 * l + 8] = \
                db[l // 2][:, None] * grid * signs
    return y.reshape(-1, n)


def dequant_iq3_xxs(data, n):
    b = _rows(data, GGMLType.IQ3_XXS, n).reshape(-1, 98)
    d = _f16(b[:, :2])[:, 0]
    qs = b[:, 2:66]
    sas = _u32le(b[:, 66:])  # (nb, 8)
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for ib32 in range(8):
        aux32 = sas[:, ib32]
        db = d * (0.5 + (aux32 >> 28).astype(np.float32)) * np.float32(0.5)
        for l in range(4):
            signs = _signs8(KSIGNS[(aux32 >> (7 * l)) & 127])
            g1 = GRID_IQ3XXS[qs[:, 8 * ib32 + 2 * l]].astype(np.float32)
            g2 = GRID_IQ3XXS[qs[:, 8 * ib32 + 2 * l + 1]].astype(np.float32)
            o = 32 * ib32 + 8 * l
            y[:, o:o + 4] = db[:, None] * g1 * signs[:, :4]
            y[:, o + 4:o + 8] = db[:, None] * g2 * signs[:, 4:]
    return y.reshape(-1, n)


def dequant_iq3_s(data, n):
    b = _rows(data, GGMLType.IQ3_S, n).reshape(-1, 110)
    d = _f16(b[:, :2])[:, 0]
    qs = b[:, 2:66]
    qh = b[:, 66:74]
    signs = b[:, 74:106]
    scales = b[:, 106:]
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for pair in range(4):  # ib32 += 2
        db1 = d * (1 + 2 * (scales[:, pair] & 0xF).astype(np.float32))
        db2 = d * (1 + 2 * (scales[:, pair] >> 4).astype(np.float32))
        for half, db in ((0, db1), (1, db2)):
            ib32 = 2 * pair + half
            qh_b = qh[:, ib32].astype(np.int32)
            for l in range(4):
                i1 = qs[:, 8 * ib32 + 2 * l].astype(np.int32) | ((qh_b << (8 - 2 * l)) & 256)
                i2 = qs[:, 8 * ib32 + 2 * l + 1].astype(np.int32) | ((qh_b << (7 - 2 * l)) & 256)
                g1 = GRID_IQ3S[i1].astype(np.float32)
                g2 = GRID_IQ3S[i2].astype(np.float32)
                sgn = _signs8(signs[:, 4 * ib32 + l])
                o = 32 * ib32 + 8 * l
                y[:, o:o + 4] = db[:, None] * g1 * sgn[:, :4]
                y[:, o + 4:o + 8] = db[:, None] * g2 * sgn[:, 4:]
    return y.reshape(-1, n)


def dequant_iq1_s(data, n):
    b = _rows(data, GGMLType.IQ1_S, n).reshape(-1, 50)
    d = _f16(b[:, :2])[:, 0]
    qs = b[:, 2:34]
    qh = _u16le(b[:, 34:])  # (nb, 8)
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for ib in range(8):
        h = qh[:, ib].astype(np.int32)
        dl = d * (2 * ((h >> 12) & 7) + 1).astype(np.float32)
        delta = np.where(h & 0x8000, -IQ1S_DELTA, IQ1S_DELTA)
        for l in range(4):
            idx = qs[:, 4 * ib + l].astype(np.int32) | (((h >> (3 * l)) & 7) << 8)
            grid = GRID_IQ1S[idx].astype(np.float32)
            o = 32 * ib + 8 * l
            y[:, o:o + 8] = dl[:, None] * (grid + delta[:, None])
    return y.reshape(-1, n)


def dequant_iq1_m(data, n):
    b = _rows(data, GGMLType.IQ1_M, n).reshape(-1, 56)
    qs = b[:, 0:32]
    qh = b[:, 32:48]
    sc = _u16le(b[:, 48:])  # (nb, 4)
    scale_bits = ((sc[:, 0].astype(np.uint32) >> 12)
                  | ((sc[:, 1].astype(np.uint32) >> 8) & 0x00F0)
                  | ((sc[:, 2].astype(np.uint32) >> 4) & 0x0F00)
                  | (sc[:, 3].astype(np.uint32) & 0xF000)).astype(np.uint16)
    d = scale_bits.view(np.uint16).copy().view(np.float16).astype(np.float32)
    nb = b.shape[0]
    y = np.empty((nb, QK_K), np.float32)
    for ib in range(8):
        s = sc[:, ib // 2].astype(np.int32)
        dl1 = d * (2 * ((s >> (6 * (ib % 2) + 0)) & 7) + 1)
        dl2 = d * (2 * ((s >> (6 * (ib % 2) + 3)) & 7) + 1)
        h0 = qh[:, 2 * ib].astype(np.int32)
        h1 = qh[:, 2 * ib + 1].astype(np.int32)
        idx = [qs[:, 4 * ib + 0].astype(np.int32) | ((h0 << 8) & 0x700),
               qs[:, 4 * ib + 1].astype(np.int32) | ((h0 << 4) & 0x700),
               qs[:, 4 * ib + 2].astype(np.int32) | ((h1 << 8) & 0x700),
               qs[:, 4 * ib + 3].astype(np.int32) | ((h1 << 4) & 0x700)]
        deltas = [np.where(h0 & 0x08, -IQ1S_DELTA, IQ1S_DELTA),
                  np.where(h0 & 0x80, -IQ1S_DELTA, IQ1S_DELTA),
                  np.where(h1 & 0x08, -IQ1S_DELTA, IQ1S_DELTA),
                  np.where(h1 & 0x80, -IQ1S_DELTA, IQ1S_DELTA)]
        for l in range(4):
            dl = dl1 if l < 2 else dl2
            grid = GRID_IQ1S[idx[l]].astype(np.float32)
            o = 32 * ib + 8 * l
            y[:, o:o + 8] = dl[:, None] * (grid + deltas[l][:, None])
    return y.reshape(-1, n)


IQUANT_FNS = {
    GGMLType.IQ2_XXS: dequant_iq2_xxs,
    GGMLType.IQ2_XS: dequant_iq2_xs,
    GGMLType.IQ2_S: dequant_iq2_s,
    GGMLType.IQ3_XXS: dequant_iq3_xxs,
    GGMLType.IQ3_S: dequant_iq3_s,
    GGMLType.IQ1_S: dequant_iq1_s,
    GGMLType.IQ1_M: dequant_iq1_m,
}
