"""Quantized KV cache codecs and the K/V Hadamard rotation.

The torch counterpart of the JAX package's ``ops/kv_quant.py``: the
-ctk/-ctv q8_0 / q4_0 / q6_0 / iq4_nl cache types as per-(token, head) row
codecs, quantize-on-write. A cache holds codes (L, B, S, Hkv, W) and float32
scales (L, B, S, Hkv), one scale per row:

  q8   int8,  W = D       code = round(x / scale), scale = amax / 127
  q4   uint8, W = D/2     two codes a byte: low nibble dims [0, D/2), high
                          nibble dims [D/2, D); code + 8, scale = amax / 7
  q6   uint8, W = 3D/4    bytes [0, D/2) hold the low 4 bits packed as q4
                          does; bytes [D/2, 3D/4) the high 2 bits, four dims
                          a byte (j, j+D/4, j+D/2, j+3D/4 at bits 0, 2, 4, 6);
                          code + 32, scale = amax / 31
  nl4  int8,  W = D/2     q4's nibble layout over the 16 IQ4_NL levels; the
                          scale is signed so that the row's extreme lands on
                          level -127

Codes and scales match the JAX functions bit for bit on the same float32
input: ``scale = amax / c`` is a float32 division, ``inv = 1 / scale`` a
second one, and the code is ``round(x * inv)`` half-to-even (``x / scale``
rounds differently). That is what the JAX functions give when run op by op.
Inside a ``jax.jit`` XLA's CPU backend rewrites the division by the constant
into a multiplication by its rounded reciprocal, which moves some scales by
one float32 ulp (the codes stay the same on random rows); the port keeps the
division as written. Codecs are told apart by (dtype, stored width) alone:
``kv_codec_of``.
"""
from __future__ import annotations

import numpy as np
import torch

# the IQ4_NL level table (GGUF format constant) and the midpoints between
# neighbouring levels, the decision boundaries of nearest-level rounding
IQ4NL_VALUES = (-127, -104, -83, -65, -49, -35, -22, -10,
                1, 13, 25, 38, 53, 69, 89, 113)
_IQ4NL_MIDS = tuple((IQ4NL_VALUES[i] + IQ4NL_VALUES[i + 1]) / 2.0
                    for i in range(15))

_CONSTS: dict = {}


def _const(name: str, values, device) -> torch.Tensor:
    """A small float32 constant tensor, made once per device."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(values, dtype=torch.float32, device=device)
        _CONSTS[key] = t
    return t


def _row_scale(xf: torch.Tensor, levels: float):
    """(scale, 1/scale or 0) per row from the row's absmax."""
    scale = torch.amax(torch.abs(xf), dim=-1) / levels
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    return scale, inv


def quantize_kv_rows(x: torch.Tensor):
    """x: (B, T, H, D) float -> (int8 codes, f32 scales (B, T, H))."""
    xf = x.float()
    scale, inv = _row_scale(xf, 127.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q: (..., D) int8, scale: (...,) -> float32."""
    return q.float() * scale[..., None]


def quantize_kv_rows_q4(x: torch.Tensor):
    """x: (B, T, H, D) float -> (uint8 (B, T, H, D/2), f32 scales)."""
    xf = x.float()
    d = xf.shape[-1]
    scale, inv = _row_scale(xf, 7.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -8, 7).to(torch.int32) + 8
    lo, hi = q[..., :d // 2], q[..., d // 2:]
    return (lo | (hi << 4)).to(torch.uint8), scale


def dequantize_kv_q4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """packed: (..., D/2) uint8, scale: (...,) -> float32 (..., D)."""
    p = packed.to(torch.int32)
    codes = torch.cat([(p & 0x0F) - 8, (p >> 4) - 8], dim=-1)
    return codes.float() * scale[..., None]


def quantize_kv_rows_q6(x: torch.Tensor):
    """x: (B, T, H, D) float, D % 4 == 0 -> (uint8 (B, T, H, 3D/4), f32
    scales): the low-nibble plane, then the 2-bit plane."""
    xf = x.float()
    d = xf.shape[-1]
    scale, inv = _row_scale(xf, 31.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -31, 31).to(torch.int32) + 32
    lo, hi = q & 0x0F, q >> 4
    plane4 = lo[..., :d // 2] | (lo[..., d // 2:] << 4)
    q4 = d // 4
    plane2 = (hi[..., :q4] | (hi[..., q4:2 * q4] << 2)
              | (hi[..., 2 * q4:3 * q4] << 4) | (hi[..., 3 * q4:] << 6))
    return torch.cat([plane4, plane2], dim=-1).to(torch.uint8), scale


def unpack_kv_q6(packed: torch.Tensor) -> torch.Tensor:
    """(..., 3D/4) uint8 -> int32 codes (..., D) in [-31, 31]."""
    d = (packed.shape[-1] * 4) // 3
    p4 = packed[..., :d // 2].to(torch.int32)
    p2 = packed[..., d // 2:].to(torch.int32)
    lo = torch.cat([p4 & 0x0F, p4 >> 4], dim=-1)
    hi = torch.cat([(p2 >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    return (hi << 4 | lo) - 32


def dequantize_kv_q6(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return unpack_kv_q6(packed).float() * scale[..., None]


def quantize_kv_rows_nl4(x: torch.Tensor):
    """x: (B, T, H, D) float -> (int8 (B, T, H, D/2), signed f32 scales).

    Nearest-IQ4_NL-level rounding. The row's signed extreme (the positive
    one on a tie) maps onto level -127, because the level grid tops out at
    +113. The level index counts the midpoints strictly below the scaled
    value; the packed byte is stored as int8 so that the codec differs from
    q4 by dtype."""
    xf = x.float()
    d = xf.shape[-1]
    pos, neg = torch.amax(xf, dim=-1), torch.amin(xf, dim=-1)
    m = torch.where(pos >= -neg, pos, neg)
    scale = m / -127.0
    nz = scale != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    t = xf * inv[..., None]
    # bucketize(right=False) = number of midpoints < t = sum_i (t > mid_i)
    code = torch.bucketize(t, _const("nl4_mids", _IQ4NL_MIDS, xf.device)).to(torch.int32)
    packed = code[..., :d // 2] | (code[..., d // 2:] << 4)
    return (packed - (packed & 0x80) * 2).to(torch.int8), scale


def unpack_kv_nl4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/2) int8 -> float32 level values (..., D) in [-127, 113]."""
    p = packed.to(torch.int32) & 0xFF
    lut = _const("nl4_values", IQ4NL_VALUES, packed.device)
    return torch.cat([lut[p & 0x0F], lut[(p >> 4) & 0x0F]], dim=-1)


def dequantize_kv_nl4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return unpack_kv_nl4(packed) * scale[..., None]


KV_ENCODERS = {"q8": quantize_kv_rows, "q4": quantize_kv_rows_q4,
               "q6": quantize_kv_rows_q6, "nl4": quantize_kv_rows_nl4}
KV_DECODERS = {"q8": dequantize_kv, "q4": dequantize_kv_q4,
               "q6": dequantize_kv_q6, "nl4": dequantize_kv_nl4}
# stored last-dim width per head dim, and the stored dtype
KV_CODEC_WIDTH = {"q8": lambda d: d, "q4": lambda d: d // 2,
                  "q6": lambda d: 3 * d // 4, "nl4": lambda d: d // 2}
KV_CODEC_DTYPE = {"q8": torch.int8, "q4": torch.uint8, "q6": torch.uint8,
                  "nl4": torch.int8}


def kv_codec_of(codes: torch.Tensor, head_dim: int) -> str:
    """The codec of a cache codes tensor (..., W), by dtype and width."""
    w = codes.shape[-1]
    if codes.dtype == torch.uint8:
        return "q6" if 4 * w == 3 * head_dim else "q4"
    return "nl4" if 2 * w == head_dim else "q8"


# ---------------------------------------------------------------------------
# K/V Hadamard rotation (-khad / -vhad): K and q (scores unchanged, Hq . Hk =
# q . k) and/or V (un-rotated after attention) are rotated by a normalized
# Sylvester-Hadamard matrix before quantize-on-write, which spreads channel
# outliers over the head dim and tames the row-absmax scales. H is symmetric
# and orthogonal, so the same matrix un-rotates.
# ---------------------------------------------------------------------------

_HADAMARD: dict = {}


def hadamard_matrix(d: int) -> np.ndarray:
    """Normalized d x d Sylvester-Hadamard matrix (float32 numpy); d must
    be a power of two."""
    m = _HADAMARD.get(d)
    if m is None:
        assert d > 0 and (d & (d - 1)) == 0, \
            f"Hadamard rotation needs a power-of-two head_dim, got {d}"
        h = np.array([[1.0]], dtype=np.float32)
        while h.shape[0] < d:
            h = np.block([[h, h], [h, -h]])
        m = (h / np.sqrt(d)).astype(np.float32)
        _HADAMARD[d] = m
    return m


def hadamard_rotate(x: torch.Tensor) -> torch.Tensor:
    """Rotate the trailing head-dim axis: (..., D) @ H_D in float32 (a plain
    product with a constant matrix, outside any kernel)."""
    d = x.shape[-1]
    key = (f"hadamard{d}", str(x.device))
    hm = _CONSTS.get(key)
    if hm is None:
        hm = _CONSTS[key] = torch.from_numpy(hadamard_matrix(d)).to(x.device)
    return (x.float() @ hm).to(x.dtype)
