"""Quantizers: float32 rows -> GGUF quant bytes (numpy, vectorized).

The port encodes the formats its model files and merged adapters are
written in: Q8_0 (the tied head / embedding), Q4_0 (the planar 4-bit
weights), F16 (``runtime/lora.merge_lora``'s merged tensors) and F32. The
quantized two follow the reference algorithm exactly (ggml-quants.c
quantize_row_*_ref); the float two are numpy's casts, byte for byte the JAX
package's encoders. Any other type raises.

Functions take (nrows, n) float32 and return uint8 bytes in GGUF row layout.
"""
from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType, GEOMETRY


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml's nearest_int: round-half-to-even (same as np.rint)."""
    return np.rint(x).astype(np.int32)


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8)


def quantize_q8_0(x: np.ndarray, imatrix=None) -> np.ndarray:
    x = x.reshape(-1, 32).astype(np.float32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = amax / 127.0
    id_ = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
    q = _nearest_int(x * id_).clip(-128, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=np.uint8)
    out[:, :2] = _f16_bytes(d[:, 0]).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def quantize_q4_0(x: np.ndarray, imatrix=None) -> np.ndarray:
    """ggml-quants.c quantize_row_q4_0_ref: d = signed-max / -8, offset-8 nibbles."""
    x = x.reshape(-1, 32).astype(np.float32)
    idx = np.abs(x).argmax(axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = maxv / -8.0
    id_ = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    xi = (x * id_[:, None] + 8.5).astype(np.int32).clip(0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=np.uint8)
    out[:, :2] = _f16_bytes(d).reshape(-1, 2)
    out[:, 2:] = xi[:, :16] | (xi[:, 16:] << 4)
    return out.reshape(-1)


def quantize_f16(x: np.ndarray, imatrix=None) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8).reshape(-1)


def quantize_f32(x: np.ndarray, imatrix=None) -> np.ndarray:
    return x.astype(np.float32).view(np.uint8).reshape(-1)


QUANTIZE_FNS = {
    GGMLType.F32: quantize_f32,
    GGMLType.F16: quantize_f16,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q8_0: quantize_q8_0,
}


def quantize(x: np.ndarray, ggml_type: GGMLType, imatrix=None) -> np.ndarray:
    fn = QUANTIZE_FNS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(
            f"quantize: the port encodes Q8_0, Q4_0, F16 and F32 only, not {ggml_type!r}")
    n = x.shape[-1]
    out = fn(x, imatrix)
    expect = GEOMETRY[ggml_type].row_bytes(n) * (x.size // n)
    assert out.size == expect, (ggml_type, out.size, expect)
    return out
