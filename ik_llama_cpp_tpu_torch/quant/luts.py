"""Codebook lookup tables for non-linear quant formats.

Values mirror the reference codebooks (ggml-common.h:2212-2255 and
iqk_gemm_legacy_quants.cpp:2702). These are *data contracts* of the GGUF
formats, not code: any decoder of these formats must use identical tables.
"""
from __future__ import annotations

import numpy as np

# 4-bit non-linear codebook (IQ4_NL / IQ4_XS) == first half of IQ4K_VALUES.
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8,
)

# IQ4_K / IQ4_KS / IQ4_KSS / IQ1_KT scale codebook: two shifted 16-entry halves.
IQ4K_VALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113,
     -123, -100, -79, -61, -45, -31, -18, -6, 5, 17, 29, 42, 57, 73, 93, 117],
    dtype=np.int8,
)

# IQ2_K / IQ2_KS codebook: 4 values + shifted variant.
IQ2NL_VALUES = np.array([-31, -13, 1, 17, -26, -8, 6, 22], dtype=np.int8)

# IQ2_KL: 32 pairs of int8 values packed little-endian into uint16.
IQ2KL_VALUES_U16 = np.array(
    [0xe9c1, 0x0dc1, 0xc1d8, 0xf6d8, 0x0dd8, 0x2fd8, 0xd8e9, 0xe9e9,
     0x01e9, 0x0de9, 0x1ce9, 0xc1f6, 0x01f6, 0x0df6, 0x2ff6, 0xe901,
     0xf601, 0x0101, 0x0d01, 0x1c01, 0xd80d, 0xe90d, 0xf60d, 0x010d,
     0x0d0d, 0xc11c, 0xe91c, 0x011c, 0x1c1c, 0x2f1c, 0xe92f, 0x0d2f],
    dtype=np.uint16,
)
# (32, 2) int8: [:, 0] is the first (even-position) value, [:, 1] the second.
IQ2KL_PAIRS = IQ2KL_VALUES_U16.view(np.uint8).reshape(32, 2).view(np.int8)

# IQ3_K / IQ3_KS codebook: 8 values + shifted variant.
IQ3NL_VALUES = np.array(
    [-63, -40, -23, -10, 1, 13, 28, 47, -59, -36, -19, -6, 5, 17, 32, 51],
    dtype=np.int8,
)

# IQ5_K / IQ5_KS codebook: 32 values + shifted variant.
IQ5NL_VALUES = np.array(
    [-126, -114, -103, -92, -83, -74, -65, -57, -50, -43, -36, -30, -24, -18,
     -12, -6, -1, 5, 11, 17, 23, 29, 36, 43, 51, 59, 68, 77, 87, 97, 109, 121,
     -124, -112, -101, -90, -81, -72, -63, -55, -48, -41, -34, -28, -22, -16,
     -10, -4, 1, 7, 13, 19, 25, 31, 38, 45, 53, 61, 70, 79, 89, 99, 111, 123],
    dtype=np.int8,
)

# IQ6_K codebook: 64 values + shifted variant. The reference evaluates a cubic
# polynomial at dequant time (iqk_quantize.cpp:3442-3446); the polynomial was
# fitted to this table, which we materialize directly:
#   v(q) = round(A + q*(B + q*(-C + q*D))), A=-127, B=6.2568, C=0.11218, D=0.0011972
_q = np.arange(64, dtype=np.float64)
_poly = -127.0 + _q * (6.2568 + _q * (-0.11218 + _q * 0.0011972))
IQ6NL_VALUES = np.array(
    [-127, -121, -115, -109, -104, -98, -93, -88, -84, -79, -74, -70, -66, -62,
     -58, -54, -51, -47, -44, -40, -37, -34, -31, -28, -25, -22, -19, -16, -13,
     -11, -8, -5, -2, 0, 3, 6, 9, 12, 14, 17, 20, 23, 27, 30, 33, 36, 40, 44,
     47, 51, 55, 59, 63, 68, 72, 77, 82, 87, 92, 98, 103, 109, 115, 121,
     -126, -120, -114, -108, -103, -97, -92, -87, -83, -78, -73, -69, -65, -61,
     -57, -53, -50, -46, -43, -39, -36, -33, -30, -27, -24, -21, -18, -15, -12,
     -10, -7, -4, -1, 1, 4, 7, 10, 13, 15, 18, 21, 24, 28, 31, 34, 37, 41, 45,
     48, 52, 56, 60, 64, 69, 73, 78, 83, 88, 93, 99, 104, 110, 116, 122],
    dtype=np.int8,
)

# IQ6_K dequant polynomial constants (used instead of the table to match the
# reference's float dequant bit-for-bit).
IQ6K_A, IQ6K_B, IQ6K_C, IQ6K_D, IQ6K_S = -127.0, 6.2568, 0.11218, 0.0011972, 1.0

# MXFP4: e2m1 values doubled (OCP MX spec).
KVALUES_MXFP4 = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], dtype=np.int8
)
