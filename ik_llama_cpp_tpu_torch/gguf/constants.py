"""GGML/GGUF type constants and block-format geometry.

Mirrors the on-disk contract of the reference engine (ik_llama.cpp):
  - ggml_type enum values: the reference's ggml/include/ggml.h:392-491
  - block geometry (blck_size / type_size / row_meta_size):
    the reference's ggml/src/ggml.c type_traits table (:651+)
  - block structs: the reference's ggml/src/ggml-common.h

This module is pure metadata: no decoding logic lives here.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

QK_K = 256  # superblock size for all *_K / IQ*_K quants


class GGMLType(enum.IntEnum):
    """ggml_type enum — numeric values are the GGUF on-disk tensor dtype ids."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    MXFP4 = 39
    Q1_0_G128 = 41
    # ik_llama.cpp extensions
    Q6_0 = 133
    IQ1_BN = 134
    IQ2_BN = 135
    Q8_K64 = 136
    IQ2_K = 137
    IQ3_K = 138
    IQ4_K = 139
    IQ5_K = 140
    IQ6_K = 141
    IQ4_KS = 144
    IQ2_KS = 145
    IQ4_KSS = 146
    Q8_K16 = 147
    Q8_K32 = 148
    Q8_KR8 = 149
    Q8_K128 = 150
    Q8_KV = 151
    IQ5_KS = 152
    IQ2_KT = 153
    IQ3_KT = 154
    IQ4_KT = 155
    IQ3_KS = 156
    IQ2_KL = 157
    IQ1_KT = 158
    # row-interleaved repacked variants (CPU-specific in the reference; we
    # accept them in GGUF files and un-interleave at load time)
    Q4_0_R8 = 202
    Q5_0_R4 = 206
    Q8_0_R8 = 208
    Q2_K_R4 = 210
    Q3_K_R4 = 211
    Q4_K_R4 = 212
    Q5_K_R4 = 213
    Q6_K_R4 = 214
    IQ4_NL_R4 = 220
    IQ4_XS_R8 = 223
    BF16_R16 = 230
    Q6_0_R4 = 233
    IQ2_K_R4 = 337
    IQ3_K_R4 = 338
    IQ4_K_R4 = 339
    IQ5_K_R4 = 340
    IQ4_KS_R4 = 344
    IQ5_KS_R4 = 352
    Q8_KV_R8 = 398
    Q8_K_R8 = 399


@dataclass(frozen=True)
class BlockGeometry:
    """Geometry of one quant type's on-disk row layout.

    row_bytes(n) = row_meta + n // block_elems * block_bytes
    """

    block_elems: int  # elements per block (ggml blck_size)
    block_bytes: int  # bytes per block (ggml type_size)
    row_meta: int = 0  # per-row header bytes (ggml row_meta_size)

    def row_bytes(self, n_elems: int) -> int:
        assert n_elems % self.block_elems == 0, (n_elems, self.block_elems)
        return self.row_meta + (n_elems // self.block_elems) * self.block_bytes


# Geometry table — values mirror sizeof(block_*) from ggml-common.h.
GEOMETRY: dict[GGMLType, BlockGeometry] = {
    GGMLType.F32: BlockGeometry(1, 4),
    GGMLType.F16: BlockGeometry(1, 2),
    GGMLType.BF16: BlockGeometry(1, 2),
    GGMLType.F64: BlockGeometry(1, 8),
    GGMLType.I8: BlockGeometry(1, 1),
    GGMLType.I16: BlockGeometry(1, 2),
    GGMLType.I32: BlockGeometry(1, 4),
    GGMLType.I64: BlockGeometry(1, 8),
    GGMLType.Q4_0: BlockGeometry(32, 18),
    GGMLType.Q4_1: BlockGeometry(32, 20),
    GGMLType.Q5_0: BlockGeometry(32, 22),
    GGMLType.Q5_1: BlockGeometry(32, 24),
    GGMLType.Q6_0: BlockGeometry(32, 26),
    GGMLType.Q8_0: BlockGeometry(32, 34),
    GGMLType.Q8_1: BlockGeometry(32, 36),
    GGMLType.MXFP4: BlockGeometry(32, 17),
    GGMLType.Q2_K: BlockGeometry(QK_K, 2 * 2 + QK_K // 16 + QK_K // 4),          # 84
    GGMLType.Q3_K: BlockGeometry(QK_K, 2 + QK_K // 4 + QK_K // 8 + 12),          # 110
    GGMLType.Q4_K: BlockGeometry(QK_K, 2 * 2 + 12 + QK_K // 2),                  # 144
    GGMLType.Q5_K: BlockGeometry(QK_K, 2 * 2 + 12 + QK_K // 8 + QK_K // 2),      # 176
    GGMLType.Q6_K: BlockGeometry(QK_K, 2 + QK_K // 16 + 3 * QK_K // 4),          # 210
    GGMLType.Q8_K: BlockGeometry(QK_K, 8 + QK_K + QK_K // 16 * 2),               # 296
    GGMLType.IQ2_XXS: BlockGeometry(QK_K, 2 + QK_K // 8 * 2),                    # 66
    GGMLType.IQ2_XS: BlockGeometry(QK_K, 2 + QK_K // 8 * 2 + QK_K // 32),        # 74
    GGMLType.IQ3_XXS: BlockGeometry(QK_K, 2 + 3 * QK_K // 8),                    # 98
    GGMLType.IQ3_S: BlockGeometry(QK_K, 2 + 13 * QK_K // 32 + QK_K // 64),       # 110
    GGMLType.IQ2_S: BlockGeometry(QK_K, 2 + QK_K // 4 + QK_K // 16),             # 82
    GGMLType.IQ1_S: BlockGeometry(QK_K, 2 + QK_K // 8 + QK_K // 16),             # 50
    GGMLType.IQ1_M: BlockGeometry(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),    # 56
    GGMLType.IQ4_NL: BlockGeometry(32, 18),
    GGMLType.IQ4_XS: BlockGeometry(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),        # 136
    # --- ik extensions (ggml-common.h:616-790) ---
    GGMLType.IQ2_K: BlockGeometry(QK_K, 2 + 2 + QK_K // 32 + QK_K // 4),         # 76
    GGMLType.IQ2_KS: BlockGeometry(QK_K, 2 + QK_K // 64 + QK_K // 4, row_meta=2),  # 70
    GGMLType.IQ2_KL: BlockGeometry(QK_K, 2 + QK_K // 64 + QK_K // 4 + QK_K // 16, row_meta=2),  # 86
    GGMLType.IQ3_K: BlockGeometry(QK_K, 2 + 4 + QK_K // 32 + QK_K // 4 + QK_K // 8),  # 110
    GGMLType.IQ3_KS: BlockGeometry(QK_K, 2 + QK_K // 64 + QK_K // 4 + QK_K // 8, row_meta=2),  # 102
    GGMLType.IQ4_K: BlockGeometry(QK_K, 2 + 2 + QK_K // 2 + 3 * QK_K // 64),     # 144
    GGMLType.IQ4_KS: BlockGeometry(QK_K, QK_K // 32 + QK_K // 2, row_meta=4),    # 136
    GGMLType.IQ4_KSS: BlockGeometry(QK_K, QK_K // 8 * 4, row_meta=4),            # 128
    GGMLType.IQ5_K: BlockGeometry(QK_K, 2 + 2 + QK_K // 2 + QK_K // 8 + 3 * QK_K // 64),  # 176
    GGMLType.IQ5_KS: BlockGeometry(QK_K, QK_K // 32 + QK_K // 2 + QK_K // 8, row_meta=4),  # 168
    GGMLType.IQ6_K: BlockGeometry(QK_K, 2 + 2 + QK_K // 2 + QK_K // 4 + QK_K // 16),  # 212
    GGMLType.IQ1_KT: BlockGeometry(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32, row_meta=4),  # 56
    GGMLType.IQ2_KT: BlockGeometry(QK_K, QK_K // 4 + QK_K // 64, row_meta=4),    # 68
    GGMLType.IQ3_KT: BlockGeometry(QK_K, QK_K // 4 + QK_K // 8 + QK_K // 64, row_meta=4),  # 100
    GGMLType.IQ4_KT: BlockGeometry(QK_K, QK_K // 2, row_meta=4),                 # 128
    GGMLType.Q8_KV: BlockGeometry(32, 32, row_meta=8),
    GGMLType.Q8_K64: BlockGeometry(64, 4 + 64),
    GGMLType.Q8_K128: BlockGeometry(128, 4 + 8 + 128),
    GGMLType.IQ1_BN: BlockGeometry(64, 13, row_meta=2),
    GGMLType.IQ2_BN: BlockGeometry(64, 16, row_meta=4),
    GGMLType.Q1_0_G128: BlockGeometry(128, 2 + 16),
    # row-interleaved variants share the per-element density of their base type
    GGMLType.Q4_0_R8: BlockGeometry(32, 18),
    GGMLType.Q5_0_R4: BlockGeometry(32, 22),
    GGMLType.Q6_0_R4: BlockGeometry(32, 26),
    GGMLType.Q8_0_R8: BlockGeometry(32, 34),
    GGMLType.Q2_K_R4: BlockGeometry(QK_K, 84),
    GGMLType.Q3_K_R4: BlockGeometry(QK_K, 110),
    GGMLType.Q4_K_R4: BlockGeometry(QK_K, 144),
    GGMLType.Q5_K_R4: BlockGeometry(QK_K, 176),
    GGMLType.Q6_K_R4: BlockGeometry(QK_K, 210),
    GGMLType.IQ4_NL_R4: BlockGeometry(32, 18),
    GGMLType.IQ4_XS_R8: BlockGeometry(QK_K, 136),
    GGMLType.BF16_R16: BlockGeometry(1, 2),
    GGMLType.IQ2_K_R4: BlockGeometry(QK_K, 76),
    GGMLType.IQ3_K_R4: BlockGeometry(QK_K, 110),
    GGMLType.IQ4_K_R4: BlockGeometry(QK_K, 144),
    GGMLType.IQ5_K_R4: BlockGeometry(QK_K, 176),
    GGMLType.IQ4_KS_R4: BlockGeometry(QK_K, 136, row_meta=4),
    GGMLType.IQ5_KS_R4: BlockGeometry(QK_K, 168, row_meta=4),
    GGMLType.Q8_KV_R8: BlockGeometry(32, 32, row_meta=4),
    GGMLType.Q8_K_R8: BlockGeometry(QK_K, 2 + QK_K),
}


def row_bytes(ggml_type: GGMLType, n_elems: int) -> int:
    return GEOMETRY[ggml_type].row_bytes(n_elems)


# ---------------------------------------------------------------------------
# GGUF container constants (gguf v2/v3; reference reader: ggml.c:30988+)
# ---------------------------------------------------------------------------

GGUF_MAGIC = 0x46554747  # 'GGUF' little-endian
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


# Model file-type ids (llama_ftype, llama.h:158-216) — used by the quantize
# tool and reported by the loader. Only the subset we emit; loaders treat the
# value as informational.
class LlamaFtype(enum.IntEnum):
    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18
    MOSTLY_IQ2_XXS = 19
    MOSTLY_IQ2_XS = 20
    MOSTLY_Q2_K_S = 21
    MOSTLY_IQ3_XS = 22
    MOSTLY_IQ3_XXS = 23
    MOSTLY_IQ1_S = 24
    MOSTLY_IQ4_NL = 25
    MOSTLY_IQ3_S = 26
    MOSTLY_IQ3_M = 27
    MOSTLY_IQ2_S = 28
    MOSTLY_IQ2_M = 29
    MOSTLY_IQ4_XS = 30
    MOSTLY_IQ1_M = 31
    MOSTLY_BF16 = 32
    MOSTLY_Q6_0 = 135
    MOSTLY_IQ2_K = 147
    MOSTLY_IQ3_K = 148
    MOSTLY_IQ4_K = 149
    MOSTLY_IQ5_K = 150
    MOSTLY_IQ6_K = 151
    MOSTLY_IQ4_KS = 154
    MOSTLY_IQ2_KS = 155
    MOSTLY_IQ4_KSS = 156
    MOSTLY_Q8_KV = 158
    MOSTLY_IQ5_KS = 167
    MOSTLY_IQ2_KT = 168
    MOSTLY_IQ3_KT = 169
    MOSTLY_IQ4_KT = 170
    MOSTLY_IQ3_KS = 171
    MOSTLY_IQ2_KL = 172
    MOSTLY_IQ1_KT = 173
