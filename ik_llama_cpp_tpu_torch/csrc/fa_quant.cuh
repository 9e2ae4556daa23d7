// The codecs of the flash-attention kernels over a quantized KV cache
// (ops/kv_quant.py layouts) and the arguments of their entry points.
//
// Both kernels unpack K tiles to the raw codes: every code (|c| <= 127, the
// IQ4_NL levels included) is exact in bf16, and the score column of a key
// is multiplied by its float32 row scale after the mma, which is the JAX
// kernels' q . (code * k_scale) up to float32 rounding. V tiles hold
// bf16(code * v_scale), as the JAX kernels round V before the PV product.
#pragma once

#include "fa_common.cuh"

enum : int { KVQ_Q8 = 0, KVQ_Q4 = 1, KVQ_Q6 = 2, KVQ_NL4 = 3 };

// The 16 IQ4_NL levels, copied into shared memory by the kernels (a table
// in shared memory serves 32 different indices in one access).
__device__ const float KVQ_NL4_LEVELS[16] = {-127.f, -104.f, -83.f, -65.f, -49.f, -35.f,
                                             -22.f,  -10.f,  1.f,   13.f,  25.f,  38.f,
                                             53.f,   69.f,   89.f,  113.f};

// The codes of dims [d0, d0 + 8) of one stored row as floats; d is the head
// dim. One 8-byte load per bit plane: q8 needs d % 8 == 0, q4/nl4 d % 16 == 0
// (low nibbles are dims [0, d/2), high nibbles [d/2, d)), q6 d % 32 == 0
// (bytes [0, d/2) the low 4 bits packed as q4, bytes [d/2, 3d/4) the high 2
// bits of dims j, j + d/4, j + d/2, j + 3d/4 at bit pairs 0, 2, 4, 6).
template <int CODEC>
IK_DEV void kvq_codes8(const uint8_t* __restrict__ row, int d0, int d,
                       const float* __restrict__ lut, float* out) {
  if (CODEC == KVQ_Q8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + d0);
    const int8_t* c = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)c[i];
    return;
  }
  const int half = d >> 1;
  const int hi = d0 >= half;
  const uint2 w = *reinterpret_cast<const uint2*>(row + (hi ? d0 - half : d0));
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&w);
  const int sh = hi ? 4 : 0;
  if (CODEC == KVQ_Q4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)(((p[i] >> sh) & 0x0F) - 8);
  } else if (CODEC == KVQ_NL4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = lut[(p[i] >> sh) & 0x0F];
  } else {  // KVQ_Q6
    const int quarter = d >> 2;
    const int plane = d0 / quarter;            // which bit pair of the 2-bit plane
    const uint2 w2 = *reinterpret_cast<const uint2*>(row + half + (d0 - plane * quarter));
    const uint8_t* p2 = reinterpret_cast<const uint8_t*>(&w2);
    const int sh2 = 2 * plane;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[i] = (float)(((((p2[i] >> sh2) & 3) << 4) | ((p[i] >> sh) & 0x0F)) - 32);
  }
}

// The arguments of both entry points. Strides st: q (b, t, h)
// in elements; k and v codes (b, s, h) in bytes; k_s and v_s (b, s) in floats.
struct FaQuantArgs {
  const void *q, *k, *k_s, *v, *v_s, *qp, *kl, *sinks;
  void* out;
  int B, T, H, Hkv, Dk, Dv;
  long long st[13];
  float scale, softcap;
  int swa, chunk;
  cudaStream_t s;
};
