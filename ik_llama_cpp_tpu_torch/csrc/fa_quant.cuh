// Tile loaders of the flash-attention kernels over a quantized KV cache:
// they read the packed rows of one kv head (ops/kv_quant.py layouts) with
// their float32 row scales and write bf16 tiles in the layout of
// fa_common.cuh (K key-major, V transposed).
//
// K tiles hold the raw codes: every code (|c| <= 127, the IQ4_NL levels
// included) is exact in bf16, and the score column of a key is multiplied by
// its row scale in float32 after the mma (FaWarp::step's ksc), which is the
// JAX kernels' q . (code * k_scale) up to float32 rounding. V tiles hold
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

// Keys [key0, key0 + KT) of one kv head -> sk (KT x LDK, raw codes), svt
// (D x LDV, bf16(code * v_scale), dim-major) and sks (KT k row scales).
// kbase/vbase: the head's first stored row; sks_b/svs_b: bytes between
// consecutive keys; kscale/vscale: the head's first scale, sss/svss floats
// between consecutive keys. Keys at or past key_end and dims past dk/dv
// are zero.
template <int CODEC, int D, int KT, int LDK, int LDV>
IK_DEV void fa_load_kv_quant(__nv_bfloat16* sk, __nv_bfloat16* svt, float* sks,
                             const uint8_t* __restrict__ kbase,
                             const uint8_t* __restrict__ vbase,
                             const float* __restrict__ kscale,
                             const float* __restrict__ vscale, long long sks_b,
                             long long svs_b, long long sss, long long svss,
                             int key0, int key_end, int dk, int dv,
                             const float* __restrict__ lut, int tid, int nthreads) {
  constexpr int CH = D / 8;
  for (int c = tid; c < KT * CH; c += nthreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const int key = key0 + r;
    float kc[8], vc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) kc[i] = vc[i] = 0.f;
    if (key < key_end) {
      if (d0 < dk) kvq_codes8<CODEC>(kbase + (size_t)key * sks_b, d0, dk, lut, kc);
      if (d0 < dv) {
        kvq_codes8<CODEC>(vbase + (size_t)key * svs_b, d0, dv, lut, vc);
        const float vs = vscale[(size_t)key * svss];
#pragma unroll
        for (int i = 0; i < 8; ++i) vc[i] = __fmul_rn(vc[i], vs);
      }
    }
    uint4 kv;
    kv.x = pack_bf16x2(kc[0], kc[1]);
    kv.y = pack_bf16x2(kc[2], kc[3]);
    kv.z = pack_bf16x2(kc[4], kc[5]);
    kv.w = pack_bf16x2(kc[6], kc[7]);
    *reinterpret_cast<uint4*>(sk + r * LDK + d0) = kv;
#pragma unroll
    for (int i = 0; i < 8; ++i) svt[(d0 + i) * LDV + r] = __float2bfloat16_rn(vc[i]);
  }
  for (int r = tid; r < KT; r += nthreads) {
    const int key = key0 + r;
    sks[r] = key < key_end ? kscale[(size_t)key * sss] : 0.f;
  }
}

// The arguments of both quantized-cache entry points. Strides st: q (b, t, h)
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
