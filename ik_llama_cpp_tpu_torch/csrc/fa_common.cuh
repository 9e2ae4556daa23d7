// Shared pieces of the prefill and decode flash-attention kernels: the mask,
// and one warp's online-softmax step over a KV tile of the decode kernels
// with bf16 tensor-core products (mma.sync.m16n8k16, float accumulate).
#pragma once

#include "common.cuh"

constexpr float FA_NEG = -1e30f;   // masked logit, as in the JAX kernels

struct FaMask {
  int kv_len, swa, chunk;
};

// Query at absolute position qp may see key: causal, inside the cache fill,
// inside the sliding window and inside its llama4 attention chunk.
IK_DEV bool fa_allowed(int key, int qp, const FaMask& mk) {
  bool ok = key <= qp && key < mk.kv_len;
  if (mk.swa > 0) ok = ok && key > qp - mk.swa;
  if (mk.chunk > 0) ok = ok && key >= (qp / mk.chunk) * mk.chunk;
  return ok;
}

// First key any query at position >= q_first may see.
IK_DEV int fa_first_key(int q_first, const FaMask& mk) {
  int start = 0;
  if (mk.swa > 0) start = max(start, q_first - mk.swa + 1);
  if (mk.chunk > 0) start = max(start, (q_first / mk.chunk) * mk.chunk);
  return start;
}

// One warp's running state for 16 query rows: output accumulator in mma C
// layout, running max m and this lane's partial row sum l for rows g, g+8.
template <int D, int KT>
struct FaWarp {
  float o[D / 8][4];
  float m[2], l[2];

  IK_DEV void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = FA_NEG;
    l[0] = l[1] = 0.f;
  }

  // S = Q K^T over a key-major tile sk (KT x LDK) and the warp's 16 query
  // rows sq (LDQ), scale, softcap and mask, then the online-softmax update
  // of m, l and o; leaves the tile's probabilities (float) in s. qp0/qp1:
  // absolute positions of rows g and g+8. ksc: null, or one float32 factor
  // per key of the tile (the row scales of a quantized K tile that holds
  // raw codes), applied to the score before ``scale``.
  template <int LDQ, int LDK>
  IK_DEV void softmax(float (&s)[KT / 8][4], const __nv_bfloat16* sq,
                      const __nv_bfloat16* sk, int key0, int qp0, int qp1,
                      const FaMask& mk, float scale, float softcap, int dk,
                      const float* ksc = nullptr) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D; kd += 16) {
      if (kd >= dk) break;
      uint32_t a[4];
      const __nv_bfloat16* pq = sq + g * LDQ + kd + 2 * t;
      a[0] = ld32(pq);
      a[1] = ld32(pq + 8 * LDQ);
      a[2] = ld32(pq + 8);
      a[3] = ld32(pq + 8 * LDQ + 8);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        uint32_t b[2];
        const __nv_bfloat16* pk = sk + (j * 8 + g) * LDK + kd + 2 * t;
        b[0] = ld32(pk);
        b[1] = ld32(pk + 8);
        mma_bf16_16816(s[j], a, b);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e];
        if (ksc != nullptr) v = __fmul_rn(v, ksc[j * 8 + 2 * t + (e & 1)]);
        v *= scale;
        if (softcap > 0.f) v = softcap * tanhf(v / softcap);
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        if (fa_allowed(key, (e < 2) ? qp0 : qp1, mk)) {
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        } else {
          v = FA_NEG;
        }
        s[j][e] = v;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[j][e];
        const float p = (v <= 0.1f * FA_NEG) ? 0.f : expf(v - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
  }

  // O += P V, P rounded to bf16, with V row-major in sv (KT x LD,
  // key-major, zero past dv): V's B fragments for dim groups 2np, 2np + 1
  // from one ldmatrix.trans.
  template <int LD>
  IK_DEV void pv_rows(const float (&s)[KT / 8][4], const __nv_bfloat16* sv, int dv) {
    const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      pack_p(a, s, kk);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (np * 16 >= dv) break;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (kk * 16 + (lm & 1) * 8 + lr) * LD + np * 16 + (lm >> 1) * 8);
        mma_bf16_16816(o[2 * np], a, vf);
        mma_bf16_16816(o[2 * np + 1], a, vf + 2);
      }
    }
  }

  // P's A fragment for keys 16kk .. 16kk + 15, rounded to bf16.
  static IK_DEV void pack_p(uint32_t* a, const float (&s)[KT / 8][4], int kk) {
    a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }

  // Sums each row's l over the four lanes that hold it.
  IK_DEV void finish() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};
