// The frame of the two prefill attention kernels: B (flash_attention.cu,
// a bf16 cache) and 6 (flash_attention_q8.cu, an int8 cache).
//
// A block takes one 64-query tile of a head (of FA_HEAD_WARPS warps of 16
// query rows) and walks only its live key range in tiles of KT keys (64,
// 32 for head dims above 128). The pieces here:
// - fa_load_rows: bf16 rows into shared memory by 16-byte cp.async copies,
//   zero-filled past the last row and past the head dim;
// - fa_tile_whole: whether every row of a warp sees a whole key tile (the
//   mask is applied only where it does not);
// - FaPrefillWarp: one warp's 16 query rows. Q's A fragments come from one
//   ldmatrix and stay in registers at head dims up to 128; a round takes
//   one key tile held row-major in shared memory (rows padded by 16 bytes,
//   so the eight rows of an 8x8 ldmatrix fall in distinct banks): S = Q K^T
//   from ldmatrix B fragments, scale (and softcap, a template parameter),
//   the mask where needed, the online softmax, then O += P V from
//   ldmatrix.trans of V; the store adds the sinks and normalises.
// The round keeps the float arithmetic of the kernels' first ports (scale,
// softcap, expf, the same order of sums), so that a kernel built on it
// gives their bits. With KSC (kernel 6: K holds raw int8 codes) each score
// is first multiplied by its key's float32 row scale; its multiplies are
// __fmul_rn so that the compiler contracts none of them into the expf
// argument, as in the first port, where a select stood between them.
#pragma once

#include "fa_common.cuh"

constexpr int FA_BQ = 64;           // query rows of a block's head
constexpr int FA_HEAD_WARPS = 4;    // warps of 16 query rows a head

// Rows [row0, row0 + ROWS) of a bf16 matrix with row stride rs into
// shared memory (ROWS x LD), 16-byte cp.async copies by NT threads; zero at
// rows >= end and at dims >= d. A thread copies the same 16 bytes of every
// NT / (D / 8)-th row.
template <int D, int ROWS, int LD, int NT>
IK_DEV void fa_load_rows(__nv_bfloat16* s, const __nv_bfloat16* base, long long rs, int row0,
                         int end, int d, int tid) {
  constexpr int CH = D / 8, RSTEP = NT / CH;
  static_assert(NT % CH == 0 && ROWS % RSTEP == 0, "whole rounds of 16-byte chunks");
  const int r0 = tid / CH, d0 = (tid % CH) * 8;
  const bool dim_ok = d0 < d;
  const __nv_bfloat16* src = base + (size_t)(row0 + r0) * rs + d0;
#pragma unroll
  for (int i = 0; i < ROWS / RSTEP; ++i) {
    const bool ok = dim_ok && row0 + r0 + i * RSTEP < end;
    cp_async16_zfill(s + (r0 + i * RSTEP) * LD + d0, ok ? src + (size_t)i * RSTEP * rs : base,
                     ok ? 16 : 0);
  }
}

// Every query in [q_first, q_last] sees every key of [key0, key0 + KT).
template <int KT>
IK_DEV bool fa_tile_whole(int key0, int q_first, int q_last, const FaMask& mk) {
  bool ok = key0 + KT - 1 <= q_first && key0 + KT <= mk.kv_len;
  if (mk.swa > 0) ok = ok && key0 > q_last - mk.swa;
  if (mk.chunk > 0) ok = ok && key0 >= (q_last / mk.chunk) * mk.chunk;
  return ok;
}

// The live key range of a query tile: [start, end) and its tile count.
struct FaKeyRange {
  int start, end, ntiles;
};

template <int KT>
IK_DEV FaKeyRange fa_key_range(int q_first, int nrows, const FaMask& mk) {
  const int end = min(mk.kv_len, q_first + nrows);
  const int start = fa_first_key(q_first, mk);
  return {start, end, end > start ? (end - start + KT - 1) / KT : 0};
}

// One warp's 16 query rows (rows g and g + 8 of lane (g, t)): Q's A
// fragments, the output accumulator in mma C layout, the running max and
// this lane's partial row sums, and the key bounds [lo, hi) of its rows.
// QREG: Q's fragments in registers (else read from shared memory by
// ldmatrix in every round: at D = 256, where the accumulator takes 128
// registers a lane).
template <int D, int KT, bool CAP>
struct FaPrefillWarp {
  static constexpr int LD = D + 8;
  static constexpr bool QREG = D <= 128;
  uint32_t qf[QREG ? D / 16 : 1][4];
  float o[D / 8][4];
  float m[2], l[2];
  int lo[2], hi[2];
  int wq_first, wq_last;
  const __nv_bfloat16* sq;     // the warp's 16 query rows in shared memory (LD)

  // sq_w: the warp's rows; qw: the absolute position of its first row;
  // wrows: how many of its 16 rows lie inside T.
  IK_DEV void init(const __nv_bfloat16* sq_w, int qw, int wrows, const FaMask& mk) {
    const int g = (threadIdx.x & 31) >> 2;
    sq = sq_w;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lo[r] = fa_first_key(qw + g + 8 * r, mk);
      hi[r] = min(qw + g + 8 * r + 1, mk.kv_len);
    }
    wq_first = qw;
    wq_last = qw + min(15, wrows - 1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = FA_NEG;
    l[0] = l[1] = 0.f;
  }

  // Q's A fragments into registers (QREG), once the rows have landed.
  IK_DEV void load_q() {
    const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
    if (QREG) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldmatrix_x4(qf[QREG ? kd : 0], sq + (lr + (lm & 1) * 8) * LD + kd * 16 + (lm >> 1) * 8);
    }
  }

  // One key tile [key0, key0 + KT): sk and sv row-major (KT x LD, zero past
  // the head dims and the fill). KSC: ksc holds the tile's K row scales.
  template <bool KSC>
  IK_DEV void round(const __nv_bfloat16* sk, const __nv_bfloat16* sv, const float* ksc,
                    int key0, const FaMask& mk, float scale, float softcap) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int lr = lane & 7, lm = lane >> 3;
    // S = Q K^T: K's fragments for key groups 2jj, 2jj + 1 from one ldmatrix
    float s[KT / 8][4];
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t a[4];
      if (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[QREG ? kd : 0][i];
      } else {
        ldmatrix_x4(a, sq + (lr + (lm & 1) * 8) * LD + kd * 16 + (lm >> 1) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sk + (jj * 16 + (lm >> 1) * 8 + lr) * LD + kd * 16 + (lm & 1) * 8);
        mma_bf16_16816(s[2 * jj], a, kf);
        mma_bf16_16816(s[2 * jj + 1], a, kf + 2);
      }
    }

    // (key scale,) scale and softcap; mask a tile some row does not see
    // whole: lane (g, t) holds keys key0 + 8i + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
      float2 ks = make_float2(1.f, 1.f);
      if (KSC) ks = *reinterpret_cast<const float2*>(ksc + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (KSC) {
          x = __fmul_rn(__fmul_rn(s[i][e], (e & 1) ? ks.y : ks.x), scale);
          if (CAP) x = __fmul_rn(softcap, tanhf(x / softcap));
        } else {
          x = s[i][e] * scale;
          if (CAP) x = softcap * tanhf(x / softcap);
        }
        s[i][e] = x;
      }
    }
    if (!fa_tile_whole<KT>(key0, wq_first, wq_last, mk)) {
      const int kt = key0 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rlo = lo[r] - kt, rhi = hi[r] - kt;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 8 * i + c;
            if (d < rlo || d >= rhi) s[i][2 * r + c] = FA_NEG;
          }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[i][e];
        const float p = (x <= 0.1f * FA_NEG) ? 0.f : expf(x - mx[e >> 1]);
        s[i][e] = p;
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

    // O += P V: P's A fragments from the score registers; V's B fragments
    // for dim groups 2np, 2np + 1 from one ldmatrix.trans of row-major V
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (kk * 16 + (lm & 1) * 8 + lr) * LD + np * 16 + (lm >> 1) * 8);
        mma_bf16_16816(o[2 * np], a, vf);
        mma_bf16_16816(o[2 * np + 1], a, vf + 2);
      }
    }
  }

  // Each row's sum over its four lanes, the head's sink in the denominator,
  // and the bf16 output of rows [row0 + wrow, ...) inside nrows: out is
  // (B, T, H, Dv) contiguous.
  IK_DEV void store(__nv_bfloat16* __restrict__ out, const float* __restrict__ sinks, int b,
                    int T, int H, int h, int row0, int wrow, int nrows, int Dv) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float corr[2] = {1.f, 1.f}, denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr_ = l[r];
      if (sinks != nullptr) {  // extra per-head logit in the denominator
        const float sk_ = sinks[h];
        const float mm = fmaxf(m[r], sk_);
        corr[r] = expf(m[r] - mm);
        lr_ = lr_ * corr[r] + expf(sk_ - mm);
      }
      denom[r] = (lr_ > 0.f) ? lr_ : 1.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      if (row >= nrows) continue;
      __nv_bfloat16* ob = out + (((size_t)b * T + row0 + row) * H + h) * Dv;
      const float f = corr[r] / denom[r];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + 2 * t;
        if (c >= Dv) break;
        *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16x2(o[n][2 * r] * f, o[n][2 * r + 1] * f);
      }
    }
  }
};
