// Prefill flash attention (T > 16).
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention (Pallas,
// _fa_kernel with the _make_tile_clamp index maps).
//
// q: bf16 (B, T, H, Dk); k: bf16 (B, S, Hkv, Dk); v: bf16 (B, S, Hkv, Dv),
// all with a unit last stride and the other strides given in elements;
// q_pos0, kv_len: int32 (B,) on the device; sinks: f32 (H,) or null.
// out: bf16 (B, T, H, Dv) contiguous. Causal online softmax with GQA,
// logit softcap, sliding window, llama4 attention chunks and per-head sinks.
//
// Bound on the H100: bf16 tensor-core operations over the live (causal)
// part of the score matrix; at T = 512 the K/V bytes are small next to
// them, and a block's serial walk over its key tiles (the last query tile
// walks the most) sets the time more than the card's rate. Design: one
// block per (head, batch, 64-query tile), four warps of 16 query rows,
// 64-key tiles (32 for head dims above 128). A block loops only over its
// live key range, from the first key its window or chunk allows to
// min(kv_len, last query position + 1), which is what the TPU kernel's
// tile clamp did with skipped DMAs. Each piece of a tile's round is kept
// short:
// - K and V stay row-major in shared memory, rows padded by 16 bytes so
//   the eight rows of an 8x8 ldmatrix fall in distinct banks; K's B
//   fragments come from ldmatrix, V's from ldmatrix.trans (no transpose).
// - A two-stage cp.async ring: tile j + 1 is in flight while tile j's QK^T,
//   softmax and PV run; one barrier a tile.
// - Q's A fragments are loaded once with ldmatrix and held in registers
//   for D <= 128 (at D = 256 the output accumulator takes 128 registers a
//   lane, so Q stays in shared memory and is read with ldmatrix).
// - The query tiles with the longest key ranges (the last ones) are
//   launched first: the grid's slowest dimension walks the tiles backwards.
// - A tile's round is short in instructions. With one warp on each SM
//   sub-partition there is little to hide latency, and code that does not
//   run still costs fetch time (the first form of this kernel, with an
//   unused softcap branch and a per-score mask test in the round, took
//   twice as long; PERF.md): the mask is two compares a score
//   against each row's key bounds [lo, hi), only on tiles some row of the
//   warp does not see whole; softcap is a template parameter; Q, K and V
//   are zero-filled past Dk and Dv, so no loop has a runtime bound.
// - The softmax keeps the float arithmetic of this kernel's first port
//   (scale, softcap, expf, the same order of sums), so the redesign gives
//   its bits (PERF.md): a faster ex2 in log2 units moved some
//   outputs by a bf16 ulp, enough to flip a near-tie greedy pick in
//   chip_smoke.py's phase 5.
// The products are mma.sync.m16n8k16 (bf16, float accumulate); wgmma, TMA
// and K/V shared across the heads of a GQA group are later work.
#include "fa_common.cuh"

namespace {

constexpr int BQ = 64, NWARP = 4, NT = NWARP * 32;

template <int D, int KT>
struct Layout {
  static constexpr int LD = D + 8;          // padded row (bf16)
  static constexpr int Q = BQ * LD;         // the query tile
  static constexpr int TILE = KT * LD;      // one K or V tile
  static constexpr int BYTES = (Q + 4 * TILE) * 2;   // Q, two stages of K and V
};

// Rows [row0, row0 + ROWS) of a bf16 matrix with row stride rs into
// shared memory (ROWS x LD), 16-byte cp.async copies; zero at rows >= end
// and at dims >= d. A thread copies the same 16 dims of every NT / (D / 8)-th
// row.
template <int D, int ROWS, int LD>
IK_DEV void load_rows(__nv_bfloat16* s, const __nv_bfloat16* base, long long rs, int row0,
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
IK_DEV bool tile_whole(int key0, int q_first, int q_last, const FaMask& mk) {
  bool ok = key0 + KT - 1 <= q_first && key0 + KT <= mk.kv_len;
  if (mk.swa > 0) ok = ok && key0 > q_last - mk.swa;
  if (mk.chunk > 0) ok = ok && key0 >= (q_last / mk.chunk) * mk.chunk;
  return ok;
}

// CAP: a logit softcap (a second instantiation, so the common path carries
// no tanh code).
template <int D, int KT, bool CAP>
__global__ void __launch_bounds__(NT)
fa_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ q_pos0, const int* __restrict__ kv_len,
                  const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                  int T, int H, int Hkv, int Dk, int Dv, long long sqb, long long sqt,
                  long long sqh, long long skb, long long sks, long long skh,
                  long long svb, long long svs, long long svh, float scale,
                  float softcap, int swa, int chunk) {
  using L = Layout<D, KT>;
  constexpr int LD = L::LD;
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LD]
  __nv_bfloat16* sk = sq + L::Q;                                     // [2][KT][LD]
  __nv_bfloat16* sv = sk + 2 * L::TILE;                              // [2][KT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8
  const int lr = lane & 7, lm = lane >> 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest key ranges first
  const int hk = h / (H / Hkv);
  const int nrows = min(BQ, T - row0);
  const int qpos = q_pos0[b];
  const FaMask mk{kv_len[b], swa, chunk};

  const int key_end = min(mk.kv_len, qpos + row0 + nrows);
  const int key_start = fa_first_key(qpos + row0, mk);
  const int ntiles = key_end > key_start ? (key_end - key_start + KT - 1) / KT : 0;
  const __nv_bfloat16* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const __nv_bfloat16* vb = v + (size_t)b * svb + (size_t)hk * svh;
  auto load_tile = [&](int stage, int key0) {
    load_rows<D, KT, LD>(sk + stage * L::TILE, kb, sks, key0, key_end, Dk, tid);
    load_rows<D, KT, LD>(sv + stage * L::TILE, vb, svs, key0, key_end, Dv, tid);
  };

  // Q, K and V are zero past Dk / Dv, so the products run over all D dims
  load_rows<D, BQ, LD>(sq, q + (size_t)b * sqb + (size_t)h * sqh, sqt, row0, T, Dk, tid);
  cp_async_commit();
  if (ntiles > 0) load_tile(0, key_start);
  cp_async_commit();

  // the keys rows g and g + 8 may see: [lo, hi) (fa_allowed as bounds), and
  // the span of the warp's rows inside T
  const int qp0 = qpos + row0 + warp * 16 + g;
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] = fa_first_key(qp0 + 8 * r, mk);
    hi[r] = min(qp0 + 8 * r + 1, mk.kv_len);
  }
  const int wq_first = qpos + row0 + warp * 16;
  const int wq_last = qpos + row0 + min(warp * 16 + 15, nrows - 1);
  const __nv_bfloat16* sq_w = sq + warp * 16 * LD;

  uint32_t qf[QREG ? D / 16 : 1][4];
  cp_async_wait<1>();          // the query tile
  __syncthreads();
  if (QREG) {
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      ldmatrix_x4(qf[QREG ? kd : 0], sq_w + (lr + (lm & 1) * 8) * LD + kd * 16 + (lm >> 1) * 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();        // tile j is in shared memory ...
    __syncthreads();           // ... for every thread, and tile j - 1 is read
    const int key0 = key_start + j * KT;
    if (j + 1 < ntiles) load_tile((j + 1) & 1, key0 + KT);
    cp_async_commit();
    const __nv_bfloat16* skj = sk + (j & 1) * L::TILE;
    const __nv_bfloat16* svj = sv + (j & 1) * L::TILE;

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
        ldmatrix_x4(a, sq_w + (lr + (lm & 1) * 8) * LD + kd * 16 + (lm >> 1) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, skj + (jj * 16 + (lm >> 1) * 8 + lr) * LD + kd * 16 + (lm & 1) * 8);
        mma_bf16_16816(s[2 * jj], a, kf);
        mma_bf16_16816(s[2 * jj + 1], a, kf + 2);
      }
    }

    // scale and softcap; mask a tile some row does not see whole: lane
    // (g, t) holds keys key0 + 8i + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale;
        if (CAP) x = softcap * tanhf(x / softcap);
        s[i][e] = x;
      }
    if (!tile_whole<KT>(key0, wq_first, wq_last, mk)) {
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
        ldmatrix_x4_trans(vf, svj + (kk * 16 + (lm & 1) * 8 + lr) * LD + np * 16 + (lm >> 1) * 8);
        mma_bf16_16816(o[2 * np], a, vf);
        mma_bf16_16816(o[2 * np + 1], a, vf + 2);
      }
    }
  }
  cp_async_wait<0>();

  // each row's l over the four lanes that hold it
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
    const int row = warp * 16 + g + 8 * r;
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

template <int D, int KT, bool CAP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, int B, int T,
                   int H, int Hkv, int Dk, int Dv, const long long* st, float scale,
                   float softcap, int swa, int chunk, cudaStream_t s) {
  static bool smem_set = false;
  constexpr int smem = Layout<D, KT>::BYTES;
  auto kern = fa_prefill_kernel<D, KT, CAP>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int tiles = (T + BQ - 1) / BQ;
  if (B > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(H, B, tiles);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kl), static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, Dk, Dv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, swa, chunk);
  return cudaGetLastError();
}

template <int D, int KT>
cudaError_t by_cap(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, int B, int T, int H,
                   int Hkv, int Dk, int Dv, const long long* st, float scale,
                   float softcap, int swa, int chunk, cudaStream_t s) {
  return softcap > 0.f
             ? launch<D, KT, true>(q, k, v, qp, kl, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                                   scale, softcap, swa, chunk, s)
             : launch<D, KT, false>(q, k, v, qp, kl, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                                    scale, softcap, swa, chunk, s);
}

}  // namespace

extern "C" int ik_flash_attention(const void* q, const void* k, const void* v,
                                  const void* q_pos0, const void* kv_len,
                                  const void* sinks, void* out, int B, int T,
                                  int H, int Hkv, int Dk, int Dv, long long sqb,
                                  long long sqt, long long sqh, long long skb,
                                  long long sks, long long skh, long long svb,
                                  long long svs, long long svh, float scale,
                                  float softcap, int swa, int chunk,
                                  void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh};
  auto s = static_cast<cudaStream_t>(stream);
  const int dmax = Dk > Dv ? Dk : Dv;
  cudaError_t e;
  if (dmax <= 64)
    e = by_cap<64, 64>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                       st, scale, softcap, swa, chunk, s);
  else if (dmax <= 128)
    e = by_cap<128, 64>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                        st, scale, softcap, swa, chunk, s);
  else
    e = by_cap<256, 32>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                        st, scale, softcap, swa, chunk, s);
  return static_cast<int>(e);
}
