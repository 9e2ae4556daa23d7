// Flash attention over the MLA latent cache (the DeepSeek-2 family's absorb
// path, any T): many query heads over one kv head of head dims up to
// 576 / 512.
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention (Pallas,
// _fa_kernel) at the shapes models/deepseek2.py gives it: q (B, T, H, 576)
// = [latent-absorbed nope | roped pe] per head, k (B, S, 1, 576) the cached
// [latent | pe] rows, v (B, S, 1, 512) their first 512 columns. Kernel B
// (flash_attention.cu) takes head dims up to 256; this form takes the rest
// where there is one kv head.
//
// q: bf16 (B, T, H, Dk); k: bf16 (B, S, 1, Dk); v: bf16 (B, S, 1, Dv),
// Dk <= 576, Dv <= 512, multiples of 8, unit last strides; q_pos0, kv_len:
// int32 (B,) on the device. out: bf16 (B, T, H, Dv) contiguous. Causal
// online softmax against the cache fill level (no window, chunk, softcap or
// sinks: the wrapper refuses them).
//
// Bound on the H100: at T = 512 bf16 tensor-core operations on the live
// scores ((Dk + Dv) * 2 flops a live (row, key) pair); at T = 1 the cache
// bytes (~4.6 MB at 4,000 keys). Design:
// - MQA packing: a block takes 64 query rows of one batch, row = t * H + h
//   (the heads of 4 positions at H = 16), so the one latent head is read
//   once for all heads instead of once a head; a row's causal bound comes
//   from its position t. Blocks of the last rows (the longest key ranges)
//   are launched first.
// - Registers: a 64-row x 512 float accumulator is 256 floats a lane for 4
//   warps, more than the register file holds. Eight warps: warp (rg, ch)
//   owns rows 16 rg .. 16 rg + 15 and output columns 256 ch .. 256 ch + 255
//   (128 accumulator floats a lane). The two warps of a row group split the
//   QK^T contraction (dims 288 ch .. 288 ch + 287), swap their partial
//   scores through shared memory (a named barrier of the pair) and both
//   add the two halves (the same sum in both: float addition commutes), so
//   they run the same softmax and each multiplies P into its own half of V.
//   No product is computed twice.
// - Shared memory: the 64-row Q tile (75 KB) and a two-stage cp.async ring
//   of 32-key K tiles (37 KB each), rows padded by 16 bytes so that the
//   eight rows of an 8x8 ldmatrix fall in distinct banks (584 bf16 = 73
//   16-byte units). Where v is a view of k (the same base and strides, Dv
//   <= Dk), V's fragments come from the K tile itself (ldmatrix.trans of
//   its first Dv columns): each key row is loaded once. Otherwise V has its
//   own ring and the tiles are 16 keys.
// - Decode (few rows): the live keys are split over `splits` blocks of a
//   row tile (ops/flash_attention.mla_split_plan); each writes its float32
//   (max, sum, unnormalised output) to a scratch slot and the last block to
//   finish (an atomicAdd counter after a __threadfence, which it resets)
//   merges them in split order: one launch, no host sync, and a call
//   repeats bit for bit.
// The softmax keeps kernel B's float arithmetic (scale, expf, p rounded to
// bf16 for the PV product). The products are mma.sync.m16n8k16; wgmma and
// TMA are later work.
#include "fa_common.cuh"

namespace {

constexpr int MLA_DK = 576, MLA_DV = 512;   // the largest head dims taken
constexpr int BM = 64;                       // query rows of a block
constexpr int NW = 8, NT = NW * 32;          // 4 row groups x 2 halves
constexpr int LDK = MLA_DK + 8;              // padded Q / K row (bf16)
constexpr int LDV = MLA_DV + 8;              // padded V row (bf16)
constexpr int DH = MLA_DK / 2;               // a warp's half of the QK^T dims
constexpr int VH = MLA_DV / 2;               // a warp's half of the output columns

template <int KT, bool ALIAS>
struct MlaLayout {
  static constexpr int Q = BM * LDK;
  static constexpr int KTILE = KT * LDK;
  static constexpr int VTILE = ALIAS ? 0 : KT * LDV;
  static constexpr int XW = (KT / 8) * 4 * 32;          // floats: a warp's partial scores
  static constexpr int BYTES = (Q + 2 * KTILE + 2 * VTILE) * 2 + NW * XW * 4;
};

IK_DEV void bar_pair(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id)); }

// Rows [row0, row0 + ROWS) of a bf16 matrix of row stride rs into shared
// memory (ROWS x LD) by 16-byte cp.async copies; zero at rows >= end and at
// dims >= d.
template <int W, int ROWS, int LD>
IK_DEV void mla_load_rows(__nv_bfloat16* s, const __nv_bfloat16* base, long long rs, int row0,
                          int end, int d, int tid) {
  constexpr int CH = W / 8, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (c < N) {
      const int r = c / CH, d0 = (c % CH) * 8;
      const bool ok = d0 < d && row0 + r < end;
      cp_async16_zfill(s + r * LD + d0, ok ? base + (size_t)(row0 + r) * rs + d0 : base,
                       ok ? 16 : 0);
    }
  }
}

// The block's query rows: row r = t * H + h of batch b, zero past R rows
// and past Dk.
IK_DEV void mla_load_q(__nv_bfloat16* sq, const __nv_bfloat16* qb, long long sqt, long long sqh,
                       int H, int row0, int R, int Dk, int tid) {
  constexpr int CH = MLA_DK / 8, N = BM * CH;
#pragma unroll
  for (int i = 0; i < N / NT; ++i) {
    const int c = tid + i * NT;
    const int r = c / CH, d0 = (c % CH) * 8, gr = row0 + r;
    const bool ok = d0 < Dk && gr < R;
    cp_async16_zfill(sq + r * LDK + d0,
                     ok ? qb + (size_t)(gr / H) * sqt + (size_t)(gr % H) * sqh + d0 : qb,
                     ok ? 16 : 0);
  }
}

template <int KT, bool ALIAS>
__global__ void __launch_bounds__(NT, 1)
fa_mla_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos0,
              const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int splits, int T, int H,
              int Dk, int Dv, long long sqb, long long sqt, long long sqh, long long skb,
              long long sks, long long svb, long long svs, float scale) {
  using Lt = MlaLayout<KT, ALIAS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BM][LDK]
  __nv_bfloat16* sk = sq + Lt::Q;                                    // [2][KT][LDK]
  __nv_bfloat16* sv = sk + 2 * Lt::KTILE;                            // [2][KT][LDV]
  float* sx = reinterpret_cast<float*>(sv + 2 * Lt::VTILE);          // [NW][XW]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, ch = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int b = blockIdx.y, tile = gridDim.x - 1 - blockIdx.x;   // longest ranges first
  const int split = blockIdx.z;
  const int R = T * H, row0 = tile * BM, nrows = min(BM, R - row0);
  const int qpos = q_pos0[b], kvl = kv_len[b];

  // the block's keys: [0, end) for the tile, cut into `used` chunks of a
  // whole number of KT-key tiles where the call is split
  const int end = min(kvl, qpos + (row0 + nrows - 1) / H + 1);
  const bool whole = splits == 1 || end <= KT;
  int lo = 0, hi = end, used = 1;
  if (whole) {
    if (split > 0) return;
  } else {
    const int per = max(((end + splits - 1) / splits + KT - 1) / KT * KT, KT);
    used = (end + per - 1) / per;
    if (split >= used) return;
    lo = split * per;
    hi = min(lo + per, end);
  }
  const int ntiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  const __nv_bfloat16* kb = k + (size_t)b * skb;
  const __nv_bfloat16* vb = v + (size_t)b * svb;
  auto load_tile = [&](int stage, int key0) {
    mla_load_rows<MLA_DK, KT, LDK>(sk + stage * Lt::KTILE, kb, sks, key0, hi, Dk, tid);
    if (!ALIAS) mla_load_rows<MLA_DV, KT, LDV>(sv + stage * Lt::VTILE, vb, svs, key0, hi, Dv, tid);
  };
  mla_load_q(sq, q + (size_t)b * sqb, sqt, sqh, H, row0, R, Dk, tid);
  cp_async_commit();
  if (ntiles > 0) load_tile(0, lo);
  cp_async_commit();

  // this lane's rows g and g + 8 of the warp: their key bound (0 past R),
  // and the least bound of the warp's rows (tiles below it need no mask)
  int rhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + rg * 16 + g + 8 * r;
    rhi[r] = gr < R ? min(qpos + gr / H + 1, kvl) : 0;
  }
  const int wmin = __reduce_min_sync(0xffffffffu, min(rhi[0], rhi[1]));
  float o[VH / 8][4];
#pragma unroll
  for (int n = 0; n < VH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
  const __nv_bfloat16* sqw = sq + rg * 16 * LDK + ch * DH;
  float* xmine = sx + warp * Lt::XW;
  const float* xother = sx + (warp ^ 4) * Lt::XW;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();        // tile j (and Q) in shared memory ...
    __syncthreads();           // ... for every thread; tile j - 1 and the swap area are free
    const int key0 = lo + j * KT;
    if (j + 1 < ntiles) load_tile((j + 1) & 1, key0 + KT);
    cp_async_commit();
    const __nv_bfloat16* skt = sk + (j & 1) * Lt::KTILE;

    // this warp's half of S = Q K^T
    float s[KT / 8][4];
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll 2
    for (int kd = 0; kd < DH / 16; ++kd) {
      uint32_t a[4];
      ldmatrix_x4(a, sqw + (lr + (lm & 1) * 8) * LDK + kd * 16 + (lm >> 1) * 8);
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, skt + (jj * 16 + (lm >> 1) * 8 + lr) * LDK + ch * DH + kd * 16 +
                            (lm & 1) * 8);
        mma_bf16_16816(s[2 * jj], a, kf);
        mma_bf16_16816(s[2 * jj + 1], a, kf + 2);
      }
    }
    // swap halves with the other warp of the row group; both add the two
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) xmine[(i * 4 + e) * 32 + lane] = s[i][e];
    bar_pair(1 + rg);
#pragma unroll
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = (s[i][e] + xother[(i * 4 + e) * 32 + lane]) * scale;

    // the causal mask where some row of the warp does not see the whole
    // tile: lane (g, t) holds keys key0 + 8i + 2t + (e & 1)
    if (key0 + KT > wmin) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (key0 + 8 * i + 2 * t4 + c >= rhi[r]) s[i][2 * r + c] = FA_NEG;
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
    for (int i = 0; i < KT / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[i][e];
        const float p = (x <= 0.1f * FA_NEG) ? 0.f : expf(x - mx[e >> 1]);
        s[i][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < VH / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over this warp's half of the columns: V's fragments by
    // ldmatrix.trans of row-major V (the K tile's first columns under ALIAS)
    const __nv_bfloat16* svt = ALIAS ? skt : sv + (j & 1) * Lt::VTILE;
    constexpr int LDT = ALIAS ? LDK : LDV;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < VH / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, svt + (kk * 16 + (lm & 1) * 8 + lr) * LDT + ch * VH + np * 16 +
                                  (lm >> 1) * 8);
        mma_bf16_16816(o[2 * np], a, vf);
        mma_bf16_16816(o[2 * np + 1], a, vf + 2);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (whole) {                 // the output: out row (b, t, h) = b * R + row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = row0 + rg * 16 + g + 8 * r;
      if (gr >= R) continue;
      __nv_bfloat16* ob = out + ((size_t)b * R + gr) * Dv;
      const float f = 1.f / ((l[r] > 0.f) ? l[r] : 1.f);
#pragma unroll
      for (int n = 0; n < VH / 8; ++n) {
        const int c = ch * VH + n * 8 + 2 * t4;
        if (c >= Dv) break;
        *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16x2(o[n][2 * r] * f, o[n][2 * r + 1] * f);
      }
    }
    return;
  }

  // a split: (max, sum, unnormalised output) of each row to its scratch
  // slot [group][split] = o [BM][Dv], m [BM], l [BM]; the last block to
  // finish merges the slots in split order
  const int gi = b * gridDim.x + tile;
  const size_t psz = (size_t)BM * (Dv + 2);
  float* pb = part + ((size_t)gi * splits + split) * psz;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rg * 16 + g + 8 * r;
    if (row0 + row >= R) continue;
#pragma unroll
    for (int n = 0; n < VH / 8; ++n) {
      const int c = ch * VH + n * 8 + 2 * t4;
      if (c >= Dv) break;
      *reinterpret_cast<float2*>(pb + (size_t)row * Dv + c) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    if (ch == 0 && t4 == 0) {
      pb[(size_t)BM * Dv + row] = m[r];
      pb[(size_t)BM * Dv + BM + row] = l[r];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&counters[gi], 1);
    last_block = prev == used - 1;
    if (last_block) counters[gi] = 0;    // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // per row: the max over the splits, each split's factor and the sum
  // ([BM][used + 1] floats over the query tile, free by now)
  const float* p0 = part + (size_t)gi * splits * psz;
  float* rowv = reinterpret_cast<float*>(smem_raw);
  const int SV = used + 1;
  for (int r = tid; r < nrows; r += NT) {
    float mm = FA_NEG;
    for (int jx = 0; jx < used; ++jx) mm = fmaxf(mm, __ldcg(p0 + jx * psz + (size_t)BM * Dv + r));
    float ls = 0.f;
    for (int jx = 0; jx < used; ++jx) {
      const float* pj = p0 + jx * psz;
      const float f = expf(__ldcg(pj + (size_t)BM * Dv + r) - mm);
      ls += __ldcg(pj + (size_t)BM * Dv + BM + r) * f;
      rowv[r * SV + jx] = f;
    }
    rowv[r * SV + used] = ls;
  }
  __syncthreads();
  const int dv4 = Dv / 4;
  for (int idx = tid; idx < nrows * dv4; idx += NT) {
    const int r = idx / dv4, d = (idx % dv4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int jx = 0; jx < used; ++jx) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(p0 + jx * psz + (size_t)r * Dv + d));
      const float f = rowv[r * SV + jx];
      acc.x += x.x * f;
      acc.y += x.y * f;
      acc.z += x.z * f;
      acc.w += x.w * f;
    }
    const float ls = rowv[r * SV + used];
    const float inv = 1.f / (ls > 0.f ? ls : 1.f);
    __nv_bfloat16* ob = out + ((size_t)b * R + row0 + r) * Dv + d;
    *reinterpret_cast<uint32_t*>(ob) = pack_bf16x2(acc.x * inv, acc.y * inv);
    *reinterpret_cast<uint32_t*>(ob + 2) = pack_bf16x2(acc.z * inv, acc.w * inv);
  }
}

template <int KT, bool ALIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp, const void* kl,
                   void* out, void* part, void* counters, int splits, int B, int T, int H,
                   int Dk, int Dv, const long long* st, float scale, cudaStream_t s) {
  static bool smem_set = false;
  constexpr int smem = MlaLayout<KT, ALIAS>::BYTES;
  auto kern = fa_mla_kernel<KT, ALIAS>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const long long tiles = ((long long)T * H + BM - 1) / BM;
  if (B > 65535 || splits > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, B, splits);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kl), static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), splits, T, H, Dk, Dv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], scale);
  return cudaGetLastError();
}

}  // namespace

// alias: v is a view of k's first Dv columns (the same base and strides),
// so the K tile gives V's fragments too. part / counters: the split
// scratch (groups x splits x 64 x (Dv + 2) floats) and the groups' zeroed
// counters; unused (may be null) where splits == 1.
extern "C" int ik_flash_attention_mla(const void* q, const void* k, const void* v,
                                      const void* q_pos0, const void* kv_len, void* out,
                                      void* part, void* counters, int splits, int alias, int B,
                                      int T, int H, int Dk, int Dv, long long sqb,
                                      long long sqt, long long sqh, long long skb,
                                      long long sks, long long svb, long long svs,
                                      float scale, void* stream) {
  const long long st[7] = {sqb, sqt, sqh, skb, sks, svb, svs};
  auto s = static_cast<cudaStream_t>(stream);
  if (Dk > MLA_DK || Dv > MLA_DV || Dk % 8 || Dv % 8 || splits < 1 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      alias ? launch<32, true>(q, k, v, q_pos0, kv_len, out, part, counters, splits, B, T, H,
                               Dk, Dv, st, scale, s)
            : launch<16, false>(q, k, v, q_pos0, kv_len, out, part, counters, splits, B, T, H,
                                Dk, Dv, st, scale, s);
  return static_cast<int>(e);
}
