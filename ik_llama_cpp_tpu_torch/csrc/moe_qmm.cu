// MoE prefill over planar int8 experts with group scales: the grouped
// (ragged) dequant GEMM (kernel 14).
//
// Replaces ik_llama_cpp_tpu/ops/moe_qmm.py:ragged_qmatmul (the Pallas kernel
// of the planar expert GEMM, which a projection takes when it is not
// re-coded per supergroup of 256).
//
//   out[m, n] = sum_k x[m, k] w[e(m), k, n],
//   w[e, k, n] = bf16(bf16(codes[e, k, n]) * bf16(scale[e, k / group, n]))
//
// with e(m) the group (expert) that owns sorted row m. x is bf16 (M, K), the
// sums float32. Codes are stored (G, N, K), K-contiguous per output column
// (the experts' storage, which kernel 13 reads at decode); scales are
// (G, K / group, N), float32 or bf16 (float32 scales are rounded to bf16
// here). Rows at or past sum(group_sizes) are never written.
//
// Bound on the H100 by the expert bytes at the models' sizes (Qwen1.5-MoE-
// A2.7B's down projection at a 512-token chunk: 60 experts of K 1408 x N
// 2048 codes, ~34 rows an expert, 173 of the 184 MB moved), by bf16
// tensor-core work when the groups are long. Two kernels; the wrapper's
// plan (ops/moe_qmm.ragged_plan) picks one before the launch.
//
// ragged_wgmma_kernel: the warpgroup-MMA body of kernels D and 15
// (dq_wgmma.cuh: out^T = W^T x^T, the weights the wgmma A operand
// dequantized in registers, x the TMA-fed B operand, a ring of 64-deep
// stages under mbarriers, one producer thread, two consumer warpgroups)
// over the grouped work list of csrc/moe_grouped.cuh (shared with kernel
// 10): the block prefix-sums group_sizes in shared memory and walks sweeps
// (expert with rows, 128-column tile, TM of its rows: 64 or 128, from M /
// G) on a persistent grid sized from M, N and G alone (no host read, no
// step table); the sweeps of an (expert, column tile) are consecutive, so
// neighbouring blocks run them at once and each expert's codes come from
// device memory about once a column tile, shared in L2; only the expert's
// own rows are stored. K is never split and no sums
// meet in atomics: a call repeats bit for bit. The code tile is K-major
// (KMajorCodes): TMA loads 128 columns of 64 code bytes in its 64-byte
// swizzle, and each thread takes its fragment's codes with 16-bit shared
// loads, so the experts keep the one layout that kernel 13 reads too (a
// copy laid out N-major would double their memory).
//
// ragged_kernel, for the shapes TMA cannot address (scale rows that are
// not a multiple of 16 bytes, groups that neither divide 64 nor are a
// multiple of it): the first port's design (a grid of (N tiles, row
// tiles); each block runs one K sweep per group that owns
// some of its rows, a 64-deep slice of 64 columns dequantized to bf16 in
// shared memory for mma.sync, the next slice's loads in flight).
#include "dq_wgmma.cuh"
#include "moe_common.cuh"
#include "moe_grouped.cuh"

namespace {

// ------------------------------------------------------------ wgmma form --
IK_DEV uint32_t ld_u16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// int8 codes stored (G, N, K): a stage's tile is 128 columns of 64 code
// bytes (one TMA box, 64-byte rows), which TMA's 64-byte swizzle writes
// with 16-byte chunk c of column n at chunk c ^ ((n >> 1) & 3). (Under
// the 128-byte swizzle the 64-byte box did not arrive as dense 64-byte
// rows: wrong sums, and calls that did not repeat.) Thread
// (g, t) of the warp's 16-column chunk takes D's permuted fragment rows:
// row g is column l = 2g of the chunk, row g + 8 column l + 1. A 16-bit load
// gives one fragment register's codes (k 2t, 2t + 1 of a k16 step, or
// 2t + 8, 2t + 9) of one column; the 8 columns of a load fall on 4 bank
// groups, two ways each. Two columns' pairs make a register: bytes (l, k),
// (l, k + 1), (l + 1, k), (l + 1, k + 1).
struct KMajorCodes {
  static constexpr int ROWS = dqw::BK, NREG = 8, STATIC_SMEM = 0;
  static constexpr bool K_MAJOR = true;
  IK_DEV static void load(uint32_t (&r)[NREG], const unsigned char* tile, int lane, int chunk) {
    const int g = lane >> 2, t = lane & 3, key = g & 3;
    const unsigned char* p = tile + (16 * chunk + 2 * g) * 64 + 2 * t;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        r[2 * j + h] = ld_u16(p + ((j ^ key) << 4) + 8 * h) |
                       (ld_u16(p + 64 + ((j ^ key) << 4) + 8 * h) << 16);
  }
  template <bool BIAS>
  IK_DEV static void step(uint32_t (&a)[4], const uint32_t (&r)[NREG], int j, uint32_t sp,
                          uint32_t, const uint32_t*) {
    const uint32_t lo = r[2 * j] ^ 0x80808080u, hi = r[2 * j + 1] ^ 0x80808080u;
    const uint32_t s0 = dqw::splat(sp, 0), s1 = dqw::splat(sp, 1);
    a[0] = mul_rn(codes_pair(lo, 0, 1), s0);     // column l at k 2t, 2t + 1
    a[1] = mul_rn(codes_pair(lo, 2, 3), s1);     // column l + 1
    a[2] = mul_rn(codes_pair(hi, 0, 1), s0);     // ... at k 2t + 8, 2t + 9
    a[3] = mul_rn(codes_pair(hi, 2, 3), s1);
  }
};

// The work of kernel 14: the grouped sweeps of csrc/moe_grouped.cuh over
// 128-column tiles, as dq_wgmma_body's Sweeps. end, live, first, n_live:
// the map rows_map leaves in shared memory.
struct GroupedItems {
  static constexpr int SMEM = (3 * MAXG + 8) * 4;
  const int* end;
  const int* live;
  const int* first;
  const int* n_live;
  template <int TM, class Fn>
  IK_DEV void each(const dqw::Args& a, Fn&& fn) const {
    grouped_sweeps<TM>(end, live, first, *n_live, (a.N + dqw::TN - 1) / dqw::TN,
                       [&](int e, int m0, int m_end, int tile) {
                         fn(dqw::Sweep{m0, m_end, tile * dqw::TN, e * a.N, e * (a.K / a.G)});
                       });
  }
};

template <int TM, bool F32>
__global__ void __launch_bounds__(dqw::THREADS, 1)
ragged_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_s, float* __restrict__ out,
                    const dqw::Args a, const int* __restrict__ gsz, int experts) {
  __shared__ int s_end[MAXG], s_live[MAXG], s_first[MAXG + 1], s_n;
  rows_map<TM>(gsz, experts, a.M, s_end, s_live, s_first, &s_n);
  dqw::dq_wgmma_body<KMajorCodes, TM, dqw::Form<F32, false, false>, GroupedItems>(
      &map_x, &map_q, &map_s, &map_s, out, a, nullptr,
      GroupedItems{s_end, s_live, s_first, &s_n});
}

// The three tensor maps (x (M, K) bf16; the codes as (G N, K) bytes; the
// scales as (G K / group, N)) and the launch.
template <int TM, bool F32>
cudaError_t wgmma_go(const void* x, const void* codes, const void* scale, const void* gsz,
                     float* out, const dqw::Args& a, int G, int blocks, cudaStream_t s) {
  using L = dqw::Layout<TM, KMajorCodes::ROWS, GroupedItems::SMEM>;
  static_assert(L::BYTES + GroupedItems::SMEM <= dqw::SMEM_MAX, "shared memory of one block");
  auto kern = ragged_wgmma_kernel<TM, F32>;
  static bool smem_set = false;
  cudaError_t e = set_smem(kern, L::BYTES, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mq, ms;
  if ((e = tensor_map_2d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.K, a.M, (uint64_t)a.K * 2,
                         dqw::BK, TM, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return e;
  if ((e = tensor_map_2d(&mq, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.K, (uint64_t)G * a.N,
                         a.K, dqw::BK, dqw::TN, CU_TENSOR_MAP_SWIZZLE_64B)) != cudaSuccess)
    return e;
  if ((e = tensor_map_2d(&ms, scale,
                         F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                         a.N, (uint64_t)G * (a.K / a.G), (uint64_t)a.N * (F32 ? 4 : 2), dqw::TN,
                         a.sr, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
    return e;
  kern<<<blocks, dqw::THREADS, L::BYTES, s>>>(mx, mq, ms, out, a,
                                              static_cast<const int*>(gsz), G);
  return cudaGetLastError();
}

// ------------------------------------------------------- mma.sync form --
constexpr int NT = 256;            // threads a block (8 warps)
constexpr int TILE = 64;           // rows / columns of a tile
constexpr int BK = 64;             // K depth of a staged slice
constexpr int LDK = BK + 8;        // padded shared row (bf16): conflict-free fragment loads

// Four codes of one 32-bit word times s, rounded to bf16: two packed pairs.
IK_DEV void deq4(int w, float s, uint32_t& lo, uint32_t& hi) {
  lo = pack_bf16x2(static_cast<float>(static_cast<int8_t>(w)) * s,
                   static_cast<float>(static_cast<int8_t>(w >> 8)) * s);
  hi = pack_bf16x2(static_cast<float>(static_cast<int8_t>(w >> 16)) * s,
                   static_cast<float>(static_cast<int8_t>(w >> 24)) * s);
}

// 64 x 64 tiles, warps 2 (rows) x 4 (columns) of 32 x 16.
template <typename S>
__global__ void __launch_bounds__(NT)
ragged_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
              const S* __restrict__ scale, const int* __restrict__ gsz,
              float* __restrict__ out, int M, int N, int K, int G, int group) {
  __shared__ __align__(16) uint16_t sa_raw[TILE * LDK];   // x slice  [row][k]
  __shared__ __align__(16) uint16_t sb_raw[TILE * LDK];   // w slice  [column][k]
  __shared__ int s_end[MAXG];
  const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(sa_raw);
  const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(sb_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  for (int i = tid; i < G; i += NT) s_end[i] = gsz[i];
  __syncthreads();
  if (tid == 0)
    for (int i = 1; i < G; ++i) s_end[i] += s_end[i - 1];
  __syncthreads();
  const int rows_end = min(s_end[G - 1], M);
  if (m0 >= rows_end) return;
  const int m1 = min(m0 + TILE, rows_end);
  int grp = 0;
  while (s_end[grp] <= m0) ++grp;

  // what this thread stages: two 8-wide chunks of x, one 16-deep chunk of a column
  const int ar0 = tid >> 3, ar1 = ar0 + 32, akc = (tid & 7) * 8;
  const int bn = tid >> 2, bkc = (tid & 3) * 16;
  const int nk = (K + BK - 1) / BK, ngrp = K / group;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (; grp < G; ++grp) {
    const int start = grp ? s_end[grp - 1] : 0, end = s_end[grp];
    if (start >= m1) break;
    if (end == start) continue;
    const int lo = max(start, m0), hi = min(end, m1);
    const int8_t* bsrc = codes + ((size_t)grp * N + n0 + bn) * K;
    const S* ssrc = scale + (size_t)grp * ngrp * N + n0 + bn;
    uint4 ra0, ra1;
    int4 rb;
    float rs;
    auto fetch = [&](int s) {
      const int ka = s * BK + akc, kb = s * BK + bkc;
      ra0 = (m0 + ar0 < M && ka < K)
                ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + ar0) * K + ka) : zero4;
      ra1 = (m0 + ar1 < M && ka < K)
                ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + ar1) * K + ka) : zero4;
      const bool live = n0 + bn < N && kb < K;
      rb = live ? __ldg(reinterpret_cast<const int4*>(bsrc + kb)) : make_int4(0, 0, 0, 0);
      rs = live ? load_scale(ssrc + (size_t)(kb / group) * N) : 0.0f;
    };
    float acc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    fetch(0);
    for (int s = 0; s < nk; ++s) {
      *reinterpret_cast<uint4*>(sa_raw + ar0 * LDK + akc) = ra0;
      *reinterpret_cast<uint4*>(sa_raw + ar1 * LDK + akc) = ra1;
      uint4 w0, w1;
      deq4(rb.x, rs, w0.x, w0.y);
      deq4(rb.y, rs, w0.z, w0.w);
      deq4(rb.z, rs, w1.x, w1.y);
      deq4(rb.w, rs, w1.z, w1.w);
      *reinterpret_cast<uint4*>(sb_raw + bn * LDK + bkc) = w0;
      *reinterpret_cast<uint4*>(sb_raw + bn * LDK + bkc + 8) = w1;
      __syncthreads();
      if (s + 1 < nk) fetch(s + 1);
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[2][4], bf[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* p = sa + (wm + i * 16 + g8) * LDK + ks + t4 * 2;
          af[i][0] = ld32(p);
          af[i][1] = ld32(p + 8 * LDK);
          af[i][2] = ld32(p + 8);
          af[i][3] = ld32(p + 8 * LDK + 8);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const __nv_bfloat16* p = sb + (wn + j * 8 + g8) * LDK + ks + t4 * 2;
          bf[j][0] = ld32(p);
          bf[j][1] = ld32(p + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + wn + j * 8 + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm + i * 16 + g8 + h * 8;
          if (r < lo || r >= hi) continue;
          if (c < N) out[(size_t)r * N + c] = acc[i][j][2 * h];
          if (c + 1 < N) out[(size_t)r * N + c + 1] = acc[i][j][2 * h + 1];
        }
      }
  }
}

template <typename S>
cudaError_t launch(const void* x, const void* codes, const void* scale, const void* gsz,
                   void* out, int M, int N, int K, int G, int group, cudaStream_t stream) {
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  ragged_kernel<S><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const S*>(scale), static_cast<const int*>(gsz), static_cast<float*>(out),
      M, N, K, G, group);
  return cudaGetLastError();
}

}  // namespace

// scale_bf16: the scales are bf16 (else float32). K % 16 == 0, group % 16 == 0,
// K % group == 0, 1 <= G <= 1024. tile_m: the tokens of a sweep of the
// wgmma form (64 or 128) and blocks its persistent grid
// (ops/moe_qmm.ragged_plan); tile_m 0 takes the mma.sync form.
extern "C" int ik_ragged_qmatmul(const void* x, const void* codes, const void* scale,
                                 int scale_bf16, const void* gsz, void* out, int M, int N,
                                 int K, int G, int group, int tile_m, int blocks,
                                 void* stream) {
  if (K % 16 || group % 16 || K % group || G < 1 || G > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (tile_m == 0)
    return static_cast<int>(
        scale_bf16 ? launch<__nv_bfloat16>(x, codes, scale, gsz, out, M, N, K, G, group, s)
                   : launch<float>(x, codes, scale, gsz, out, M, N, K, G, group, s));
  dqw::Args a;
  if (!dqw::group_args(&a, M, N, K, group, !scale_bf16, 0, 0) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  switch (tile_m) {
    case 64:
      e = scale_bf16 ? wgmma_go<64, false>(x, codes, scale, gsz, o, a, G, blocks, s)
                     : wgmma_go<64, true>(x, codes, scale, gsz, o, a, G, blocks, s);
      break;
    case 128:
      e = scale_bf16 ? wgmma_go<128, false>(x, codes, scale, gsz, o, a, G, blocks, s)
                     : wgmma_go<128, true>(x, codes, scale, gsz, o, a, G, blocks, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
