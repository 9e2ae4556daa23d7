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
// with e(m) the group that owns sorted row m. x is bf16 (M, K), the sums
// float32. Codes are stored (G, N, K), K-contiguous per output column;
// scales are (G, K / group, N), float32 or bf16 (a template parameter:
// float32 scales are rounded to bf16 here). group is any multiple of 16 that
// divides K, K any multiple of 16. Rows at or past sum(group_sizes) are
// never written.
//
// Bound on the H100: the expert bytes when the groups are short (every
// expert's codes are read once per row tile it owns rows in), bf16
// tensor-core work when they are long. Design: the row map of kernel 10 (a
// grid of (N tiles, row tiles) from M alone; each block prefix-sums
// group_sizes in shared memory, leaves when its rows are past the last
// group, and runs one K sweep per group that owns some of its rows, storing
// only those rows: no host read, no step table) around the inner loop of the
// planar GEMM (a 64-deep slice of 64 columns dequantized to bf16 in shared
// memory, mma.sync.m16n8k16). The next slice's global loads go into
// registers before the current slice's mma, so they overlap.
#include "moe_common.cuh"

namespace {

constexpr int NT = 256;            // threads a block (8 warps)
constexpr int TILE = 64;           // rows / columns of a tile
constexpr int BK = 64;             // K depth of a staged slice
constexpr int LDK = BK + 8;        // padded shared row (bf16): conflict-free fragment loads
constexpr int MAXG = 1024;         // groups the prefix sum holds

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
// K % group == 0, 1 <= G <= 1024.
extern "C" int ik_ragged_qmatmul(const void* x, const void* codes, const void* scale,
                                 int scale_bf16, const void* gsz, void* out, int M, int N,
                                 int K, int G, int group, void* stream) {
  if (K % 16 || group % 16 || K % group || G < 1 || G > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(scale_bf16
                              ? launch<__nv_bfloat16>(x, codes, scale, gsz, out, M, N, K, G, group, s)
                              : launch<float>(x, codes, scale, gsz, out, M, N, K, G, group, s));
}
