// int8 x int8 GEMM with supergroup-256 float corrections.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul_i8_mxu (the Pallas
// prefill kernel, _make_kernel_i8) and the XLA qmatmul_i8 that the JAX
// package uses below M = 256: one kernel for every M, with the launch shape
// chosen by M.
//
//   out[m, n] = sum_g  xs[m, g] * sw[g, n] * sum_{k in g} xq[m, k] * w[k, n]
//
// xq: int8 (M, K) row-major; xs: f32 (M, K/256); wt: int8 (N, K) row-major
// (the weight codes stored transposed so both operands are K-contiguous);
// sw: f32 (K/256, N); out: f32 (M, N). K % 256 == 0.
//
// Bound on the H100: at decode (M <= 16) the weight bytes (1 per weight plus
// 4/256 per weight of scales) bound it; at prefill (M = 512) the int8
// tensor-core operations do. Design: tensor cores through
// mma.sync.m16n8k32.s8 on shared-memory tiles, one 256-deep supergroup per
// pipeline stage (so the int32 partial is exact and its float correction
// happens once per stage), a cp.async ring of stages to keep weight bytes
// in flight. M <= 16 takes a 16 x 32 tile so that N/32 blocks stream the
// weights; larger M takes 128 x 128 tiles. wgmma, TMA and split-K are later
// work.
#include "common.cuh"

namespace {

constexpr int SG = 256;          // supergroup depth
constexpr int LDS = SG + 16;     // padded shared row (bytes): conflict-free fragment loads

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ wt, const float* __restrict__ sw,
                  float* __restrict__ out, int M, int N, int K) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int CH = SG / 16;    // 16-byte chunks per row per stage
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sa = smem;                           // [STAGES][BM][LDS]
  int8_t* sb = smem + STAGES * BM * LDS;       // [STAGES][BN][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nsg = K / SG;

  auto load_stage = [&](int slot, int sgi) {
    const size_t koff = (size_t)sgi * SG;
    for (int c = tid; c < BM * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 16;
      const int gm = min(m0 + r, M - 1);       // ragged rows: repeat the last row
      cp_async16(sa + (slot * BM + r) * LDS + col, xq + (size_t)gm * K + koff + col);
    }
    for (int c = tid; c < BN * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 16;
      const int gn = min(n0 + r, N - 1);
      cp_async16(sb + (slot * BN + r) * LDS + col, wt + (size_t)gn * K + koff + col);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsg) load_stage(s, s);
    cp_async_commit();
  }

  for (int sgi = 0; sgi < nsg; ++sgi) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = sgi + STAGES - 1;          // refill the slot read last iteration
    if (nxt < nsg) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const int8_t* a_st = sa + (sgi % STAGES) * BM * LDS;
    const int8_t* b_st = sb + (sgi % STAGES) * BN * LDS;
    int part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0;

#pragma unroll
    for (int kk = 0; kk < SG; kk += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = a_st + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = b_st + (wn + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8_16832(part[i][j], af[i], bf[j]);
    }

    // rank-1 supergroup correction: acc += part * (xs[m, g] * sw[g, n])
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r0 = min(m0 + wm + i * 16 + g, M - 1);
      const int r1 = min(m0 + wm + i * 16 + g + 8, M - 1);
      const float xs0 = xs[(size_t)r0 * nsg + sgi];
      const float xs1 = xs[(size_t)r1 * nsg + sgi];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c0 = min(n0 + wn + j * 8 + t * 2, N - 1);
        const int c1 = min(n0 + wn + j * 8 + t * 2 + 1, N - 1);
        const float sw0 = sw[(size_t)sgi * N + c0];
        const float sw1 = sw[(size_t)sgi * N + c1];
        acc[i][j][0] += (float)part[i][j][0] * (xs0 * sw0);
        acc[i][j][1] += (float)part[i][j][1] * (xs0 * sw1);
        acc[i][j][2] += (float)part[i][j][2] * (xs1 * sw0);
        acc[i][j][3] += (float)part[i][j][3] * (xs1 * sw1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = n0 + wn + j * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + i * 16 + g + h * 8;
        if (r >= M) continue;
        if (c < N) out[(size_t)r * N + c] = acc[i][j][2 * h];
        if (c + 1 < N) out[(size_t)r * N + c + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch(const int8_t* xq, const float* xs, const int8_t* wt,
                   const float* sw, float* out, int M, int N, int K,
                   cudaStream_t stream) {
  static bool smem_set = false;
  constexpr int smem = STAGES * (BM + BN) * LDS;
  auto kern = qmatmul_i8_kernel<BM, BN, WM, WN, STAGES>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(xq, xs, wt, sw, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ik_qmatmul_i8(const void* xq, const void* xs, const void* wt,
                             const void* sw, void* out, int M, int N, int K,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(xq);
  auto b = static_cast<const int8_t*>(wt);
  auto as = static_cast<const float*>(xs);
  auto bs = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  cudaError_t e;
  if (M <= 16)
    e = launch<16, 32, 16, 8, 4>(a, as, b, bs, o, M, N, K, s);
  else
    e = launch<128, 128, 64, 32, 2>(a, as, b, bs, o, M, N, K, s);
  return static_cast<int>(e);
}
