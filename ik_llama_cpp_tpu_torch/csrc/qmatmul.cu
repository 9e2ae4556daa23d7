// Planar dequant x matmul.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul (Pallas, _make_kernel).
//
//   out = x @ W,   W[k, n] = bf16(bf16(codes[k, n]) * scale[k/G, n]) (+ bias[k/G, n] in bf16)
//
// x: bf16 (M, K) row-major; codes: int8 (K, N); scale, bias: bf16 (K/G, N);
// out: f32 (M, N). Any M, N, K with K % G == 0. The dequant chain runs in
// bf16 with float sums, which is qmatmul_ref's numerics contract.
//
// Bound on the H100: weight bytes (1 per weight plus 2/G per weight for
// scales) at small M, bf16 tensor-core operations at large M. Design: a
// simple tiled kernel. Each block dequantizes a 32-deep slice of its 64
// columns into shared memory (K-contiguous per column, so the bf16
// mma.sync.m16n8k16 B fragment is one 32-bit load), loads the matching x
// slice, and accumulates in float registers. No copy/compute overlap yet:
// this path runs only when K % 256 != 0 or the int8 path is off.
#include "common.cuh"

namespace {

constexpr int BN = 64, BK = 32, LDK = BK + 8;  // padded smem row (bf16)

template <int BM, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
               const __nv_bfloat16* __restrict__ scale,
               const __nv_bfloat16* __restrict__ bias, float* __restrict__ out,
               int M, int N, int K, int G) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) uint16_t sa_raw[BM * LDK];
  __shared__ __align__(16) uint16_t sb_raw[BN * LDK];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(sa_raw);   // [BM][LDK]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sb_raw);   // [BN][LDK], K-contiguous

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK; c += NT) {
      const int r = c / BK, kk = c % BK;
      const int gm = m0 + r, gk = k0 + kk;
      sa[r * LDK + kk] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : zero;
    }
    for (int c = tid; c < BN * BK; c += NT) {
      const int kk = c / BN, nn = c % BN;      // neighbouring threads: neighbouring columns
      const int gk = k0 + kk, gn = n0 + nn;
      __nv_bfloat16 w = zero;
      if (gk < K && gn < N) {
        const size_t sidx = (size_t)(gk / G) * N + gn;
        const float cf = (float)codes[(size_t)gk * N + gn];
        w = __float2bfloat16_rn(cf * __bfloat162float(scale[sidx]));
        if (bias != nullptr)
          w = __float2bfloat16_rn(__bfloat162float(w) + __bfloat162float(bias[sidx]));
      }
      sb[nn * LDK + kk] = w;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const __nv_bfloat16* p = sa + (wm + i * 16 + g) * LDK + ks + t * 2;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDK);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * LDK + 8);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const __nv_bfloat16* p = sb + (wn + j * 8 + g) * LDK + ks + t * 2;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

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

template <int BM, int WM, int WN>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* codes,
                   const __nv_bfloat16* scale, const __nv_bfloat16* bias,
                   float* out, int M, int N, int K, int G, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul_kernel<BM, WM, WN><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
      x, codes, scale, bias, out, M, N, K, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ik_qmatmul(const void* x, const void* codes, const void* scale,
                          const void* bias, void* out, int M, int N, int K,
                          int G, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto c = static_cast<const int8_t*>(codes);
  auto sc = static_cast<const __nv_bfloat16*>(scale);
  auto bi = static_cast<const __nv_bfloat16*>(bias);
  auto o = static_cast<float*>(out);
  cudaError_t e = (M <= 16) ? launch<16, 16, 16>(xb, c, sc, bi, o, M, N, K, G, s)
                            : launch<64, 32, 32>(xb, c, sc, bi, o, M, N, K, G, s);
  return static_cast<int>(e);
}
