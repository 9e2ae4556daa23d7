// Planar dequant x matmul, and its form over codes packed two to a 16-bit
// lane.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul (Pallas, _make_kernel)
// and ik_llama_cpp_tpu/tools/perf_dequant.py:qmatmul_pair (Pallas,
// _pair_kernel: the same arithmetic behind another loader).
//
//   out = x @ W,   W[k, n] = bf16(bf16(codes[k, n]) * scale[k/G, n]) (+ bias[k/G, n] in bf16)
//
// x: bf16 (M, K) row-major; codes: int8 (K, N); scale, bias: bf16 or float32
// (K/G, N), float32 rounded to bf16 here; out: f32 (M, N). Any M, N, K with
// K % G == 0. The dequant chain runs in bf16 with float sums, which is
// qmatmul_ref's numerics contract. In the pair form codes are int16
// (K, N/2): the low byte of packed column j is the code of column j, the
// high byte that of column j + N/2; a block's 64 columns are 32 packed
// columns, both halves.
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

IK_DEV float as_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
IK_DEV float as_bf16(__nv_bfloat16 v) { return __bfloat162float(v); }

// The output column of a block's local column. Pair form: local columns
// 0-31 are the low bytes of packed columns n0/2 .. n0/2 + 31, 32-63 the
// high bytes (N/2 further on); -1 past the edge.
template <bool PAIR>
IK_DEV int out_col(int n0, int local, int N) {
  if (!PAIR) return n0 + local < N ? n0 + local : -1;
  const int j = (n0 >> 1) + (local & 31);
  return j < N / 2 ? (local >> 5) * (N / 2) + j : -1;
}

template <int BM, int WM, int WN, typename S, bool PAIR>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ codes_,
               const S* __restrict__ scale, const S* __restrict__ bias,
               float* __restrict__ out, int M, int N, int K, int G) {
  const int8_t* codes = static_cast<const int8_t*>(codes_);
  const int16_t* codes16 = static_cast<const int16_t*>(codes_);
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
      const int gk = k0 + kk, gn = out_col<PAIR>(n0, nn, N);
      __nv_bfloat16 w = zero;
      if (gk < K && gn >= 0) {
        const size_t sidx = (size_t)(gk / G) * N + gn;
        float cf;
        if (PAIR) {
          const int v = codes16[(size_t)gk * (N / 2) + (gn % (N / 2))];
          cf = (float)static_cast<int8_t>(nn < 32 ? v : v >> 8);
        } else {
          cf = (float)codes[(size_t)gk * N + gn];
        }
        w = __float2bfloat16_rn(cf * as_bf16(scale[sidx]));
        if (bias != nullptr)
          w = __float2bfloat16_rn(__bfloat162float(w) + as_bf16(bias[sidx]));
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
      const int c0 = out_col<PAIR>(n0, wn + j * 8 + t * 2, N);
      const int c1 = out_col<PAIR>(n0, wn + j * 8 + t * 2 + 1, N);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + i * 16 + g + h * 8;
        if (r >= M) continue;
        if (c0 >= 0) out[(size_t)r * N + c0] = acc[i][j][2 * h];
        if (c1 >= 0) out[(size_t)r * N + c1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <int BM, int WM, int WN, typename S, bool PAIR>
cudaError_t launch(const void* x, const void* codes, const void* scale, const void* bias,
                   void* out, int M, int N, int K, int G, cudaStream_t s) {
  const int cols = PAIR ? N / 2 : N, bn = PAIR ? BN / 2 : BN;
  dim3 grid((cols + bn - 1) / bn, (M + BM - 1) / BM);
  qmatmul_kernel<BM, WM, WN, S, PAIR><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), codes, static_cast<const S*>(scale),
      static_cast<const S*>(bias), static_cast<float*>(out), M, N, K, G);
  return cudaGetLastError();
}

template <typename S, bool PAIR>
cudaError_t by_rows(const void* x, const void* codes, const void* scale, const void* bias,
                    void* out, int M, int N, int K, int G, cudaStream_t s) {
  return (M <= 16) ? launch<16, 16, 16, S, PAIR>(x, codes, scale, bias, out, M, N, K, G, s)
                   : launch<64, 32, 32, S, PAIR>(x, codes, scale, bias, out, M, N, K, G, s);
}

}  // namespace

// scale_bf16: scale (and bias) are bf16, else float32.
extern "C" int ik_qmatmul(const void* x, const void* codes, const void* scale,
                          const void* bias, int scale_bf16, void* out, int M, int N, int K,
                          int G, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16 ? by_rows<__nv_bfloat16, false>(x, codes, scale, bias, out, M, N, K, G, s)
                 : by_rows<float, false>(x, codes, scale, bias, out, M, N, K, G, s));
}

// codes16: int16 (K, N/2), two int8 codes a lane; N even; no bias.
extern "C" int ik_qmatmul_pair(const void* x, const void* codes16, const void* scale,
                               int scale_bf16, void* out, int M, int N, int K, int G,
                               void* stream) {
  if (N % 2) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16 ? by_rows<__nv_bfloat16, true>(x, codes16, scale, nullptr, out, M, N, K, G, s)
                 : by_rows<float, true>(x, codes16, scale, nullptr, out, M, N, K, G, s));
}
