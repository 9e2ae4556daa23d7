// 4-bit packed dequant x matmul.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul4 (Pallas, _make_kernel4).
//
//   out = x @ W,  W[k, n] = bf16(bf16(value(idx[k, n])) * scale[k/G, n]) (+ bias[k/G, n] in bf16)
//
// x: bf16 (M, K) row-major; packed: uint8 (K/2, N), byte i of a column holds
// the 4-bit indices of K rows 2i (low nibble) and 2i + 1 (high nibble);
// value(idx) = lut[idx] with a 16-entry codebook, or idx - 8 without one;
// scale, bias: bf16 (K/G, N), G even; out: f32 (M, N). Any M, N and even K
// with K % G == 0. The dequant chain runs in bf16 with float sums, which is
// qmatmul4_ref's numerics contract.
//
// Bound on the H100: weight bytes (half a byte per weight plus 2/G for the
// scales) at small M, bf16 tensor-core operations at large M. Design: that
// of qmatmul.cu with the unpack in front. Each block dequantizes a 32-deep
// slice of its 64 columns into shared memory, K-contiguous per column, both
// nibbles of a byte into neighbouring K positions (one 32-bit store), so x
// is taken whole (the TPU kernel pre-splits x into even and odd columns to
// avoid a lane interleave); then bf16 mma.sync.m16n8k16 with float
// accumulators. The codebook sits in shared memory. No copy/compute overlap.
#include "common.cuh"

namespace {

constexpr int BN = 64, BK = 32, LDK = BK + 8;  // padded smem row (bf16)

struct Lut16 {
  float v[16];
};

template <int BM, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K, int G, int has_lut, Lut16 lut) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) uint16_t sa_raw[BM * LDK];
  __shared__ __align__(16) uint16_t sb_raw[BN * LDK];
  __shared__ float slut[16];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(sa_raw);   // [BM][LDK]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sb_raw);   // [BN][LDK], K-contiguous

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // value(idx) rounded to bf16 once, as the reference rounds the codebook
  if (tid < 16)
    slut[tid] = __bfloat162float(__float2bfloat16_rn(has_lut ? lut.v[tid] : (float)(tid - 8)));
  __syncthreads();

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
    for (int c = tid; c < BN * (BK / 2); c += NT) {
      const int k2 = c / BN, nn = c % BN;      // neighbouring threads: neighbouring columns
      const int gk = k0 + 2 * k2, gn = n0 + nn;
      uint32_t w2 = 0;
      if (gk < K && gn < N) {
        const uint32_t byte = packed[(size_t)(gk >> 1) * N + gn];
        const size_t sidx = (size_t)(gk / G) * N + gn;   // G is even: one group for both
        const float s = __bfloat162float(scale[sidx]);
        __nv_bfloat16 w0 = __float2bfloat16_rn(slut[byte & 0x0F] * s);
        __nv_bfloat16 w1 = __float2bfloat16_rn(slut[byte >> 4] * s);
        if (bias != nullptr) {
          const float bf = __bfloat162float(bias[sidx]);
          w0 = __float2bfloat16_rn(__bfloat162float(w0) + bf);
          w1 = __float2bfloat16_rn(__bfloat162float(w1) + bf);
        }
        w2 = (uint32_t)__bfloat16_as_ushort(w0) | ((uint32_t)__bfloat16_as_ushort(w1) << 16);
      }
      *reinterpret_cast<uint32_t*>(sb + nn * LDK + 2 * k2) = w2;
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
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* packed,
                   const __nv_bfloat16* scale, const __nv_bfloat16* bias, float* out,
                   int M, int N, int K, int G, int has_lut, const Lut16& lut,
                   cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul4_kernel<BM, WM, WN><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
      x, packed, scale, bias, out, M, N, K, G, has_lut, lut);
  return cudaGetLastError();
}

}  // namespace

// lut: 16 floats in host memory, or null for value(idx) = idx - 8.
extern "C" int ik_qmatmul4(const void* x, const void* packed, const void* scale,
                           const void* bias, void* out, int M, int N, int K, int G,
                           const float* lut, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto p = static_cast<const uint8_t*>(packed);
  auto sc = static_cast<const __nv_bfloat16*>(scale);
  auto bi = static_cast<const __nv_bfloat16*>(bias);
  auto o = static_cast<float*>(out);
  Lut16 l{};
  if (lut != nullptr)
    for (int i = 0; i < 16; ++i) l.v[i] = lut[i];
  const int has_lut = lut != nullptr;
  cudaError_t e = (M <= 16) ? launch<16, 16, 16>(xb, p, sc, bi, o, M, N, K, G, has_lut, l, s)
                            : launch<64, 32, 32>(xb, p, sc, bi, o, M, N, K, G, has_lut, l, s);
  return static_cast<int>(e);
}
