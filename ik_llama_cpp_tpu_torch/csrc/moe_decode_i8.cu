// MoE decode over int8 supergroup-256 experts: routed gate/up matvecs with
// the activation (kernel 7), and the routed down matvecs summed over each
// token's pairs (kernel 8).
//
// Replaces ik_llama_cpp_tpu/ops/moe_decode.py:moe_decode_gate_up_i8 and
// :moe_decode_down_i8 (the Pallas kernels of the two-kernel decode chain).
//
//   h[p, f]   = act(sum_g sx[g, p] gsw[e, g, f] sum_{k in g} xq[p, k] gate[e, f, k], ... up ...)
//   out[t, n] = sum_{j < top_k} sum_g hs[g, p] dsw[e, g, n] sum_{k in g} hq[p, k] down[e, n, k]
//
// with e = ids[p], p = t * top_k + j. Codes are stored (G, N, K): each
// output column of an expert is one K-contiguous row. Activation scales are
// read through two strides (the JAX layout is (K/256, P)).
//
// Bound on the H100: the routed experts' code bytes (one byte a weight plus
// 4/256 of scales), read once per pair; the arithmetic is a few dp4a a
// byte. Design: one warp per output column, each lane streams 16-byte
// chunks of the column's row (up to 8 in flight a lane) into __dp4a; the
// 16 lanes of a half-warp cover one 256-deep supergroup, whose exact int32
// sum a shuffle reduction forms before the float correction is added in
// supergroup order (the order of the plain version). Each block reads its
// own ids[p]: the GPU has no scalar prefetch. The pair's activation row sits
// in shared memory. Tiles of 16 columns keep hundreds of blocks in flight
// at batch 1. No atomics: the down sum over a token's pairs is one thread's
// sequential loop, so it is deterministic.
#include "moe_matvec_i8.cuh"

namespace {

__global__ void __launch_bounds__(WARPS * 32)
gate_up_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xst,
               int s_sg, int s_p, const int* __restrict__ ids,
               const int8_t* __restrict__ gate, const float* __restrict__ gsw,
               const int8_t* __restrict__ up, const float* __restrict__ usw,
               const float* __restrict__ gate_b, const float* __restrict__ up_b,
               __nv_bfloat16* __restrict__ h, int K, int F, int act, float limit) {
  extern __shared__ __align__(16) int8_t smem[];
  const int p = blockIdx.y, nsg = K / MOE_SG, nch = K / 16;
  float* sx = reinterpret_cast<float*>(smem + K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = ids[p];
  for (int c = tid; c < nch; c += blockDim.x)
    reinterpret_cast<int4*>(smem)[c] = ldg16(xq + (size_t)p * K + 16 * c);
  for (int g = tid; g < nsg; g += blockDim.x) sx[g] = xst[(size_t)g * s_sg + (size_t)p * s_p];
  __syncthreads();

  for (int j = warp; j < COLS; j += WARPS) {
    const int f = blockIdx.x * COLS + j;
    if (f >= F) break;
    const size_t row = (size_t)e * F + f;
    const float* gs = gsw + (size_t)e * nsg * F + f;
    const float* us = usw + (size_t)e * nsg * F + f;
    float g = row_dot(smem, gate + row * K, sx, [&](int s) { return gs[(size_t)s * F]; },
                      nch, nsg, 0.0f, lane);
    float u = row_dot(smem, up + row * K, sx, [&](int s) { return us[(size_t)s * F]; },
                      nch, nsg, 0.0f, lane);
    if (gate_b) g = fadd(g, gate_b[row]);
    if (up_b) u = fadd(u, up_b[row]);
    if (lane == 0) h[(size_t)p * F + f] = __float2bfloat16_rn(moe_act(g, u, act, limit));
  }
}

__global__ void __launch_bounds__(WARPS * 32)
down_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hst,
            int s_sg, int s_p, const int* __restrict__ ids,
            const int8_t* __restrict__ down, const float* __restrict__ dsw,
            float* __restrict__ out, int top_k, int F, int E) {
  extern __shared__ __align__(16) int8_t smem[];   // [top_k][F] rows, then [top_k][nsg] scales
  const int t = blockIdx.y, nsg = F / MOE_SG, nch = F / 16;
  float* shs = reinterpret_cast<float*>(smem + (size_t)top_k * F);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = t * top_k;
  for (int c = tid; c < top_k * nch; c += blockDim.x)
    reinterpret_cast<int4*>(smem)[c] = ldg16(hq + (size_t)p0 * F + 16 * c);
  for (int i = tid; i < top_k * nsg; i += blockDim.x) {
    const int j = i / nsg, g = i % nsg;
    shs[i] = hst[(size_t)g * s_sg + (size_t)(p0 + j) * s_p];
  }
  __syncthreads();

  for (int c = warp; c < COLS; c += WARPS) {
    const int n = blockIdx.x * COLS + c;
    if (n >= E) break;
    float acc = 0.0f;
    for (int j = 0; j < top_k; ++j) {
      const int e = ids[p0 + j];
      const float* ds = dsw + (size_t)e * nsg * E + n;
      acc = row_dot(smem + (size_t)j * F, down + ((size_t)e * E + n) * F, shs + j * nsg,
                    [&](int s) { return ds[(size_t)s * E]; }, nch, nsg, acc, lane);
    }
    if (lane == 0) out[(size_t)t * E + n] = acc;
  }
}

}  // namespace

extern "C" int ik_moe_decode_gate_up_i8(const void* xq, const void* xst, int s_sg, int s_p,
                                        const void* ids, const void* gate, const void* gsw,
                                        const void* up, const void* usw, const void* gate_b,
                                        const void* up_b, void* h, int P, int K, int F,
                                        int act, float limit, void* stream) {
  const int smem = K + (K / MOE_SG) * 4;
  static bool smem_set = false;
  cudaError_t e = set_smem(gate_up_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((F + COLS - 1) / COLS, P);
  gate_up_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xst), s_sg, s_p,
      static_cast<const int*>(ids), static_cast<const int8_t*>(gate),
      static_cast<const float*>(gsw), static_cast<const int8_t*>(up),
      static_cast<const float*>(usw), static_cast<const float*>(gate_b),
      static_cast<const float*>(up_b), static_cast<__nv_bfloat16*>(h), K, F, act, limit);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ik_moe_decode_down_i8(const void* hq, const void* hst, int s_sg, int s_p,
                                     const void* ids, const void* down, const void* dsw,
                                     void* out, int T, int top_k, int F, int E, void* stream) {
  const int smem = top_k * F + top_k * (F / MOE_SG) * 4;
  static bool smem_set = false;
  cudaError_t e = set_smem(down_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((E + COLS - 1) / COLS, T);
  down_kernel<<<grid, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hst), s_sg, s_p,
      static_cast<const int*>(ids), static_cast<const int8_t*>(down),
      static_cast<const float*>(dsw), static_cast<float*>(out), top_k, F, E);
  return static_cast<int>(cudaGetLastError());
}
