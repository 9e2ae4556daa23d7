// MoE decode over planar int8 experts with group scales: routed gate/up
// matvecs with the activation (kernel 12), and the routed down matvecs
// summed over each token's pairs (kernel 13).
//
// Replaces ik_llama_cpp_tpu/ops/moe_decode.py:moe_decode_gate_up and
// :moe_decode_down (the Pallas kernels of the bf16-dequant decode chain,
// which a model takes whenever its down projection is not re-coded per
// supergroup of 256, e.g. an expert width that 256 does not divide).
//
//   w[e, k, n] = bf16(bf16(codes[e, k, n]) * bf16(scale[e, k / group, n]))
//   h[p, f]    = act(sum_k x[p, k] wg[e, k, f] (+ gate_b), sum_k x[p, k] wu[e, k, f] (+ up_b))
//   out[t, n]  = sum_{j < top_k} sum_k hw[p, k] wd[e, k, n],  e = ids[p], p = t * top_k + j
//
// x, hw and h are bf16, the sums float32. Codes are stored (G, N, K): each
// output column of an expert is one K-contiguous row; scales are
// (G, K / group, N), float32 or bf16 (a template parameter: float32 scales
// are rounded to bf16 here, the stored tensor is not touched). group is any
// multiple of 16 that divides K; K is any multiple of 16 (no 256-deep step).
//
// Bound on the H100: the routed experts' code bytes (one byte a weight plus
// the scales), read once per pair. Design: kernels 7 and 8's layout. One
// warp per output column; a lane takes 16 codes with one 16-byte load (they
// share one scale), dequantizes each to bf16 and multiplies it with the
// activation row held in shared memory as bf16; a shuffle reduction sums the
// lanes. Each block reads its own ids[p]. The down sum adds a token's pairs
// in pair order in one thread's loop: no atomics, deterministic.
#include "moe_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int COLS = 16;         // output columns per block
constexpr unsigned FULL = 0xffffffffu;

// acc + four products x * bf16(code * s); x01 / x23 hold two bf16 each, the
// lower K position in the lower half. A bf16 x bf16 product is exact in
// float32, so the fused multiply-add rounds once, as a sum of products does.
IK_DEV float mac4(float acc, int w, float s, uint32_t x01, uint32_t x23) {
  acc = fmaf(__uint_as_float(x01 << 16), bf16_round(static_cast<float>(static_cast<int8_t>(w)) * s), acc);
  acc = fmaf(__uint_as_float(x01 & 0xffff0000u),
             bf16_round(static_cast<float>(static_cast<int8_t>(w >> 8)) * s), acc);
  acc = fmaf(__uint_as_float(x23 << 16),
             bf16_round(static_cast<float>(static_cast<int8_t>(w >> 16)) * s), acc);
  return fmaf(__uint_as_float(x23 & 0xffff0000u),
              bf16_round(static_cast<float>(static_cast<int8_t>(w >> 24)) * s), acc);
}

// sum_k x[k] * w[k] over one column: x is the bf16 activation row in shared
// memory, row the column's K codes, sc its first scale (sstride elements
// between groups), nch = K / 16. Every lane returns the whole sum.
template <typename S>
IK_DEV float col_dot(const __nv_bfloat16* x, const int8_t* row, const S* sc, size_t sstride,
                     int nch, int group, int lane) {
  float acc = 0.0f;
#pragma unroll 4
  for (int c = lane; c < nch; c += 32) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(row + 16 * c));
    const float s = load_scale(sc + (size_t)((16 * c) / group) * sstride);
    const uint4 xa = reinterpret_cast<const uint4*>(x)[2 * c];
    const uint4 xb = reinterpret_cast<const uint4*>(x)[2 * c + 1];
    acc = mac4(acc, w.x, s, xa.x, xa.y);
    acc = mac4(acc, w.y, s, xa.z, xa.w);
    acc = mac4(acc, w.z, s, xb.x, xb.y);
    acc = mac4(acc, w.w, s, xb.z, xb.w);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
gate_up_kernel(const __nv_bfloat16* __restrict__ xp, const int* __restrict__ ids,
               const int8_t* __restrict__ gate, const S* __restrict__ gs,
               const int8_t* __restrict__ up, const S* __restrict__ us,
               const float* __restrict__ gate_b, const float* __restrict__ up_b,
               __nv_bfloat16* __restrict__ h, int K, int F, int group, int act, float limit) {
  extern __shared__ __align__(16) uint8_t smem[];     // the pair's row: K bf16
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(smem);
  const int p = blockIdx.y, nch = K / 16, ngrp = K / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = ids[p];
  for (int c = tid; c < K / 8; c += blockDim.x)
    reinterpret_cast<uint4*>(smem)[c] = reinterpret_cast<const uint4*>(xp + (size_t)p * K)[c];
  __syncthreads();

  for (int j = warp; j < COLS; j += WARPS) {
    const int f = blockIdx.x * COLS + j;
    if (f >= F) break;
    const size_t row = (size_t)e * F + f;
    const size_t s0 = (size_t)e * ngrp * F + f;
    float g = col_dot(x, gate + row * K, gs + s0, F, nch, group, lane);
    float u = col_dot(x, up + row * K, us + s0, F, nch, group, lane);
    if (gate_b) g = fadd(g, gate_b[row]);
    if (up_b) u = fadd(u, up_b[row]);
    if (lane == 0) h[(size_t)p * F + f] = __float2bfloat16_rn(moe_act(g, u, act, limit));
  }
}

template <typename S>
__global__ void __launch_bounds__(WARPS * 32)
down_kernel(const __nv_bfloat16* __restrict__ hw, const int* __restrict__ ids,
            const int8_t* __restrict__ down, const S* __restrict__ ds,
            float* __restrict__ out, int top_k, int F, int E, int group) {
  extern __shared__ __align__(16) uint8_t smem[];     // the token's rows: [top_k][F] bf16
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(smem);
  const int t = blockIdx.y, nch = F / 16, ngrp = F / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = t * top_k;
  for (int c = tid; c < top_k * (F / 8); c += blockDim.x)
    reinterpret_cast<uint4*>(smem)[c] = reinterpret_cast<const uint4*>(hw + (size_t)p0 * F)[c];
  __syncthreads();

  for (int c = warp; c < COLS; c += WARPS) {
    const int n = blockIdx.x * COLS + c;
    if (n >= E) break;
    float acc = 0.0f;
    for (int j = 0; j < top_k; ++j) {
      const int e = ids[p0 + j];
      acc = fadd(acc, col_dot(x + (size_t)j * F, down + ((size_t)e * E + n) * F,
                              ds + (size_t)e * ngrp * E + n, E, nch, group, lane));
    }
    if (lane == 0) out[(size_t)t * E + n] = acc;
  }
}

template <typename S>
cudaError_t launch_gate_up(const void* xp, const void* ids, const void* gate, const void* gs,
                           const void* up, const void* us, const void* gate_b,
                           const void* up_b, void* h, int P, int K, int F, int group, int act,
                           float limit, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e = set_smem(gate_up_kernel<S>, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((F + COLS - 1) / COLS, P);
  gate_up_kernel<S><<<grid, WARPS * 32, K * 2, stream>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const int*>(ids),
      static_cast<const int8_t*>(gate), static_cast<const S*>(gs),
      static_cast<const int8_t*>(up), static_cast<const S*>(us),
      static_cast<const float*>(gate_b), static_cast<const float*>(up_b),
      static_cast<__nv_bfloat16*>(h), K, F, group, act, limit);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_down(const void* hw, const void* ids, const void* down, const void* ds,
                        void* out, int T, int top_k, int F, int E, int group,
                        cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e = set_smem(down_kernel<S>, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((E + COLS - 1) / COLS, T);
  down_kernel<S><<<grid, WARPS * 32, top_k * F * 2, stream>>>(
      static_cast<const __nv_bfloat16*>(hw), static_cast<const int*>(ids),
      static_cast<const int8_t*>(down), static_cast<const S*>(ds),
      static_cast<float*>(out), top_k, F, E, group);
  return cudaGetLastError();
}

}  // namespace

// scale_bf16: the scales are bf16 (else float32). K % 16 == 0, group % 16 == 0,
// K % group == 0, and K * 2 bytes of shared memory must fit a block.
extern "C" int ik_moe_decode_gate_up(const void* xp, const void* ids, const void* gate,
                                     const void* gs, const void* up, const void* us,
                                     int scale_bf16, const void* gate_b, const void* up_b,
                                     void* h, int P, int K, int F, int group, int act,
                                     float limit, void* stream) {
  if (K % 16 || group % 16 || K % group || K * 2 > MOE_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16 ? launch_gate_up<__nv_bfloat16>(xp, ids, gate, gs, up, us, gate_b, up_b, h, P,
                                                 K, F, group, act, limit, s)
                 : launch_gate_up<float>(xp, ids, gate, gs, up, us, gate_b, up_b, h, P, K, F,
                                         group, act, limit, s));
}

extern "C" int ik_moe_decode_down(const void* hw, const void* ids, const void* down,
                                  const void* ds, int scale_bf16, void* out, int T, int top_k,
                                  int F, int E, int group, void* stream) {
  if (F % 16 || group % 16 || F % group || top_k * F * 2 > MOE_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16 ? launch_down<__nv_bfloat16>(hw, ids, down, ds, out, T, top_k, F, E, group, s)
                 : launch_down<float>(hw, ids, down, ds, out, T, top_k, F, E, group, s));
}
