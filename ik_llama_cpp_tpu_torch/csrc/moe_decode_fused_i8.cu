// The whole routed-expert FFN of a decode step over int8 supergroup-256
// experts in one launch (kernel 11).
//
// Replaces ik_llama_cpp_tpu/ops/moe_decode.py:moe_decode_fused_i8 (the Pallas
// single-kernel decode, opted into with IK_MOE_FUSED_TG=1).
//
//   g, u      = the int8 gate / up dots of pair p with their supergroup corrections (+ biases)
//   h[p, :]   = bf16(float(bf16(act(g, u))) * wts[p])
//   hq, hs    = h requantized per (pair, supergroup): hs = amax / 127, hq = clip(rint(h * (1 / hs)))
//   out[t, n] = sum_{j < top_k} sum_g hs[p, g] dsw[e, g, n] sum_{k in g} hq[p, k] down[e, n, k]
//
// with e = ids[p], p = t * top_k + j: kernels 7 and 8 with the routing
// weight and the requantization of h between them, and the requantization
// multiplying by the reciprocal as the Pallas kernel does.
//
// Bound on the H100: the routed experts' code bytes, as for 7 + 8. The TPU
// kernel walks the pairs one after another on one core and carries the
// token rows in scratch memory; here the launch is cooperative and has two
// phases with a grid-wide barrier between them. Phase 1 is kernel 7's grid
// (pair, 16-column tile of FF) flattened over the resident blocks; it
// writes h, bf16, to a scratch the wrapper allocates (P x FF: it stays in
// L2). Phase 2 is kernel 8's grid (token, 16-column tile of E): each block
// requantizes its token's rows into shared memory (a few KB of
// arithmetic, repeated per tile rather than shared through memory) and adds
// the pairs in pair order in one thread's loop. No float atomics anywhere,
// so the result is the same from run to run, and it equals the plain
// version's order of sums.
#include <cooperative_groups.h>

#include <atomic>

#include "moe_matvec_i8.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(WARPS * 32)
fused_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xst, int s_sg, int s_p,
             const int* __restrict__ ids, const float* __restrict__ wts,
             const int8_t* __restrict__ gate, const float* __restrict__ gsw,
             const int8_t* __restrict__ up, const float* __restrict__ usw,
             const int8_t* __restrict__ down, const float* __restrict__ dsw,
             const float* __restrict__ gate_b, const float* __restrict__ up_b,
             __nv_bfloat16* hbuf, float* __restrict__ out, int P, int top_k, int K, int F,
             int E, int act, float limit) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // phase 1: h = bf16(bf16(act(gate, up)) * weight), per (pair, FF tile)
  {
    const int nsg = K / MOE_SG, nch = K / 16;
    float* sx = reinterpret_cast<float*>(smem + K);
    const int n_ft = (F + COLS - 1) / COLS;
    for (int item = blockIdx.x; item < P * n_ft; item += gridDim.x) {
      const int p = item / n_ft, f0 = (item % n_ft) * COLS;
      const int e = ids[p];
      __syncthreads();                       // the previous item's row is done with
      for (int c = tid; c < nch; c += blockDim.x)
        reinterpret_cast<int4*>(smem)[c] = ldg16(xq + (size_t)p * K + 16 * c);
      for (int g = tid; g < nsg; g += blockDim.x)
        sx[g] = xst[(size_t)g * s_sg + (size_t)p * s_p];
      __syncthreads();
      for (int j = warp; j < COLS; j += WARPS) {
        const int f = f0 + j;
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
        if (lane == 0) {
          const float hb = __bfloat162float(__float2bfloat16_rn(moe_act(g, u, act, limit)));
          hbuf[(size_t)p * F + f] = __float2bfloat16_rn(fmul(hb, wts[p]));
        }
      }
    }
  }

  cg::this_grid().sync();                    // every h is written and visible

  // phase 2: requantize the token's rows, then the down sum in pair order
  {
    const int nsg = F / MOE_SG, nch = F / 16;
    float* shs = reinterpret_cast<float*>(smem + (size_t)top_k * F);   // [top_k][nsg]
    const int n_et = (E + COLS - 1) / COLS, T = P / top_k;
    for (int item = blockIdx.x; item < T * n_et; item += gridDim.x) {
      const int t = item / n_et, n0 = (item % n_et) * COLS;
      const int p0 = t * top_k;
      __syncthreads();
      for (int unit = warp; unit < top_k * nsg; unit += WARPS) {
        const int j = unit / nsg, s = unit % nsg;
        const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
            hbuf + (size_t)(p0 + j) * F + s * MOE_SG + lane * 8));
        const uint32_t wds[4] = {raw.x, raw.y, raw.z, raw.w};
        float v[8], amax = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[2 * q] = __uint_as_float(wds[q] << 16);
          v[2 * q + 1] = __uint_as_float(wds[q] & 0xffff0000u);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) amax = fmaxf(amax, fabsf(v[q]));
#pragma unroll
        for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
        const float sc = __fdiv_rn(amax, 127.0f);
        const float inv = sc > 0.0f ? __fdiv_rn(1.0f, sc) : 0.0f;
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = max(-127, min(127, __float2int_rn(fmul(v[q], inv))));
          packed[q >> 2] |= static_cast<uint32_t>(c & 0xff) << (8 * (q & 3));
        }
        *reinterpret_cast<uint2*>(smem + (size_t)j * F + s * MOE_SG + lane * 8) =
            make_uint2(packed[0], packed[1]);
        if (lane == 0) shs[j * nsg + s] = sc;
      }
      __syncthreads();
      for (int c = warp; c < COLS; c += WARPS) {
        const int n = n0 + c;
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
  }
}

}  // namespace

// Shared memory of a block: the larger of phase 1's activation row and
// phase 2's requantized rows, each with its supergroup scales.
static int fused_smem(int top_k, int K, int F) {
  const int a = K + (K / MOE_SG) * 4, b = top_k * F + top_k * (F / MOE_SG) * 4;
  return a > b ? a : b;
}

// A cooperative grid must be resident at once: the blocks of this kernel
// that fit the card at `smem` bytes each. Asked at every launch, the
// occupancy query cost the host as much time as the launches this kernel
// saves in a host-bound decode step, so the last answer is kept (one word,
// smem in the upper half, so that threads cannot pair one call's size with
// another's answer).
static cudaError_t resident_blocks(int smem, int& blocks) {
  static std::atomic<uint64_t> last{0};
  const uint64_t seen = last.load();
  if (seen != 0 && static_cast<int>(seen >> 32) == smem) {
    blocks = static_cast<int>(seen & 0xffffffffu);
    return cudaSuccess;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel, WARPS * 32,
                                                         smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  blocks = sms * per_sm;
  last.store((static_cast<uint64_t>(smem) << 32) | static_cast<uint32_t>(blocks));
  return cudaSuccess;
}

// K % 256 == 0, F % 256 == 0, P % top_k == 0; hbuf is a bf16 (P, F) scratch.
extern "C" int ik_moe_decode_fused_i8(const void* xq, const void* xst, int s_sg, int s_p,
                                      const void* ids, const void* wts, const void* gate,
                                      const void* gsw, const void* up, const void* usw,
                                      const void* down, const void* dsw, const void* gate_b,
                                      const void* up_b, void* hbuf, void* out, int P,
                                      int top_k, int K, int F, int E, int act, float limit,
                                      void* stream) {
  const int smem = fused_smem(top_k, K, F);
  if (K % MOE_SG || F % MOE_SG || top_k < 1 || P % top_k || smem > MOE_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  cudaError_t e = set_smem(fused_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = 0;
  if ((e = resident_blocks(smem, resident)) != cudaSuccess) return static_cast<int>(e);
  const int items1 = P * ((F + COLS - 1) / COLS), items2 = (P / top_k) * ((E + COLS - 1) / COLS);
  int blocks = items1 > items2 ? items1 : items2;
  if (blocks > resident) blocks = resident;
  auto xq_ = static_cast<const int8_t*>(xq);
  auto xst_ = static_cast<const float*>(xst);
  auto ids_ = static_cast<const int*>(ids);
  auto wts_ = static_cast<const float*>(wts);
  auto gate_ = static_cast<const int8_t*>(gate);
  auto gsw_ = static_cast<const float*>(gsw);
  auto up_ = static_cast<const int8_t*>(up);
  auto usw_ = static_cast<const float*>(usw);
  auto down_ = static_cast<const int8_t*>(down);
  auto dsw_ = static_cast<const float*>(dsw);
  auto gb_ = static_cast<const float*>(gate_b);
  auto ub_ = static_cast<const float*>(up_b);
  auto hbuf_ = static_cast<__nv_bfloat16*>(hbuf);
  auto out_ = static_cast<float*>(out);
  void* args[] = {&xq_, &xst_, &s_sg, &s_p, &ids_, &wts_, &gate_, &gsw_, &up_, &usw_, &down_,
                  &dsw_, &gb_, &ub_, &hbuf_, &out_, &P, &top_k, &K, &F, &E, &act, &limit};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_kernel), dim3(blocks),
                                  dim3(WARPS * 32), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
