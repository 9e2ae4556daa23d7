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
// byte. Each block reads its own ids[p]: the GPU has no scalar prefetch. No
// atomics: every sum has one fixed order, so the kernels are deterministic.
//
// Kernel 7: one warp per output column, each lane streams 16-byte chunks of
// the column's row (up to 8 in flight a lane) into __dp4a; the 16 lanes of
// a half-warp cover one 256-deep supergroup, whose exact int32 sum a
// shuffle reduction forms before the float correction is added in
// supergroup order (the order of the plain version). The pair's activation
// row sits in shared memory; tiles of 16 columns.
//
// Kernel 8: a block puts all of a token's pairs in flight at once. Its
// top_k * cols rows (launch plan ops/moe_decode.py:down_plan: 8 columns and
// 4 lanes a row at top_k 8, F 768) are loaded 12 chunks a lane, unconditional
// loads that stay in flight together, some 48 KB a block, so that ~2 blocks
// an SM keep more than the ~25 KB an SM in flight that the card's memory rate
// needs; the int32 supergroup sums
// go to shared memory and one thread a column adds their corrections pair
// by pair, supergroup by supergroup, the order of the plain version.
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

// Kernel 8. A block takes token t's top_k pairs over `cols` adjacent
// columns from n0: top_k * cols rows of F codes (pair j, column c; an
// expert's adjacent columns are adjacent rows, so a pair's rows are one
// contiguous span), `lanes` lanes a row. Lane l loads the row's 16-byte
// chunks l, l + lanes, ... in batches of DOWN_BATCH, each load unconditional
// (clamped to the row) so that the compiler keeps them all in flight and
// waits for them in order; it holds 16 / lanes
// chunks of each supergroup, whose exact int32 sum a shuffle over the row's
// lanes forms. The sums go to shared memory, and one thread a column adds
// the float corrections pair by pair, supergroup by supergroup: the order of
// the plain version and of the Pallas kernel. Shared memory: the token's
// rows [top_k][F] int8, their scales [top_k][nsg], the weight scales and
// the sums [top_k][nsg][cols] each, the expert ids [top_k].
__global__ void __launch_bounds__(DOWN_THREADS)
down_i8_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hst,
               int s_sg, int s_p, const int* __restrict__ ids,
               const int8_t* __restrict__ down, const float* __restrict__ dsw,
               float* __restrict__ out, int top_k, int F, int E, int cols, int lanes) {
  extern __shared__ __align__(16) int8_t smem[];
  const int t = blockIdx.y, n0 = blockIdx.x * cols, nsg = F / MOE_SG, nch = F / 16;
  const int tid = threadIdx.x, p0 = t * top_k, nws = top_k * nsg * cols;
  float* shs = reinterpret_cast<float*>(smem + (size_t)top_k * F);
  float* sws = shs + top_k * nsg;
  int* part = reinterpret_cast<int*>(sws + nws);
  int* eid = part + nws;
  stage16(smem, hq + (size_t)p0 * F, top_k * nch, tid);
  for (int i = tid; i < top_k * nsg; i += DOWN_THREADS)
    shs[i] = hst[(size_t)(i % nsg) * s_sg + (size_t)(p0 + i / nsg) * s_p];
  for (int j = tid; j < top_k; j += DOWN_THREADS) eid[j] = ids[p0 + j];
  __syncthreads();

  // sws[(j * nsg + g) * cols + c] = dsw[e_j, g, n0 + c]: one load a thread
  // issued here, stored after the sums (adjacent columns, one sector)
  auto ws = [&](int i) {
    const int c = i % cols, jg = i / cols;
    return __ldg(dsw + ((size_t)eid[jg / nsg] * nsg + jg % nsg) * E + min(n0 + c, E - 1));
  };
  const float ws0 = tid < nws ? ws(tid) : 0.0f;

  const int rows = top_k * cols, lr = tid % lanes, per = 16 / lanes, cpl = nch / lanes;
  for (int r = tid / lanes; r - tid / lanes < rows; r += DOWN_THREADS / lanes) {
    const bool live = r < rows;
    const int j = (live ? r : rows - 1) / cols, c = (live ? r : rows - 1) % cols;
    const int8_t* row = down + ((size_t)eid[j] * E + min(n0 + c, E - 1)) * F + 16 * lr;
    const int4* x = reinterpret_cast<const int4*>(smem + (size_t)j * F) + lr;
    int s = 0;
    for (int b0 = 0; b0 < cpl; b0 += DOWN_BATCH) {
      int4 w[DOWN_BATCH];
#pragma unroll
      for (int i = 0; i < DOWN_BATCH; ++i)     // clamped: every load unconditional, in order
        w[i] = ldg16(row + (size_t)16 * lanes * min(b0 + i, cpl - 1));
#pragma unroll
      for (int i = 0; i < DOWN_BATCH; ++i) {
        const int q = b0 + i;                       // warp-uniform
        if (q >= cpl) break;
        s += dot16(x[lanes * q], w[i]);
        if (((q + 1) & (per - 1)) == 0) {           // the lane's last chunk of a supergroup
          for (int o = lanes / 2; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
          if (live && lr == 0) part[(j * nsg + q / per) * cols + c] = s;
          s = 0;
        }
      }
    }
  }
  if (tid < nws) sws[tid] = ws0;
  for (int i = tid + DOWN_THREADS; i < nws; i += DOWN_THREADS) sws[i] = ws(i);
  __syncthreads();

  for (int c = tid; c < cols && n0 + c < E; c += DOWN_THREADS) {
    float acc = 0.0f;
    for (int j = 0; j < top_k; ++j)
      for (int g = 0; g < nsg; ++g) {
        const int i = (j * nsg + g) * cols + c;
        acc = sg_corr(acc, part[i], shs[j * nsg + g], sws[i]);
      }
    out[(size_t)t * E + n0 + c] = acc;
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

// cols and lanes: the launch plan (ops/moe_decode.py:down_plan); lanes a
// power of two that divides 16. The block's shared memory is sized here: a
// shape whose rows do not fit is refused.
extern "C" int ik_moe_decode_down_i8(const void* hq, const void* hst, int s_sg, int s_p,
                                     const void* ids, const void* down, const void* dsw,
                                     void* out, int T, int top_k, int F, int E, int cols,
                                     int lanes, void* stream) {
  const int nsg = F / MOE_SG;
  const int smem = top_k * F + 4 * top_k * (nsg + 2 * nsg * cols + 1);
  if (F % MOE_SG || cols < 1 || lanes < 1 || 16 % lanes || lanes & (lanes - 1) ||
      smem > MOE_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  cudaError_t e = set_smem(down_i8_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((E + cols - 1) / cols, T);
  down_i8_kernel<<<grid, DOWN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hst), s_sg, s_p,
      static_cast<const int*>(ids), static_cast<const int8_t*>(down),
      static_cast<const float*>(dsw), static_cast<float*>(out), top_k, F, E, cols, lanes);
  return static_cast<int>(cudaGetLastError());
}
