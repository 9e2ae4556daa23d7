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
// Kernel 7 (gate_up_i8_kernel) on the plan of kernels 8 and 12: a block
// takes one pair over `cols` adjacent FF columns and puts all 2 * cols gate
// and up rows in flight at once (launch plan
// ops/moe_decode.py:gate_up_i8_plan: 16 columns and 8 lanes a row at K
// 2048), each lane streaming its 16-byte chunks through a ring of 4 loads,
// every load unconditional (clamped to the row); the pair's xq row and its
// scales sit in shared memory; each supergroup's exact int32 sum is formed
// by a shuffle over the row's lanes, and one thread a column adds the float
// corrections in supergroup order, then the bias, then the activation. The
// integer sums do not depend on the lane split, so h keeps the bits of the
// first port's one-warp-a-column kernel and of the plain version up to the
// activation's expf.
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

constexpr int GU_THREADS = 256;  // threads of a kernel-7 block (8 warps)
constexpr int GU_RING = 4;       // 16-byte chunks a lane of kernel 7 keeps in flight

// Kernel 7. A block takes pair p over `cols` adjacent columns from f0: 2 *
// cols rows of K codes (gate columns, then up columns), `lanes` lanes a
// row. Lane l loads the row's 16-byte chunks l, l + lanes, ... through a
// ring of GU_RING in registers, each load clamped to the row (dead rows to
// the last one), the first GU_RING issued before the pair's row is staged;
// it holds 16 / lanes chunks of each supergroup, whose exact int32 sum a
// shuffle over the row's lanes forms. Shared memory: the pair's xq row [K],
// its scales [nsg], the weight scales [nsg][gate, up][cols] (each thread's
// first one loaded before the sums) and the sums [2 cols][nsg].
__global__ void __launch_bounds__(GU_THREADS)
gate_up_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xst, int s_sg,
                  int s_p, const int* __restrict__ ids, const int8_t* __restrict__ gate,
                  const float* __restrict__ gsw, const int8_t* __restrict__ up,
                  const float* __restrict__ usw, const float* __restrict__ gate_b,
                  const float* __restrict__ up_b, __nv_bfloat16* __restrict__ h, int K, int F,
                  int act, float limit, int cols, int lanes) {
  extern __shared__ __align__(16) int8_t smem[];
  const int p = blockIdx.y, f0 = blockIdx.x * cols, nsg = K / MOE_SG, nch = K / 16;
  const int tid = threadIdx.x, e = ids[p], nws = 2 * nsg * cols;
  float* sx = reinterpret_cast<float*>(smem + K);
  float* sws = sx + nsg;
  int* part = reinterpret_cast<int*>(sws + nws);

  const int rows = 2 * cols, lr = tid % lanes, per = 16 / lanes, cpl = nch / lanes;
  const int r = tid / lanes;                  // one pass: lanes * rows <= GU_THREADS
  const bool live = r < rows;
  const int rr = live ? r : rows - 1, c = rr % cols;
  const int8_t* row = (rr < cols ? gate : up) + ((size_t)e * F + min(f0 + c, F - 1)) * K + 16 * lr;
  // a ring of GU_RING chunks in registers: slot u holds the lane's chunk
  // i0 + u; once it is summed it is refilled with chunk i0 + u + GU_RING
  // (past the row: its last chunk again)
  int4 w[GU_RING];
  auto load = [&](int u, int i) { w[u] = ldg16(row + (size_t)16 * lanes * min(i, cpl - 1)); };
#pragma unroll
  for (int u = 0; u < GU_RING; ++u) load(u, u);
  // sws[(2 sg + which) * cols + c] = (gsw | usw)[e, sg, f0 + c]: one load a
  // thread issued here, stored after the sums
  auto ws = [&](int i) {
    const int cc = i % cols, which = (i / cols) & 1, sg = i / (2 * cols);
    return __ldg((which ? usw : gsw) + ((size_t)e * nsg + sg) * F + min(f0 + cc, F - 1));
  };
  const float ws0 = tid < nws ? ws(tid) : 0.0f;
  for (int ch = tid; ch < nch; ch += GU_THREADS)
    reinterpret_cast<int4*>(smem)[ch] = ldg16(xq + (size_t)p * K + 16 * ch);
  for (int g = tid; g < nsg; g += GU_THREADS) sx[g] = xst[(size_t)g * s_sg + (size_t)p * s_p];
  __syncthreads();

  const int4* x = reinterpret_cast<const int4*>(smem) + lr;
  int s = 0;
  for (int i0 = 0; i0 < cpl; i0 += GU_RING) {
#pragma unroll
    for (int u = 0; u < GU_RING; ++u) {
      const int i = i0 + u;                    // block-uniform
      if (i >= cpl) break;
      s += dot16(x[lanes * i], w[u]);
      load(u, i + GU_RING);
      if (((i + 1) & (per - 1)) == 0) {        // the lane's last chunk of a supergroup
        for (int o = lanes / 2; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        if (live && lr == 0) part[r * nsg + i / per] = s;
        s = 0;
      }
    }
  }
  if (tid < nws) sws[tid] = ws0;
  for (int i = tid + GU_THREADS; i < nws; i += GU_THREADS) sws[i] = ws(i);
  __syncthreads();

  for (int j = tid; j < cols && f0 + j < F; j += GU_THREADS) {
    float g = 0.0f, u = 0.0f;
    for (int sg = 0; sg < nsg; ++sg) {
      g = sg_corr(g, part[j * nsg + sg], sx[sg], sws[2 * sg * cols + j]);
      u = sg_corr(u, part[(cols + j) * nsg + sg], sx[sg], sws[(2 * sg + 1) * cols + j]);
    }
    const size_t cj = (size_t)e * F + f0 + j;
    if (gate_b) g = fadd(g, gate_b[cj]);
    if (up_b) u = fadd(u, up_b[cj]);
    h[(size_t)p * F + f0 + j] = __float2bfloat16_rn(moe_act(g, u, act, limit));
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

// cols and lanes: the launch plan (ops/moe_decode.py:gate_up_i8_plan);
// lanes a power of two that divides 16, lanes * 2 cols <= 256. The block's
// shared memory is sized here: a shape that does not fit is refused.
extern "C" int ik_moe_decode_gate_up_i8(const void* xq, const void* xst, int s_sg, int s_p,
                                        const void* ids, const void* gate, const void* gsw,
                                        const void* up, const void* usw, const void* gate_b,
                                        const void* up_b, void* h, int P, int K, int F,
                                        int act, float limit, int cols, int lanes,
                                        void* stream) {
  const int nsg = K / MOE_SG;
  const int smem = K + 4 * nsg * (1 + 4 * cols);
  if (K % MOE_SG || K < MOE_SG || cols < 1 || lanes < 1 || 16 % lanes ||
      lanes & (lanes - 1) || 2 * cols * lanes > GU_THREADS || smem > MOE_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  cudaError_t e = set_smem(gate_up_i8_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((F + cols - 1) / cols, P);
  gate_up_i8_kernel<<<grid, GU_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xst), s_sg, s_p,
      static_cast<const int*>(ids), static_cast<const int8_t*>(gate),
      static_cast<const float*>(gsw), static_cast<const int8_t*>(up),
      static_cast<const float*>(usw), static_cast<const float*>(gate_b),
      static_cast<const float*>(up_b), static_cast<__nv_bfloat16*>(h), K, F, act, limit,
      cols, lanes);
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
