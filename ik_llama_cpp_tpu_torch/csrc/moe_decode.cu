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
// the scales), read once per pair. Each block reads its own ids[p]; no
// atomics, so both kernels are deterministic.
//
// Kernel 12: a block takes one pair over `cols` adjacent FF columns, its 2
// * cols gate and up rows all in flight at once (launch plan
// ops/moe_decode.py:gate_up_plan: 16 columns and 8 lanes a row at K 2048),
// each lane streaming its 16-byte code loads and their scales through a
// ring of 4 in registers, the first issued before the pair's bf16 row is
// staged in shared memory; the weights dequantize with no conversion
// instruction (dequant4), a shuffle over the row's lanes forms each dot,
// and one thread a column adds the biases, applies the activation and
// stores h.
//
// Kernel 13: a block puts all of a token's pairs in flight at once, top_k *
// cols rows (launch plan ops/moe_decode.py:down_plan: 8 columns and 8 lanes
// a row at top_k 4, F 1408), 11-12 16-byte chunks a lane, some 45 KB a
// block; the dequantization needs no conversion instruction (dequant4), so
// that the arithmetic left after the last load is short; each pair's column
// dot is formed on its own and the pairs are added in pair order in one
// thread a column.
#include "moe_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GU_THREADS = 256;  // threads of a kernel-12 block (8 warps)
constexpr int GU_RING = 4;       // 16-byte chunks a lane of kernel 12 keeps in flight
static_assert(GU_THREADS == DOWN_THREADS, "kernel 12 stages its row with stage16");

// {bf16(b0 s), bf16(b1 s)} and {bf16(b2 s), bf16(b3 s)} for the four int8
// codes b of w, without a conversion instruction: the byte b + 128 placed
// in the mantissa of 2^23 gives float(b) after one subtraction, its upper
// half is bf16(b) exactly, and one bf16x2 multiply rounds each product once
// to nearest even, as bf16(bf16(code) * bf16(scale)) does.
IK_DEV void dequant4(int w, __nv_bfloat162 s2, uint32_t& w01, uint32_t& w23) {
  const uint32_t u = static_cast<uint32_t>(w) ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
  uint32_t c01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  uint32_t c23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  __nv_bfloat162 p01 = __hmul2_rn(*reinterpret_cast<__nv_bfloat162*>(&c01), s2);
  __nv_bfloat162 p23 = __hmul2_rn(*reinterpret_cast<__nv_bfloat162*>(&c23), s2);
  w01 = *reinterpret_cast<uint32_t*>(&p01);
  w23 = *reinterpret_cast<uint32_t*>(&p23);
}

// acc + four products x * bf16(bf16(code) * s), added in order; x01 / x23
// hold two bf16 each, the lower K position in the lower half. A bf16 x bf16
// product is exact in float32, so the fused multiply-add rounds once, as a
// sum of products does.
IK_DEV float mac4_x2(float acc, int w, __nv_bfloat162 s2, uint32_t x01, uint32_t x23) {
  uint32_t w01, w23;
  dequant4(w, s2, w01, w23);
  acc = fmaf(__uint_as_float(x01 << 16), __uint_as_float(w01 << 16), acc);
  acc = fmaf(__uint_as_float(x01 & 0xffff0000u), __uint_as_float(w01 & 0xffff0000u), acc);
  acc = fmaf(__uint_as_float(x23 << 16), __uint_as_float(w23 << 16), acc);
  return fmaf(__uint_as_float(x23 & 0xffff0000u), __uint_as_float(w23 & 0xffff0000u), acc);
}

IK_DEV __nv_bfloat162 load_scale2(const float* p) { return __float2bfloat162_rn(__ldg(p)); }
IK_DEV __nv_bfloat162 load_scale2(const __nv_bfloat16* p) { return __bfloat162bfloat162(*p); }

// Kernel 12. A block takes pair p over `cols` adjacent columns from f0: 2 *
// cols rows of K codes (gate columns, then up columns), `lanes` lanes a
// row. Lane l loads the row's 16-byte chunks l, l + lanes, ... and the
// scale of each beside it through a ring of GU_RING chunks in registers,
// each load clamped to the row (dead rows to the last column), so that
// GU_RING loads a lane stay in flight; the first GU_RING are issued before
// the pair's bf16 row is staged in shared memory. A shuffle over the row's
// lanes forms its dot (at 32 lanes a row the sum order of the kernel's
// first port: h keeps its bits); the dots go to shared memory [2][cols]
// and one thread a column finishes h.
template <typename S>
__global__ void __launch_bounds__(GU_THREADS)
gate_up_kernel(const __nv_bfloat16* __restrict__ xp, const int* __restrict__ ids,
               const int8_t* __restrict__ gate, const S* __restrict__ gs,
               const int8_t* __restrict__ up, const S* __restrict__ us,
               const float* __restrict__ gate_b, const float* __restrict__ up_b,
               __nv_bfloat16* __restrict__ h, int K, int F, int group, int act, float limit,
               int cols, int lanes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int p = blockIdx.y, f0 = blockIdx.x * cols, nch = K / 16, ngrp = K / group;
  const int tid = threadIdx.x, e = ids[p];
  const uint4* x = reinterpret_cast<const uint4*>(smem);       // the pair's row, K bf16
  float* part = reinterpret_cast<float*>(smem + (size_t)K * 2);  // [2][cols] dots

  const int rows = 2 * cols, lr = tid % lanes, cpl = (nch + lanes - 1) / lanes;
  const float inv = 1.0f / static_cast<float>(group / 16);     // as in kernel 13
  const int r = tid / lanes;                  // one pass: lanes * rows <= GU_THREADS
  const bool live = r < rows;
  const int rr = live ? r : rows - 1, c = rr % cols;
  const size_t col = (size_t)e * F + min(f0 + c, F - 1);
  const int4* row = reinterpret_cast<const int4*>((rr < cols ? gate : up) + col * K);
  const S* sc = (rr < cols ? gs : us) + (size_t)e * ngrp * F + (col - (size_t)e * F);
  // a ring of GU_RING chunks in registers: slot u holds the lane's chunk
  // i0 + u; once it is summed it is refilled with chunk i0 + u + GU_RING
  // (clamped to the row: every load is unconditional, so that the compiler
  // keeps them in flight and waits for them in order)
  int4 w[GU_RING];
  __nv_bfloat162 s2[GU_RING];
  auto load = [&](int u, int i) {
    const int q = min(lr + lanes * i, nch - 1);
    w[u] = __ldg(row + q);
    s2[u] = load_scale2(sc + (size_t)static_cast<int>((q + 0.5f) * inv) * F);
  };
#pragma unroll
  for (int u = 0; u < GU_RING; ++u) load(u, u);
  stage16(smem, xp + (size_t)p * K, K / 8, tid);
  __syncthreads();

  float acc = 0.0f;
  for (int i0 = 0; i0 < cpl; i0 += GU_RING) {
#pragma unroll
    for (int u = 0; u < GU_RING; ++u) {
      const int q = lr + lanes * (i0 + u);
      if (i0 + u >= cpl) break;                 // block-uniform
      if (q < nch) {
        const uint4 xa = x[2 * q], xb = x[2 * q + 1];
        acc = mac4_x2(acc, w[u].x, s2[u], xa.x, xa.y);
        acc = mac4_x2(acc, w[u].y, s2[u], xa.z, xa.w);
        acc = mac4_x2(acc, w[u].z, s2[u], xb.x, xb.y);
        acc = mac4_x2(acc, w[u].w, s2[u], xb.z, xb.w);
      }
      load(u, i0 + u + GU_RING);               // past the row: its last chunk again
    }
  }
  for (int o = lanes / 2; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (live && lr == 0) part[r] = acc;
  __syncthreads();

  for (int j = tid; j < cols && f0 + j < F; j += GU_THREADS) {
    const size_t cj = (size_t)e * F + f0 + j;
    float g = part[j], u = part[cols + j];
    if (gate_b) g = fadd(g, gate_b[cj]);
    if (up_b) u = fadd(u, up_b[cj]);
    h[(size_t)p * F + f0 + j] = __float2bfloat16_rn(moe_act(g, u, act, limit));
  }
}

// Kernel 13. A block takes token t's top_k pairs over `cols` adjacent
// columns from n0: top_k * cols rows of F codes (pair j, column c; a pair's
// rows are one contiguous span), `lanes` lanes a row. Lane l loads the
// row's 16-byte chunks l, l + lanes, ... and the scale of each beside it
// (adjacent columns share a scale sector), in batches of DOWN_BATCH, each
// load unconditional (clamped to the row) so that the compiler keeps them
// all in flight and waits for them in order. The token's bf16 rows [top_k][F]
// sit in shared memory. A shuffle over the row's lanes forms the pair's
// column dot; the dots go to shared memory [top_k][cols] and one thread a
// column adds them in pair order, as the plain version and the Pallas
// kernel do.
template <typename S>
__global__ void __launch_bounds__(DOWN_THREADS)
down_planar_kernel(const __nv_bfloat16* __restrict__ hw, const int* __restrict__ ids,
                   const int8_t* __restrict__ down, const S* __restrict__ ds,
                   float* __restrict__ out, int top_k, int F, int E, int group, int cols,
                   int lanes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = blockIdx.y, n0 = blockIdx.x * cols, nch = F / 16, ngrp = F / group;
  const int tid = threadIdx.x, p0 = t * top_k;
  const uint4* x = reinterpret_cast<const uint4*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)top_k * F * 2);
  int* eid = reinterpret_cast<int*>(part + top_k * cols);
  stage16(smem, hw + (size_t)p0 * F, top_k * F / 8, tid);
  for (int j = tid; j < top_k; j += DOWN_THREADS) eid[j] = ids[p0 + j];
  __syncthreads();

  const int rows = top_k * cols, lr = tid % lanes, cpl = (nch + lanes - 1) / lanes;
  // int((q + 0.5f) * inv) = q / (group / 16) for every group and every chunk
  // q of a row that fits the shared memory (tests/test_torch_moe_down.py)
  const float inv = 1.0f / static_cast<float>(group / 16);
  for (int r = tid / lanes; r - tid / lanes < rows; r += DOWN_THREADS / lanes) {
    const bool live = r < rows;
    const int j = (live ? r : rows - 1) / cols, c = (live ? r : rows - 1) % cols;
    const int e = eid[j], n = min(n0 + c, E - 1);
    const int4* row = reinterpret_cast<const int4*>(down + ((size_t)e * E + n) * F);
    const S* sc = ds + (size_t)e * ngrp * E + n;
    const uint4* xr = x + (size_t)j * (F / 8);
    float acc = 0.0f;
    for (int b0 = 0; b0 < cpl; b0 += DOWN_BATCH) {
      int4 w[DOWN_BATCH];
      __nv_bfloat162 s2[DOWN_BATCH];
#pragma unroll
      for (int i = 0; i < DOWN_BATCH; ++i) {
        const int q = min(lr + lanes * (b0 + i), nch - 1);
        w[i] = __ldg(row + q);
        s2[i] = load_scale2(sc + (size_t)static_cast<int>((q + 0.5f) * inv) * E);
      }
#pragma unroll
      for (int i = 0; i < DOWN_BATCH; ++i) {
        const int q = lr + lanes * (b0 + i);
        if (b0 + i >= cpl) break;               // warp-uniform
        if (q < nch) {
          const uint4 xa = xr[2 * q], xb = xr[2 * q + 1];
          acc = mac4_x2(acc, w[i].x, s2[i], xa.x, xa.y);
          acc = mac4_x2(acc, w[i].y, s2[i], xa.z, xa.w);
          acc = mac4_x2(acc, w[i].z, s2[i], xb.x, xb.y);
          acc = mac4_x2(acc, w[i].w, s2[i], xb.z, xb.w);
        }
      }
    }
    for (int o = lanes / 2; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (live && lr == 0) part[j * cols + c] = acc;
  }
  __syncthreads();

  for (int c = tid; c < cols && n0 + c < E; c += DOWN_THREADS) {
    float acc = 0.0f;
    for (int j = 0; j < top_k; ++j) acc = fadd(acc, part[j * cols + c]);
    out[(size_t)t * E + n0 + c] = acc;
  }
}

template <typename S>
cudaError_t launch_gate_up(const void* xp, const void* ids, const void* gate, const void* gs,
                           const void* up, const void* us, const void* gate_b,
                           const void* up_b, void* h, int P, int K, int F, int group, int act,
                           float limit, int cols, int lanes, int smem, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e = set_smem(gate_up_kernel<S>, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((F + cols - 1) / cols, P);
  gate_up_kernel<S><<<grid, GU_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const int*>(ids),
      static_cast<const int8_t*>(gate), static_cast<const S*>(gs),
      static_cast<const int8_t*>(up), static_cast<const S*>(us),
      static_cast<const float*>(gate_b), static_cast<const float*>(up_b),
      static_cast<__nv_bfloat16*>(h), K, F, group, act, limit, cols, lanes);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_down(const void* hw, const void* ids, const void* down, const void* ds,
                        void* out, int T, int top_k, int F, int E, int group, int cols,
                        int lanes, int smem, cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e = set_smem(down_planar_kernel<S>, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((E + cols - 1) / cols, T);
  down_planar_kernel<S><<<grid, DOWN_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(hw), static_cast<const int*>(ids),
      static_cast<const int8_t*>(down), static_cast<const S*>(ds),
      static_cast<float*>(out), top_k, F, E, group, cols, lanes);
  return cudaGetLastError();
}

}  // namespace

// scale_bf16: the scales are bf16 (else float32). K % 16 == 0, group % 16 ==
// 0, K % group == 0. cols and lanes: the launch plan
// (ops/moe_decode.py:gate_up_plan), lanes a power of two up to 32 with all
// 2 * cols rows in one pass of the block. The block's shared memory is
// sized here: a shape whose row does not fit is refused.
extern "C" int ik_moe_decode_gate_up(const void* xp, const void* ids, const void* gate,
                                     const void* gs, const void* up, const void* us,
                                     int scale_bf16, const void* gate_b, const void* up_b,
                                     void* h, int P, int K, int F, int group, int act,
                                     float limit, int cols, int lanes, void* stream) {
  if (K % 16 || group % 16 || group < 16 || K % group || cols < 1 || lanes < 1 ||
      lanes > 32 || lanes & (lanes - 1) || 2 * cols * lanes > GU_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * K + 8 * cols;
  if (smem > MOE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16 ? launch_gate_up<__nv_bfloat16>(xp, ids, gate, gs, up, us, gate_b, up_b, h, P,
                                                 K, F, group, act, limit, cols, lanes, smem, s)
                 : launch_gate_up<float>(xp, ids, gate, gs, up, us, gate_b, up_b, h, P, K, F,
                                         group, act, limit, cols, lanes, smem, s));
}

// cols and lanes: the launch plan (ops/moe_decode.py:down_plan); lanes a
// power of two up to 32. The block's shared memory is sized here: a shape
// whose rows do not fit is refused.
extern "C" int ik_moe_decode_down(const void* hw, const void* ids, const void* down,
                                  const void* ds, int scale_bf16, void* out, int T, int top_k,
                                  int F, int E, int group, int cols, int lanes, void* stream) {
  if (F % 16 || group % 16 || group < 16 || F % group || cols < 1 || lanes < 1 ||
      lanes > 32 || lanes & (lanes - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * top_k * F + 4 * top_k * (cols + 1);
  if (smem > MOE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16 ? launch_down<__nv_bfloat16>(hw, ids, down, ds, out, T, top_k, F, E, group,
                                              cols, lanes, smem, s)
                 : launch_down<float>(hw, ids, down, ds, out, T, top_k, F, E, group, cols,
                                      lanes, smem, s));
}
