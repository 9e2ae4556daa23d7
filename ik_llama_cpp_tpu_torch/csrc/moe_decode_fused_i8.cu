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
// Bound on the H100: the routed experts' code bytes (gate and up once per
// pair, down once per pair), a few dp4a a byte. The TPU kernel walks the
// pairs in order on one core and carries the token rows in scratch memory.
// Here every block takes one work item from a ticket counter (one atomicAdd
// at its start): the phase-1 items (pair, 16 columns of FF) come first, then
// the phase-2 items (token, a few columns of E; the launch plan of kernel 8,
// ops/moe_decode.py:down_plan).
// No item waits on one that has not started, so no cooperative launch and
// no grid-wide barrier are needed.
//
// Phase 1: a block puts the 32 gate and up rows of its 16 columns in flight
// at once, 8 lanes a row, 16 unconditional 16-byte loads a lane (64 KB a
// block); the supergroup sums are shuffle-reduced over the row's lanes and
// every lane of the row adds their corrections in supergroup order. h goes
// to a bf16 scratch; the block that completes a (pair, supergroup) -- found
// by a counter a (pair, supergroup) -- requantizes its 256 values once into
// an int8 scratch and its scale, then counts the token as one step readier.
// Phase 2: kernel 8's block (a token's top_k x cols rows in flight at once)
// issues its down loads, which do not depend on h, before it waits for its
// token's count; it then reads the int8 h from L2 and adds the corrections
// pair by pair, supergroup by supergroup, in one thread a column. Every sum
// has one fixed order and no float atomics: the result repeats bit for bit
// and equals the plain version's. The counters are one zeroed int32 buffer
// a device (the wrapper keeps it), which the last block to finish resets.
#include "moe_matvec_i8.cuh"

namespace {

constexpr int THREADS = DOWN_THREADS;    // 256 threads a block, both phases
constexpr int L1 = 8;                    // lanes of a phase-1 row
constexpr int B1 = 16;                   // 16-byte chunks a phase-1 lane loads at once
constexpr int PER1 = 16 / L1;            // chunks of one supergroup a phase-1 lane holds
constexpr int SGB1 = B1 / PER1;          // supergroups of a phase-1 batch
constexpr int COLS1 = THREADS / L1 / 2;  // FF columns of a phase-1 item (gate and up rows)
constexpr int B2 = 12;                   // 16-byte chunks a phase-2 lane loads at once

IK_DEV int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// counters: [0] the ticket, [1] blocks done, then one a (pair, supergroup),
// then one a token (its requantized supergroups).
__global__ void __launch_bounds__(THREADS)
fused_decode_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xst,
                       int s_sg, int s_p, const int* __restrict__ ids,
                       const float* __restrict__ wts, const int8_t* __restrict__ gate,
                       const float* __restrict__ gsw, const int8_t* __restrict__ up,
                       const float* __restrict__ usw, const int8_t* __restrict__ down,
                       const float* __restrict__ dsw, const float* __restrict__ gate_b,
                       const float* __restrict__ up_b, __nv_bfloat16* hbuf, int8_t* hq,
                       float* hs, int* counters, float* __restrict__ out, int P, int top_k,
                       int K, int F, int E, int cols, int lanes, int act, float limit) {
  extern __shared__ __align__(16) int8_t smem[];
  int* flag = reinterpret_cast<int*>(smem);   // a word of the block's, reused below
  const int tid = threadIdx.x, lane = tid & 31;
  const int T = P / top_k, nsgf = F / MOE_SG;
  int* ticket = counters;
  int* done = counters + 1;
  int* sgcnt = counters + 2;                  // [P][nsgf]
  int* ready = sgcnt + P * nsgf;              // [T]

  if (tid == 0) *flag = atomicAdd(ticket, 1);
  __syncthreads();
  const int item = *flag;
  __syncthreads();
  const int n_ft = F / COLS1, items1 = P * n_ft;

  if (item < items1) {
    // ---- phase 1: 16 columns of pair p, gate and up ----
    const int nsg = K / MOE_SG, nch = K / 16, cpl = nch / L1;
    const int p = item / n_ft, f0 = (item % n_ft) * COLS1;
    const int r = tid / L1, lr = tid % L1, c = r >> 1, f = f0 + c;
    const bool is_up = r & 1;
    const int e = __ldg(ids + p);
    const size_t row = (size_t)e * F + f;
    const int8_t* wrow = (is_up ? up : gate) + row * K + 16 * lr;
    const float* wsc = (is_up ? usw : gsw) + (size_t)e * nsg * F + f;
    int4 w[B1];
    float swv[SGB1];
    auto load = [&](int b0) {   // clamped: every load unconditional, in order
#pragma unroll
      for (int i = 0; i < B1; ++i)
        w[i] = ldg16(wrow + (size_t)16 * L1 * min(b0 + i, cpl - 1));
#pragma unroll
      for (int i = 0; i < SGB1; ++i)
        swv[i] = __ldg(wsc + (size_t)min(b0 / PER1 + i, nsg - 1) * F);
    };
    load(0);
    // the pair's activation row and its scales, staged while the codes fly
    float* sx = reinterpret_cast<float*>(smem + K);
    for (int ch = tid; ch < nch; ch += THREADS)
      reinterpret_cast<int4*>(smem)[ch] = ldg16(xq + (size_t)p * K + 16 * ch);
    for (int g = tid; g < nsg; g += THREADS) sx[g] = xst[(size_t)g * s_sg + (size_t)p * s_p];
    __syncthreads();
    const int4* x = reinterpret_cast<const int4*>(smem) + lr;
    float acc = 0.0f;
    int s = 0;
    for (int b0 = 0; b0 < cpl; b0 += B1) {
      if (b0) load(b0);
#pragma unroll
      for (int i = 0; i < B1; ++i) {
        const int q = b0 + i;                       // block-uniform
        if (q >= cpl) break;
        s += dot16(x[L1 * q], w[i]);
        if ((q + 1) % PER1 == 0) {                  // the lane's last chunk of a supergroup
#pragma unroll
          for (int o = L1 / 2; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
          acc = sg_corr(acc, s, sx[q / PER1], swv[i / PER1]);
          s = 0;
        }
      }
    }
    // lanes 0-7 and 16-23 hold a gate row, lanes 8-15 and 24-31 its up row
    if (is_up && up_b) acc = fadd(acc, up_b[row]);
    const float u = __shfl_down_sync(FULL, acc, L1);
    const bool writer = !is_up && lr == 0;
    if (writer) {
      const float g = gate_b ? fadd(acc, gate_b[row]) : acc;
      const float hb = __bfloat162float(__float2bfloat16_rn(moe_act(g, u, act, limit)));
      hbuf[(size_t)p * F + f] = __float2bfloat16_rn(fmul(hb, wts[p]));
      __threadfence();
    }
    __syncthreads();                          // every h of the item written
    const int sgi = p * nsgf + f0 / MOE_SG;
    if (tid == 0) *flag = atomicAdd(&sgcnt[sgi], 1) == MOE_SG / COLS1 - 1;
    __syncthreads();
    if (*flag && tid < 32) {
      // the last item of (p, supergroup): requantize its 256 values once
      __threadfence();
      const int s0 = f0 / MOE_SG * MOE_SG;
      const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(hbuf + (size_t)p * F + s0 + lane * 8));
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
        const int cq = max(-127, min(127, __float2int_rn(fmul(v[q], inv))));
        packed[q >> 2] |= static_cast<uint32_t>(cq & 0xff) << (8 * (q & 3));
      }
      *reinterpret_cast<uint2*>(hq + (size_t)p * F + s0 + lane * 8) = make_uint2(packed[0], packed[1]);
      if (lane == 0) hs[sgi] = sc;
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicAdd(&ready[p / top_k], 1);
    }
  } else if (item - items1 < T * ((E + cols - 1) / cols)) {
    // ---- phase 2: token t's pairs over `cols` columns from n0 (kernel 8's block) ----
    const int n_et = (E + cols - 1) / cols, it2 = item - items1;
    const int t = it2 / n_et, n0 = (it2 % n_et) * cols, nch = F / 16;
    const int p0 = t * top_k, nws = top_k * nsgf * cols;
    float* shs = reinterpret_cast<float*>(smem);       // [top_k][nsgf]
    float* sws = shs + top_k * nsgf;                   // [top_k][nsgf][cols]
    int* part = reinterpret_cast<int*>(sws + nws);     // [top_k][nsgf][cols]
    auto ws = [&](int i) {
      const int cc = i % cols, jg = i / cols;
      return __ldg(dsw + ((size_t)__ldg(ids + p0 + jg / nsgf) * nsgf + jg % nsgf) * E +
                   min(n0 + cc, E - 1));
    };
    const float ws0 = tid < nws ? ws(tid) : 0.0f;
    const int rows = top_k * cols, lr = tid % lanes, per = 16 / lanes, cpl = nch / lanes;
    const int r0 = tid / lanes;
    // the first pass's row: its codes are loaded before the wait for h
    const bool live0 = r0 < rows;
    const int j0 = (live0 ? r0 : rows - 1) / cols, c0 = (live0 ? r0 : rows - 1) % cols;
    const int8_t* row0 = down + ((size_t)__ldg(ids + p0 + j0) * E + min(n0 + c0, E - 1)) * F +
                         16 * lr;
    int4 w[B2];
#pragma unroll
    for (int i = 0; i < B2; ++i) w[i] = ldg16(row0 + (size_t)16 * lanes * min(i, cpl - 1));

    if (tid == 0) {
      while (ld_acquire(&ready[t]) < top_k * nsgf) __nanosleep(64);
      __threadfence();
    }
    __syncthreads();                          // the token's int8 h is written and visible
    for (int i = tid; i < top_k * nsgf; i += THREADS) shs[i] = __ldcg(hs + (size_t)p0 * nsgf + i);

    for (int r = r0; r - r0 < rows; r += THREADS / lanes) {
      const bool live = r < rows;
      const int j = (live ? r : rows - 1) / cols, cc = (live ? r : rows - 1) % cols;
      const int8_t* rowp = down + ((size_t)__ldg(ids + p0 + j) * E + min(n0 + cc, E - 1)) * F +
                           16 * lr;
      const int4* x = reinterpret_cast<const int4*>(hq + (size_t)(p0 + j) * F) + lr;
      int s = 0;
      for (int b0 = 0; b0 < cpl; b0 += B2) {
        if (r != r0 || b0) {
#pragma unroll
          for (int i = 0; i < B2; ++i) w[i] = ldg16(rowp + (size_t)16 * lanes * min(b0 + i, cpl - 1));
        }
#pragma unroll
        for (int i = 0; i < B2; ++i) {
          const int q = b0 + i;                     // warp-uniform
          if (q >= cpl) break;
          s += dot16(__ldcg(x + lanes * q), w[i]);
          if (((q + 1) & (per - 1)) == 0) {         // the lane's last chunk of a supergroup
            for (int o = lanes / 2; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
            if (live && lr == 0) part[(j * nsgf + q / per) * cols + cc] = s;
            s = 0;
          }
        }
      }
    }
    if (tid < nws) sws[tid] = ws0;
    for (int i = tid + THREADS; i < nws; i += THREADS) sws[i] = ws(i);
    __syncthreads();
    for (int cc = tid; cc < cols && n0 + cc < E; cc += THREADS) {
      float acc = 0.0f;
      for (int j = 0; j < top_k; ++j)
        for (int g = 0; g < nsgf; ++g) {
          const int i = (j * nsgf + g) * cols + cc;
          acc = sg_corr(acc, part[i], shs[j * nsgf + g], sws[i]);
        }
      out[(size_t)t * E + n0 + cc] = acc;
    }
  }

  // the last block to finish leaves the counters zero for the next call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(done, 1) == (int)gridDim.x - 1) {
      for (int i = 0; i < P * nsgf + T; ++i) sgcnt[i] = 0;
      *ticket = 0;
      *done = 0;
      __threadfence();
    }
  }
}

}  // namespace

// Dynamic shared memory of a block: the larger of phase 1's activation row
// with its scales and phase 2's scales and sums (ops/moe_decode.py:
// fused_decode_smem_bytes).
static int fused_smem(int top_k, int K, int F, int cols) {
  const int nsgf = F / MOE_SG;
  const int a = K + (K / MOE_SG) * 4, b = 4 * top_k * nsgf * (1 + 2 * cols);
  return a > b ? a : b;
}

// K % 256 == 0, F % 256 == 0, P % top_k == 0; hbuf a bf16 (P, F), hq an
// int8 (P, F) and hs an f32 (P, F/256) scratch; counters 2 + P * F/256 +
// P / top_k zeroed int32 (left zero); cols and lanes the down plan.
extern "C" int ik_moe_decode_fused_i8(const void* xq, const void* xst, int s_sg, int s_p,
                                      const void* ids, const void* wts, const void* gate,
                                      const void* gsw, const void* up, const void* usw,
                                      const void* down, const void* dsw, const void* gate_b,
                                      const void* up_b, void* hbuf, void* hq, void* hs,
                                      void* counters, void* out, int P, int top_k, int K,
                                      int F, int E, int cols, int lanes, int act, float limit,
                                      void* stream) {
  const int smem = fused_smem(top_k, K, F, cols);
  if (K % MOE_SG || F % MOE_SG || top_k < 1 || P % top_k || smem > MOE_SMEM_MAX ||
      cols < 1 || lanes < 1 || 16 % lanes || lanes & (lanes - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;
  cudaError_t e = set_smem(fused_decode_i8_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int items = P * (F / COLS1) + (P / top_k) * ((E + cols - 1) / cols);
  fused_decode_i8_kernel<<<items, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xst), s_sg, s_p,
      static_cast<const int*>(ids), static_cast<const float*>(wts),
      static_cast<const int8_t*>(gate), static_cast<const float*>(gsw),
      static_cast<const int8_t*>(up), static_cast<const float*>(usw),
      static_cast<const int8_t*>(down), static_cast<const float*>(dsw),
      static_cast<const float*>(gate_b), static_cast<const float*>(up_b),
      static_cast<__nv_bfloat16*>(hbuf), static_cast<int8_t*>(hq), static_cast<float*>(hs),
      static_cast<int*>(counters), static_cast<float*>(out), P, top_k, K, F, E, cols, lanes,
      act, limit);
  return static_cast<int>(cudaGetLastError());
}
