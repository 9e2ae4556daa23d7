// int8 x int8 GEMM with supergroup-256 float corrections.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul_i8_mxu (the Pallas
// prefill kernel, _make_kernel_i8) and the XLA qmatmul_i8 that the JAX
// package uses below M = 256: two kernels, chosen by M.
//
//   out[m, n] = sum_g  xs[m, g] * sw[g, n] * sum_{k in g} xq[m, k] * w[k, n]
//
// xq: int8 (M, K) row-major; xs: f32 (M, K/256); wt: int8 (N, K) row-major
// (the weight codes stored transposed so both operands are K-contiguous);
// sw: f32 (K/256, N); out: f32 (M, N). K % 256 == 0.
//
// M <= 16, qmatmul_i8_gemv_kernel (decode). Bound on the H100 by the
// weight bytes: 1 a weight plus 4/256 of scales, at 2-32 operations a
// byte. The weight rows are the A operand of mma.sync.m16n8k32.s8 (16
// output columns x 32 k), built in registers straight from 16-byte global
// loads: lane (g, t) reads rows n0 + g and n0 + g + 8 at k0 + 16t .. + 15,
// and the mma's k slots 4t .. 4t+3 and 16+4t .. 16+4t+3 are mapped to
// k0 + 16t + 8h .. + 7 (h = 0, 1: two mmas a load), the same for x, the B
// operand (8 rows of M a lane group g), so nothing is staged in shared
// memory. A 64-deep step is a ring slot; U steps of loads stay in flight
// in registers, every load unconditional (clamped into the warp's own K
// range), and no barrier in the K sweep. Each slot also carries its
// supergroup's sw values for the lane's columns and xs values for its
// rows, so the correction rides in the same round trip as the codes. The
// int32 partial of each (supergroup part, column, row) is exact; its float
// correction is applied once, where the supergroup or the warp's range
// ends. A block's 4 warps share 32 output columns and take consecutive
// ranges of steps; the blocks of a thread-block cluster (the K split, 1-8
// blocks, ops/qmatmul.gemv_i8_plan) take further ranges. A range may
// start or end inside a supergroup (K = 2048 has 8 supergroups for up to
// 32 warps): each part is corrected on its own. The warps' sums are added
// in order through shared memory, the cluster's blocks in rank order
// through distributed shared memory: no atomics, a call repeats bit for
// bit.
//
// M > 16, qmatmul_i8_kernel (prefill). Bound by int8 tensor-core work:
// mma.sync.m16n8k32.s8 on 128 x 128 shared-memory tiles, one 256-deep
// supergroup per pipeline stage (so the int32 partial is exact and its
// float correction happens once per stage), a cp.async ring of stages to
// keep bytes in flight. wgmma and TMA are later work.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SG = 256;          // supergroup depth
constexpr int LDS = SG + 16;     // padded shared row (bytes): conflict-free fragment loads

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul_i8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ wt, const float* __restrict__ sw,
                  float* __restrict__ out, int M, int N, int K) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int CH = SG / 16;    // 16-byte chunks per row per stage
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sa = smem;                           // [STAGES][BM][LDS]
  int8_t* sb = smem + STAGES * BM * LDS;       // [STAGES][BN][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nsg = K / SG;

  auto load_stage = [&](int slot, int sgi) {
    const size_t koff = (size_t)sgi * SG;
    for (int c = tid; c < BM * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 16;
      const int gm = min(m0 + r, M - 1);       // ragged rows: repeat the last row
      cp_async16(sa + (slot * BM + r) * LDS + col, xq + (size_t)gm * K + koff + col);
    }
    for (int c = tid; c < BN * CH; c += NT) {
      const int r = c / CH, col = (c % CH) * 16;
      const int gn = min(n0 + r, N - 1);
      cp_async16(sb + (slot * BN + r) * LDS + col, wt + (size_t)gn * K + koff + col);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsg) load_stage(s, s);
    cp_async_commit();
  }

  for (int sgi = 0; sgi < nsg; ++sgi) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = sgi + STAGES - 1;          // refill the slot read last iteration
    if (nxt < nsg) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const int8_t* a_st = sa + (sgi % STAGES) * BM * LDS;
    const int8_t* b_st = sb + (sgi % STAGES) * BN * LDS;
    int part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0;

#pragma unroll
    for (int kk = 0; kk < SG; kk += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = a_st + (wm + i * 16 + g) * LDS + kk + t * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = b_st + (wn + j * 8 + g) * LDS + kk + t * 4;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8_16832(part[i][j], af[i], bf[j]);
    }

    // rank-1 supergroup correction: acc += part * (xs[m, g] * sw[g, n])
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r0 = min(m0 + wm + i * 16 + g, M - 1);
      const int r1 = min(m0 + wm + i * 16 + g + 8, M - 1);
      const float xs0 = xs[(size_t)r0 * nsg + sgi];
      const float xs1 = xs[(size_t)r1 * nsg + sgi];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c0 = min(n0 + wn + j * 8 + t * 2, N - 1);
        const int c1 = min(n0 + wn + j * 8 + t * 2 + 1, N - 1);
        const float sw0 = sw[(size_t)sgi * N + c0];
        const float sw1 = sw[(size_t)sgi * N + c1];
        acc[i][j][0] += (float)part[i][j][0] * (xs0 * sw0);
        acc[i][j][1] += (float)part[i][j][1] * (xs0 * sw1);
        acc[i][j][2] += (float)part[i][j][2] * (xs1 * sw0);
        acc[i][j][3] += (float)part[i][j][3] * (xs1 * sw1);
      }
    }
  }
  cp_async_wait<0>();

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

template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch(const int8_t* xq, const float* xs, const int8_t* wt,
                   const float* sw, float* out, int M, int N, int K,
                   cudaStream_t stream) {
  static bool smem_set = false;
  constexpr int smem = STAGES * (BM + BN) * LDS;
  auto kern = qmatmul_i8_kernel<BM, BN, WM, WN, STAGES>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(xq, xs, wt, sw, out, M, N, K);
  return cudaGetLastError();
}


// ------------------------------------------------------------ M <= 16 ----
namespace gemv {

constexpr int WARPS = 4;       // warps of a block: the same columns, one K range each
constexpr int COLS = 32;       // output columns of a block: two 16-column mma tiles
constexpr int STEP = 64;       // K of a ring slot: 16 bytes a lane x 4 lanes
constexpr int STEPS_SG = SG / STEP;
constexpr int MAX_SPLITS = 8;  // blocks of a cluster (the portable cluster size)

// 16 code bytes that are read once: past L1.
IK_DEV uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

IK_DEV uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// MT m-tiles of 8 rows (M <= 8 * MT); U steps in flight.
template <int MT, int U>
__global__ void __launch_bounds__(WARPS * 32)
qmatmul_i8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                       const int8_t* __restrict__ wt, const float* __restrict__ sw,
                       float* __restrict__ out, int M, int N, int K) {
  __shared__ float red[WARPS][MT * 8][COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * COLS;
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());

  // steps [i * S / W, (i + 1) * S / W) for warp i of the cluster's W
  // (gemv_k_ranges(K, STEP, splits) in ops/qmatmul.py)
  const int nsg = K / SG, steps = K / STEP;
  const int W = splits * WARPS, wi = rank * WARPS + warp;
  const int s_lo = wi * steps / W, s_hi = (wi + 1) * steps / W;
  const int s_end = max(s_hi - 1, 0);            // loads past the range re-read its last step

  // the lane's weight rows (columns n0 + 16j + g + 8hh), x rows 8mt + g and
  // xs rows 8mt + 2t + e, clamped into the matrices
  const int8_t* wrow[2][2];
  const float* swc[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = min(n0 + 16 * j + g + 8 * hh, N - 1);
      wrow[j][hh] = wt + (size_t)n * K + 16 * t;
      swc[j][hh] = sw + n;
    }
  const int8_t* xrow[MT];
  const float* xsr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xrow[mt] = xq + (size_t)min(8 * mt + g, M - 1) * K + 16 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) xsr[mt][e] = xs + (size_t)min(8 * mt + 2 * t + e, M - 1) * nsg;
  }

  float acc[MT][2][4];
  int part[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f, part[mt][j][e] = 0;

  // a ring of U steps in registers: slot u holds step s0 + u; once a slot
  // is summed it is refilled with step s0 + u + U
  uint4 w[U][2][2];              // [slot][column tile j][row g or g + 8]
  uint4 xv[U][MT];               // x rows 8mt + g
  float cw[U][2][2];             // sw of the step's supergroup, columns as w
  float cx[U][MT][2];            // xs of the step's supergroup, rows 8mt + 2t + e
  auto load_step = [&](int u, int s) {
    const int sc = min(s, s_end);
    const size_t k0 = (size_t)sc * STEP;
    const int sg = sc / STEPS_SG;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        w[u][j][hh] = ld_stream16(wrow[j][hh] + k0);
        cw[u][j][hh] = __ldg(swc[j][hh] + (size_t)sg * N);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      xv[u][mt] = __ldg(reinterpret_cast<const uint4*>(xrow[mt] + k0));
      cx[u][mt][0] = __ldg(xsr[mt][0] + sg);
      cx[u][mt][1] = __ldg(xsr[mt][1] + sg);
    }
  };
  auto sum_step = [&](int u, int s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // A: row g -> column 16j + g, row g + 8 -> column 16j + g + 8;
        // k slots 4t.. -> bytes 8h .. 8h+3, 16+4t.. -> bytes 8h+4 .. 8h+7
        const uint32_t a[4] = {word(w[u][j][0], 2 * h), word(w[u][j][1], 2 * h),
                               word(w[u][j][0], 2 * h + 1), word(w[u][j][1], 2 * h + 1)};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t b[2] = {word(xv[u][mt], 2 * h), word(xv[u][mt], 2 * h + 1)};
          mma_s8_16832(part[mt][j], a, b);
        }
      }
    }
    // the part of the supergroup in this range ends: its exact int32 sums
    // times xs[m] * sw[n], once
    if ((s + 1) % STEPS_SG == 0 || s + 1 == s_hi) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][j][e] += static_cast<float>(part[mt][j][e]) *
                             (cx[u][mt][e & 1] * cw[u][j][e >> 1]);
            part[mt][j][e] = 0;
          }
    }
  };
#pragma unroll
  for (int u = 0; u < U; ++u) load_step(u, s_lo + u);
  for (int s0 = s_lo; s0 < s_hi; s0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < s_hi) sum_step(u, s0 + u);
      load_step(u, s0 + u + U);
    }
  }

  // D = out^T: d0, d1 = (column 16j + g, rows 2t, 2t+1), d2, d3 = (column
  // 16j + g + 8, ...)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp][8 * mt + 2 * t + (e & 1)][16 * j + g + 8 * (e >> 1)] = acc[mt][j][e];
  __syncthreads();
  // the block's warps in order 0, 1, ...: entry e = m * COLS + local column
  float* r0 = &red[0][0][0];
  const int E = M * COLS;
  for (int e = threadIdx.x; e < E; e += WARPS * 32) {
    float v = r0[e];
#pragma unroll
    for (int w_ = 1; w_ < WARPS; ++w_) v += (&red[w_][0][0])[e];
    r0[e] = v;
  }
  cluster.sync();                 // every block's sums are in its red[0]
  // the cluster's blocks in rank order; block `rank` finishes a slice of
  // the entries, reading the others' shared memory
  const int per = (E + splits - 1) / splits;
  const int e_end = min(E, (rank + 1) * per);
  for (int e = rank * per + static_cast<int>(threadIdx.x); e < e_end; e += WARPS * 32) {
    float v = cluster.map_shared_rank(r0, 0)[e];
    for (int r = 1; r < splits; ++r) v += cluster.map_shared_rank(r0, r)[e];
    const int m = e / COLS, n = n0 + e % COLS;
    if (n < N) out[(size_t)m * N + n] = v;
  }
  cluster.sync();                 // no block leaves while its shared memory is read
}

template <int MT>
cudaError_t launch(const int8_t* xq, const float* xs, const int8_t* wt, const float* sw,
                   float* out, int M, int N, int K, int splits, cudaStream_t s) {
  // two steps in flight: 120 registers at MT = 1, four blocks an SM; a ring
  // of 4 (166 registers, three blocks) ran slower on the H100 (PERF.md)
  constexpr int U = 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + COLS - 1) / COLS, splits, 1);
  cfg.blockDim = dim3(WARPS * 32, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, qmatmul_i8_gemv_kernel<MT, U>, xq, xs, wt, sw,
                                     out, M, N, K);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace gemv

}  // namespace

// splits: the blocks of a cluster that split K at M <= 16 (1-8;
// ops/qmatmul.gemv_i8_plan); not read above 16 rows.
extern "C" int ik_qmatmul_i8(const void* xq, const void* xs, const void* wt,
                             const void* sw, void* out, int M, int N, int K,
                             int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(xq);
  auto b = static_cast<const int8_t*>(wt);
  auto as = static_cast<const float*>(xs);
  auto bs = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  if (K % SG != 0 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (M <= 16) {
    if (splits < 1 || splits > gemv::MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
    e = M <= 8 ? gemv::launch<1>(a, as, b, bs, o, M, N, K, splits, s)
               : gemv::launch<2>(a, as, b, bs, o, M, N, K, splits, s);
  } else {
    e = launch<128, 128, 64, 32, 2>(a, as, b, bs, o, M, N, K, s);
  }
  return static_cast<int>(e);
}
