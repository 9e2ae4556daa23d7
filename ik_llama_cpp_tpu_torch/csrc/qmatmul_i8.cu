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
// M > 16, qmatmul_i8_wgmma_kernel (prefill). Bound by int8 tensor-core
// work from M ~ 64 up: 2MNK operations against NK weight bytes (at M = 512,
// K = 4096, N = 28672 the card's 1,979 TOP/s need 0.061 ms, its 3.35 TB/s
// 0.053 ms for every byte, the f32 output included). On Hopper only the
// warpgroup MMA reaches that rate, so the design is Hopper's GEMM shape:
// - wgmma.mma_async m64nBNk32 s32.s8.s8 (BN = 64, 128 or 192), both
//   operands K-major in shared memory, read through 128-byte swizzle
//   descriptors;
// - a ring of 128-deep K stages (8, 6 or 5 of them: ~200 KB), loaded by
//   TMA (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no
//   -lcuda; a map is encoded on the host at each call) under full/empty
//   mbarriers by one producer warp; rows and columns past M and N read as
//   zeros;
// - each supergroup's xs (128 rows) and sw (the tile's columns) slices go
//   into the first of its two stages by cp.async from the producer's lanes,
//   with an mbarrier arrive that fires when they land: the K loop reads
//   no global memory;
// - two consumer warpgroups of 64 rows (setmaxnreg: 232 registers each, the
//   producer 40); each supergroup's int32 sums start from zero (scale-d 0 on
//   its first wgmma) and are folded as acc += float(part) * (xs * sw), in
//   supergroup order: the expression and order of the mma.sync form this
//   replaces, so its bits. While one warpgroup folds, the other's wgmmas
//   keep the tensor cores busy. (A second set of sums, so that a warpgroup's
//   own next MMAs run during its fold, made ptxas serialize the wgmmas and
//   ran slower; so did clusters of two blocks sharing the weight tile by
//   TMA multicast. PERF.md has the numbers.)
// - one block an SM walks the output tiles (a persistent grid of
//   ops/qmatmul.tiled_i8_plan's blocks), rows fastest, so that the blocks in
//   flight share each weight tile in L2; K is never split (the order of the
//   corrections would change); the plan picks the tile width whose rounds
//   of the grid cost least (N 6144 takes 192 columns: 128 tiles, one round).
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SG = 256;          // supergroup depth

// ------------------------------------------------------------ M > 16 -----
namespace tiled {

constexpr int BM = 128;          // rows of a tile: two consumer warpgroups of 64
constexpr int BK = 128;          // K of a stage: one 128-byte swizzled row a tile row
constexpr int THREADS = 384;     // the producer warpgroup, then two consumer warpgroups

template <int BN, int STAGES>
struct Smem {
  static constexpr int A = BM * BK, B = BN * BK;      // bytes of a stage's code tiles
  static constexpr int SC = BM + BN;                  // floats of a stage's scales
  static constexpr int BYTES = STAGES * (A + B + SC * 4) + 2 * STAGES * 8 + 1024;
};

// One block an SM walks the output tiles blockIdx.x, + gridDim.x, ...
// (tile i: rows (i % tiles_m) * BM, columns (i / tiles_m) * BN, so the
// blocks in flight share weight tiles in L2).
template <int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
qmatmul_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w,
                        const float* __restrict__ xs, const float* __restrict__ sw,
                        float* __restrict__ out, int M, int N, int K) {
  using L = Smem<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned stages: the swizzle pattern repeats every 8 rows
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* sa = reinterpret_cast<int8_t*>(base);                  // [STAGES][BM][BK]
  int8_t* sb = sa + STAGES * L::A;                                // [STAGES][BN][BK]
  float* ssc = reinterpret_cast<float*>(sb + STAGES * L::B);      // [STAGES][xs BM | sw BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(ssc + STAGES * L::SC);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid & 31;
  const int nsg = K / SG, nkb = K / BK;
  const int tiles_m = (M + BM - 1) / BM, tiles = tiles_m * ((N + BN - 1) / BN);

  if (tid == 0) {
    // full: the producer lane 0's expect_tx arrive + the 32 lanes' cp.async
    // arrives; empty: the 8 consumer warps
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one warp keeps STAGES stages in flight
    setmaxnreg_dec<40>();
    if (warp == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&full[s], L::A + L::B);
            tma_load_2d(sa + s * L::A, &map_x, &full[s], kb * BK, m0);
            tma_load_2d(sb + s * L::B, &map_w, &full[s], kb * BK, n0);
          }
          if ((kb & 1) == 0) {      // the supergroup's scales ride with its first half
            const int sg = kb >> 1;
            float* sc = ssc + s * L::SC;
            for (int r = lane; r < BM; r += 32)
              cp_async4(sc + r, xs + (size_t)min(m0 + r, M - 1) * nsg + sg);
            for (int c = lane; c < BN; c += 32)
              cp_async4(sc + BM + c, sw + (size_t)sg * N + min(n0 + c, N - 1));
          }
          mbar_arrive_cp_async(&full[s]);
        }
      }
      cp_async_wait<0>();
    }
  } else {
    // consumers: warpgroup c owns rows 64c .. 64c + 63 of the tile
    setmaxnreg_inc<232>();
    constexpr int NR = BN / 2;          // accumulator registers a thread
    const int c = wg - 1, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int xr = c * 64 + w * 16 + g;  // the thread's tile rows xr, xr + 8
    int part[NR];
    float acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) part[i] = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      for (int sg = 0; sg < nsg; ++sg, it += 2) {
        const int s0 = it % STAGES, s1 = (it + 1) % STAGES;
        mbar_wait(&full[s0], (it / STAGES) & 1);
        mbar_wait(&full[s1], ((it + 1) / STAGES) & 1);
        // the supergroup's exact int32 sums, from zero
        fence_regs<NR>(part);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = h ? s1 : s0;
          const uint64_t da = desc_sw128(sa + s * L::A + c * 64 * BK);
          const uint64_t db = desc_sw128(sb + s * L::B);
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            wgmma_s8<BN>(part, da + 2 * kk, db + 2 * kk, (h | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NR>(part);
        // acc += part * (xs[m, sg] * sw[sg, n]), the expression of the
        // mma.sync form, supergroup by supergroup
        const float* sc = ssc + s0 * L::SC;
        const float x0 = sc[xr], x1 = sc[xr + 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float w0 = sc[BM + 8 * j + 2 * t], w1 = sc[BM + 8 * j + 2 * t + 1];
          acc[4 * j + 0] += (float)part[4 * j + 0] * (x0 * w0);
          acc[4 * j + 1] += (float)part[4 * j + 1] * (x0 * w1);
          acc[4 * j + 2] += (float)part[4 * j + 2] * (x1 * w0);
          acc[4 * j + 3] += (float)part[4 * j + 3] * (x1 * w1);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[s0]);
          mbar_arrive(&empty[s1]);
        }
      }
      // d[4j + e]: row xr + 8 (e >> 1), column 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + xr + 8 * hh;
          if (row >= M) continue;
          float* o = out + (size_t)row * N + col;
          if (col + 1 < N && (N & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          } else {
            if (col < N) o[0] = acc[4 * j + 2 * hh];
            if (col + 1 < N) o[1] = acc[4 * j + 2 * hh + 1];
          }
        }
      }
    }
  }
}

// (rows, K) int8 row-major as boxes of BK x box_rows in 128-byte swizzle;
// rows past the end read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  return tensor_map_2d(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, rows, K, BK, box_rows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, int STAGES>
cudaError_t launch(const int8_t* xq, const float* xs, const int8_t* wt, const float* sw,
                   float* out, int M, int N, int K, int blocks, cudaStream_t s) {
  using L = Smem<BN, STAGES>;
  static_assert(L::BYTES <= 232448, "shared memory of one block");
  static bool smem_set = false;
  auto kern = qmatmul_i8_wgmma_kernel<BN, STAGES>;
  cudaError_t e = set_smem(kern, L::BYTES, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mw;
  if ((e = make_map(&mx, xq, M, K, BM)) != cudaSuccess) return e;
  if ((e = make_map(&mw, wt, N, K, BN)) != cudaSuccess) return e;
  kern<<<blocks, THREADS, L::BYTES, s>>>(mx, mw, xs, sw, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace tiled


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

// splits: at M <= 16 the blocks of a cluster that split K (1-8;
// ops/qmatmul.gemv_i8_plan); above, the persistent grid's blocks and
// tile_n the columns of an output tile, 192, 128 or 64 (ops/qmatmul.tiled_i8_plan).
extern "C" int ik_qmatmul_i8(const void* xq, const void* xs, const void* wt,
                             const void* sw, void* out, int M, int N, int K,
                             int splits, int tile_n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(xq);
  auto b = static_cast<const int8_t*>(wt);
  auto as = static_cast<const float*>(xs);
  auto bs = static_cast<const float*>(sw);
  auto o = static_cast<float*>(out);
  if (K % SG != 0 || M < 1 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (M <= 16) {
    if (splits > gemv::MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
    e = M <= 8 ? gemv::launch<1>(a, as, b, bs, o, M, N, K, splits, s)
               : gemv::launch<2>(a, as, b, bs, o, M, N, K, splits, s);
  } else if (tile_n == 192) {
    e = tiled::launch<192, 5>(a, as, b, bs, o, M, N, K, splits, s);
  } else if (tile_n == 128) {
    e = tiled::launch<128, 6>(a, as, b, bs, o, M, N, K, splits, s);
  } else if (tile_n == 64) {
    e = tiled::launch<64, 8>(a, as, b, bs, o, M, N, K, splits, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
