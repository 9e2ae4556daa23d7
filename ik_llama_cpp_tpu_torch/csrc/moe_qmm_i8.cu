// MoE prefill over int8 supergroup-256 experts: the grouped (ragged) int8
// GEMM (kernel 10) and the capacity-bucketed whole-FFN kernel (kernel 9).
//
// Replaces ik_llama_cpp_tpu/ops/moe_qmm.py:ragged_qmatmul_i8 and
// :fused_moe_prefill_i8 (the Pallas kernels of the MoE prefill).
//
// Codes are stored (G, N, K) so that both MMA operands are K-contiguous;
// activation scales are read through strides (the JAX layout keeps them
// transposed). Every 256-deep supergroup's int32 products are exact; its
// float correction part * (sx * sw) is added in supergroup order with no
// contraction into FMA, the order and rounding of the plain versions, so
// both kernels give the plain versions' bits.
//
// Kernel 10, ragged_i8_wgmma_kernel: out[m, n] = sum_g xs[m, g] sw[e(m), g, n]
// dot_g(xq[m], w[e(m), n]) with e(m) the group that owns sorted row m.
// Bound by the live experts' code bytes at the models' sizes (phase 3's
// skewed row: 128 experts of 2048 x 768 codes, 201 MB of the 225 MB moved,
// against 2 x 4096 x 2048 x 768 int8 operations, a tenth of that time).
// The design joins two of the port's: the grouped work list of kernel 14
// (csrc/moe_grouped.cuh: a persistent grid sized from M, N and G walks
// sweeps of (expert with rows, 128 columns, TM of its rows) read from the
// group sizes on the device, an expert's sweeps adjacent so that its codes
// come from device memory about once a column tile and are shared in L2;
// no host read, no step table; an empty overflow pass costs one launch)
// and kernel A's int8 warpgroup MMA (qmatmul_i8.cu: wgmma.mma_async
// m64nTMk32 s32.s8.s8 with both operands K-major in 128-byte swizzled
// shared memory, a ring of 128-deep stages loaded by TMA under full/empty
// mbarriers from one producer warp, each supergroup's xs and sw slices by
// cp.async into its first stage; two consumer warpgroups). The product is
// computed as out^T = W^T x^T, kernel 14's orientation: the expert's 128
// columns are the m64 operand of two warpgroups and the sweep's 64 tokens
// the wgmma N dimension (a token tile of 128 measured slower at every
// shape tried), so a
// short group (tens of rows, often one) wastes little of a tile. One TMA
// map over the codes as (G N, K) rows reaches any expert's tile with no
// copy. Each supergroup's int32 sums start from zero and are folded by
// sg_corr in supergroup order; K is never split and no sums meet in
// atomics: a call repeats bit for bit. Only the expert's own tokens are
// stored (a token tile may hold the next expert's rows, which TMA loads
// but nobody stores); rows at or past sum(group_sizes) are never written.
//
// Kernel 9, fused: per live expert slot s < n_live (read on the device) and
// 64-row block of its capacity bucket, gate and up, the activation, bf16
// rounding, the per-(row, 256) requant of h by multiplying by 1/scale, then
// the down projection. Bound by the live experts' code bytes (some 4.7 MB an
// expert at Qwen3-30B-A3B's shape; the int8 work is an eighth of that time).
// The TPU kernel walks the live experts in order on one core; giving each
// one block left most SMs idle when few experts are live, which is the
// common case (8-66 of 128 a layer from the random-weights router). Here the
// work is cut into items of a persistent grid, one block an SM, dealt by a
// ticket counter: first the phase-1 items (slot, row block, 64 columns of
// FF: gate and up over the whole K, the activation rounded to bf16 into a
// scratch; the last of a 256-column group's four items, found by a counter a
// group, requantizes the group into an int8 scratch of G x R x FF that stays
// in L2), then the phase-2 items (slot, row block, 256 columns of E: the down
// projection over the whole FF in supergroup order), each waiting until its
// slot's FF/256 groups are requantized. A phase-2 item waits only on items
// already taken by running blocks that never wait, so one ordinary launch
// suffices. One producer warp takes the tickets and keeps a 4-stage ring of
// 128-byte-deep stages in flight by TMA (x, gate and up tiles, or down
// tiles, in the 128-byte swizzle) under mbarriers, running ahead into the
// next item while the 8 consumer warps finish one; the consumers run
// mma.sync m16n8k32 over 16 rows a tile (no padding past the bucket's next
// multiple of 16), the scales of a supergroup loaded into registers as its
// first stage is awaited. Every sum keeps the order of the plain version:
// an item changes who computes a column, not how. The counters are one
// zeroed int32 buffer a device that the last block to finish resets.
#include "hopper.cuh"
#include "moe_common.cuh"
#include "moe_grouped.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------- kernel 10 --
namespace grouped10 {

constexpr int TN = 128;          // expert columns of a sweep: two consumer warpgroups of 64
constexpr int TM = 64;           // tokens of a sweep: the wgmma N dimension
constexpr int BK = 128;          // K of a stage: one 128-byte swizzled row a tile row
constexpr int THREADS = 384;     // the producer warpgroup, then two consumer warpgroups
constexpr int STATIC_SMEM = (3 * MAXG + 2) * 4;   // the rows map (rows_map)

// A stage: the code tile [TN][BK], the token tile [TM][BK] and the
// supergroup's scales (xs of the TM tokens, then sw of the TN columns),
// as many stages as fit up to 8.
struct Layout {
  static constexpr int A = TN * BK, B = TM * BK;      // bytes of a stage's tiles
  static constexpr int SC = TM + TN;                  // floats of a stage's scales
  static constexpr int STAGE = A + B + SC * 4;
  static constexpr int FIT = (MOE_SMEM_MAX - STATIC_SMEM - 1024 - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// out^T = W^T x^T over the grouped sweeps of csrc/moe_grouped.cuh: the
// expert's TN columns are the wgmma A operand (two warpgroups of 64), the
// sweep's TM tokens its N dimension.
__global__ void __launch_bounds__(THREADS, 1)
ragged_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ xst, int s_sg, int s_m,
                       const float* __restrict__ sw, const int* __restrict__ gsz,
                       float* __restrict__ out, int M, int N, int K, int G) {
  using L = Layout;
  __shared__ int s_end[MAXG], s_live[MAXG], s_first[MAXG + 1], s_n;
  rows_map<TM>(gsz, G, M, s_end, s_live, s_first, &s_n);
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned stages: the swizzle pattern repeats every 8 rows
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* sa = reinterpret_cast<int8_t*>(base);                  // [STAGES][TN][BK]
  int8_t* sb = sa + L::STAGES * L::A;                             // [STAGES][TM][BK]
  float* ssc = reinterpret_cast<float*>(sb + L::STAGES * L::B);   // [STAGES][xs TM | sw TN]
  uint64_t* full = reinterpret_cast<uint64_t*>(ssc + L::STAGES * L::SC);
  uint64_t* empty = full + L::STAGES;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid & 31;
  const int nsg = K / MOE_SG, nkb = K / BK, tiles_n = (N + TN - 1) / TN;

  if (tid == 0) {
    // full: the producer lane 0's expect_tx arrive + the 32 lanes' cp.async
    // arrives; empty: the 8 consumer warps
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                 // the barriers and the rows map

  if (wg == 0) {
    // producer: one warp keeps the ring full, running on into the next sweep
    setmaxnreg_dec<40>();
    if (warp == 0) {
      int it = 0;
      grouped_sweeps<TM>(s_end, s_live, s_first, s_n, tiles_n, [&](int e, int m0, int, int tile) {
        const int n0 = tile * TN;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % L::STAGES;
          mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&full[s], L::A + L::B);
            tma_load_2d(sa + s * L::A, &map_w, &full[s], kb * BK, e * N + n0);
            tma_load_2d(sb + s * L::B, &map_x, &full[s], kb * BK, m0);
          }
          if ((kb & 1) == 0) {      // the supergroup's scales ride with its first half
            const int sg = kb >> 1;
            float* sc = ssc + s * L::SC;
            for (int r = lane; r < TM; r += 32)
              cp_async4(sc + r, xst + (size_t)sg * s_sg + (size_t)min(m0 + r, M - 1) * s_m);
            const float* swr = sw + ((size_t)e * nsg + sg) * N;
            for (int c = lane; c < TN; c += 32) cp_async4(sc + TM + c, swr + min(n0 + c, N - 1));
          }
          mbar_arrive_cp_async(&full[s]);
        }
      });
      cp_async_wait<0>();
    }
  } else {
    // consumers: warpgroup c owns expert columns 64c .. 64c + 63 of the
    // sweep's tile; the thread's A rows are columns xr and xr + 8
    setmaxnreg_inc<232>();
    constexpr int NR = TM / 2;          // accumulator registers a thread
    const int c = wg - 1, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int xr = c * 64 + w * 16 + g;
    int part[NR];
    float acc[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) part[i] = 0;
    int it = 0;
    grouped_sweeps<TM>(s_end, s_live, s_first, s_n, tiles_n, [&](int e, int m0, int m_end,
                                                                 int tile) {
      const int n0 = tile * TN;
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] = 0.f;
      for (int sg = 0; sg < nsg; ++sg, it += 2) {
        const int s0 = it % L::STAGES, s1 = (it + 1) % L::STAGES;
        mbar_wait(&full[s0], (it / L::STAGES) & 1);
        mbar_wait(&full[s1], ((it + 1) / L::STAGES) & 1);
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
            wgmma_s8<TM>(part, da + 2 * kk, db + 2 * kk, (h | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NR>(part);
        // acc + part * (xs[m, sg] * sw[e, sg, n]), rounded step by step
        // (sg_corr), supergroup by supergroup: the plain version's order
        const float* sc = ssc + s0 * L::SC;
        const float w0 = sc[TM + xr], w1 = sc[TM + xr + 8];
#pragma unroll
        for (int j = 0; j < TM / 8; ++j) {
          const float x0 = sc[8 * j + 2 * t], x1 = sc[8 * j + 2 * t + 1];
          acc[4 * j + 0] = sg_corr(acc[4 * j + 0], part[4 * j + 0], x0, w0);
          acc[4 * j + 1] = sg_corr(acc[4 * j + 1], part[4 * j + 1], x1, w0);
          acc[4 * j + 2] = sg_corr(acc[4 * j + 2], part[4 * j + 2], x0, w1);
          acc[4 * j + 3] = sg_corr(acc[4 * j + 3], part[4 * j + 3], x1, w1);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[s0]);
          mbar_arrive(&empty[s1]);
        }
      }
      // acc[4j + e]: column xr + 8 (e >> 1), token 8j + 2t + (e & 1); only
      // the expert's own tokens are stored
#pragma unroll
      for (int j = 0; j < TM / 8; ++j) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int m = m0 + 8 * j + 2 * t + p;
          if (m >= m_end) continue;
          float* o = out + (size_t)m * N + n0;
          if (n0 + xr < N) o[xr] = acc[4 * j + p];
          if (n0 + xr + 8 < N) o[xr + 8] = acc[4 * j + 2 + p];
        }
      }
    });
  }
}

// The two tensor maps (the tokens (M, K) and the codes as (G N, K) rows,
// both K-contiguous bytes in the 128-byte swizzle; rows past either read
// as zeros) and the launch.
cudaError_t launch(const void* xq, const float* xst, int s_sg, int s_m, const void* codes,
                   const float* sw, const int* gsz, float* out, int M, int N, int K, int G,
                   int blocks, cudaStream_t s) {
  using L = Layout;
  static_assert(L::STAGES >= 2 && L::BYTES + STATIC_SMEM <= MOE_SMEM_MAX,
                "shared memory of one block");
  auto kern = ragged_i8_wgmma_kernel;
  static bool smem_set = false;
  cudaError_t e = set_smem(kern, L::BYTES, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mw;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  if ((e = tensor_map_2d(&mx, xq, u8, K, M, K, BK, TM, sw128)) != cudaSuccess ||
      (e = tensor_map_2d(&mw, codes, u8, K, (uint64_t)G * N, K, BK, TN, sw128)) != cudaSuccess)
    return e;
  kern<<<blocks, THREADS, L::BYTES, s>>>(mx, mw, xst, s_sg, s_m, sw, gsz, out, M, N, K, G);
  return cudaGetLastError();
}

}  // namespace grouped10

// -------------------------------------------------------------- kernel 9 --
namespace fused9 {

constexpr int BK = 128;            // bytes of K a ring stage holds (two a supergroup)
constexpr int COLS = 256;          // E columns of a phase-2 item; FF columns of a requant group
constexpr int SWEEP = 64;          // FF columns of a phase-1 item
constexpr int NQ = COLS / SWEEP;   // phase-1 items of a requant group
constexpr int ROWS = 64;           // rows of a row block
constexpr int CONSUMERS = 256;     // 8 consumer warps
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int MAX_DEPTH = 4;         // deeper rings measured slower on the H100

// A ring stage: a phase-1 stage holds the gate tile [64][BK] at 0, the up
// tile at W1, the x tile [16 MI][BK] at 2 W1; a phase-2 stage the down tile
// [256][BK] at 0. Every tile is 1024-byte aligned (the swizzle repeats
// every 8 rows).
template <int MI>
struct Stage {
  static constexpr int W1 = SWEEP * BK;
  static constexpr int X = 16 * MI * BK;
  static constexpr int D = COLS * BK;
  static constexpr int BYTES = 2 * W1 + X > D ? 2 * W1 + X : D;
};

// The consumer warps' named barrier. bar.sync is the aligned form: a warp
// arrives as a whole, so a warp whose lanes diverged (thread 0 spinning on
// `ready`, or in its counter update) would let the barrier count it before
// thread 0 gets there. The compiler does not know the inline asm is a
// barrier and need not reconverge the warp first: __syncwarp() does.
IK_DEV void bar_consumers() {
  __syncwarp();
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

IK_DEV int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The cross-block hand-offs of kernel 9. Every consumer thread fences its
// own scratch writes before bar_consumers(); thread 0 then fences again
// after the barrier, so that the whole block's writes are ordered before
// its counter update at gpu scope (the barrier alone orders them at CTA
// scope only), and updates the counter with release (and, where the block
// reads what other blocks released, acquire) semantics.
IK_DEV int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
IK_DEV void red_add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// A consumer warp hands a ring stage back to the producer, whose next TMA
// load (the async proxy) overwrites it. The warp read the stage with plain
// shared-memory loads (the generic proxy), and the compiler leaves the last
// of them in flight when lane 0 arrives (their products are issued after
// the arrive): each lane orders its loads before the async writes with
// fence.proxy.async, then the warp arrives.
IK_DEV void release_stage(uint64_t* empty, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// The 16-byte chunk c of row r of a tile written by TMA in the 128-byte
// swizzle (rows of BK bytes): chunk c lands at c ^ (r % 8).
IK_DEV const int8_t* swz(const int8_t* tile, int r, int c) {
  return tile + r * BK + ((c ^ (r & 7)) << 4);
}

// Exact int32 products of one 128-byte stage for a warp: MI 16-row tiles of
// A (x from a swizzled tile, or int8 h from padded rows of `lda` bytes at
// column `acol`) against NT 8-column tiles of B (swizzled; b[j] is the
// tile's first row, a multiple of 8 rows from its 1024-byte aligned start).
template <int MI, int NT, bool SWZ_A>
IK_DEV void stage_mma(int (&part)[MI][NT][4], const int8_t* a, int lda, int acol,
                      const int8_t* const (&b)[NT], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    const int c0 = kk >> 4;
    uint32_t af[MI][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (SWZ_A) {
        const int r = i * 16 + g;
        af[i][0] = ld32(swz(a, r, c0) + 4 * t);
        af[i][1] = ld32(swz(a, r + 8, c0) + 4 * t);
        af[i][2] = ld32(swz(a, r, c0 + 1) + 4 * t);
        af[i][3] = ld32(swz(a, r + 8, c0 + 1) + 4 * t);
      } else {
        const int8_t* p = a + (i * 16 + g) * lda + acol + kk + 4 * t;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * lda);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * lda + 16);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bf[j][0] = ld32(swz(b[j], g, c0) + 4 * t);
      bf[j][1] = ld32(swz(b[j], g, c0 + 1) + 4 * t);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8_16832(part[i][j], af[i], bf[j]);
  }
}

template <int MI, int NT>
IK_DEV void zero_parts(int (&part)[MI][NT][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][j][q] = 0;
}

struct Args {
  const float* xst;                 // (G, K/256, R) through the strides below
  int st_g, st_sg, st_r;
  const int* eids;
  const int* n_live;
  const float* gsw;
  const float* usw;
  const float* dsw;
  __nv_bfloat16* hb;                // (G, R, FF) bf16 scratch: h before its requant
  int8_t* hq;                       // (G, R, FF) int8 scratch
  float* hs;                        // (G, R, FF/256) f32 scratch
  int* counters;                    // [ticket, done, ready [G][nrb], groups [G][nrb][FF/256]]
  float* out;                       // (G, R, E)
  int G, R, K, F, E, act, depth;
  float limit;
};

// A work item as the producer hands it to the consumers: kind 0 = no more
// work, 1 = (slot, row block, FF supergroup idx / NQ, its 64 columns idx % NQ),
// 2 = (slot, row block, E tile idx).
struct Item {
  int kind, e, slot, rb, idx;
};

template <int MI>
__global__ void __launch_bounds__(THREADS, 1)
fused_prefill_i8_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_g,
                        const __grid_constant__ CUtensorMap map_u,
                        const __grid_constant__ CUtensorMap map_d, const Args a) {
  using S = Stage<MI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* ring = reinterpret_cast<int8_t*>(base);                  // [depth][S::BYTES]
  int8_t* region = ring + a.depth * S::BYTES;                       // int8 h rows [16 MI][ldh]
  const int ldh = a.F + 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(region + 16 * MI * ldh);
  uint64_t* empty = full + MAX_DEPTH;
  uint64_t* qfull = empty + MAX_DEPTH;
  uint64_t* qempty = qfull + 2;
  Item* queue = reinterpret_cast<Item*>(qempty + 2);               // [2]
  int* flag = reinterpret_cast<int*>(queue + 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nsg = a.K / MOE_SG, nsgf = a.F / MOE_SG, nkb = a.K / BK;
  const int nrb = (a.R + ROWS - 1) / ROWS, n_et = (a.E + COLS - 1) / COLS;
  int* ticket = a.counters;
  int* done = a.counters + 1;
  int* ready = a.counters + 2;                                      // [G][nrb]
  int* groups = ready + a.G * nrb;                                  // [G][nrb][nsgf]

  if (tid == 0) {
    for (int s = 0; s < MAX_DEPTH; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&qfull[q], 1);
      mbar_init(&qempty[q], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: tickets in order, every stage of an item by TMA ----
    if (lane == 0) {
      const int nl = *a.n_live;
      const int per1 = nrb * nsgf * NQ, per2 = nrb * n_et;
      const int total1 = nl * per1, total2 = nl * per2;
      int it = 0;
      for (int n = 0;; ++n) {
        const int qs = n & 1;
        if (n >= 2) mbar_wait(&qempty[qs], ((n >> 1) - 1) & 1);
        const int tk = atomicAdd(ticket, 1);
        Item item{0, 0, 0, 0, 0};
        if (tk < total1) {
          item = {1, 0, tk / per1, tk % per1 / (nsgf * NQ), tk % (nsgf * NQ)};
        } else if (tk - total1 < total2) {
          const int t2 = tk - total1;
          item = {2, 0, t2 / per2, t2 % per2 / n_et, t2 % n_et};
        }
        if (item.kind) item.e = __ldg(a.eids + item.slot);
        queue[qs] = item;
        mbar_arrive(&qfull[qs]);
        if (!item.kind) break;
        const int e = item.e;
        if (item.kind == 1) {
          const int rows_x = e * a.R + item.rb * ROWS, rows_w = e * a.F + item.idx * SWEEP;
          for (int kb = 0; kb < nkb; ++kb, ++it) {
            const int s = it % a.depth;
            mbar_wait(&empty[s], ((it / a.depth) & 1) ^ 1);
            int8_t* dst = ring + s * S::BYTES;
            mbar_expect_tx(&full[s], 2 * S::W1 + S::X);
            tma_load_2d(dst, &map_g, &full[s], kb * BK, rows_w);
            tma_load_2d(dst + S::W1, &map_u, &full[s], kb * BK, rows_w);
            tma_load_2d(dst + 2 * S::W1, &map_x, &full[s], kb * BK, rows_x);
          }
        } else {
          const int rows_d = e * a.E + item.idx * COLS;
          for (int st = 0; st < a.F / BK; ++st, ++it) {
            const int s = it % a.depth;
            mbar_wait(&empty[s], ((it / a.depth) & 1) ^ 1);
            mbar_expect_tx(&full[s], S::D);
            tma_load_2d(ring + s * S::BYTES, &map_d, &full[s], st * BK, rows_d);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: warp w owns 8 columns of a phase-1 item's 64 (gate and
    // up) or 32 of a phase-2 item's 256; every warp all 16 MI rows ----
    const int w = warp, g = lane >> 2, t = lane & 3;
    int it = 0;
    for (int n = 0;; ++n) {
      const int qs = n & 1;
      mbar_wait(&qfull[qs], (n >> 1) & 1);
      const Item item = queue[qs];
      __syncwarp();
      if (lane == 0) mbar_arrive(&qempty[qs]);
      if (!item.kind) break;
      const int e = item.e, r0 = item.rb * ROWS, rv = min(ROWS, a.R - r0);
      const size_t erow = (size_t)e * a.R + r0;        // the row block's first row
      bar_consumers();                                  // the last item is done with flag, region
      if (item.kind == 1) {
        // phase 1: gate and up of 64 FF columns, one K sweep
        const int fs = item.idx / NQ, c_w = item.idx * SWEEP + w * 8;   // the warp's first column
        float ag[MI][4], au[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) ag[i][q] = au[i][q] = 0.0f;
        int part[MI][2][4];
        for (int sg = 0; sg < nsg; ++sg) {
          // this supergroup's scales, in flight while its stages are awaited
          float xs[MI][2], gs[2], us[2];
          const float* xsb = a.xst + (size_t)e * a.st_g + (size_t)sg * a.st_sg;
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              xs[i][h] = __ldg(xsb + (size_t)(r0 + min(i * 16 + g + 8 * h, rv - 1)) * a.st_r);
          const size_t sc = ((size_t)e * nsg + sg) * a.F + c_w + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            gs[h] = __ldg(a.gsw + sc + h);
            us[h] = __ldg(a.usw + sc + h);
          }
          zero_parts<MI, 2>(part);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2, ++it) {      // the supergroup's two stages
            const int s = it % a.depth;
            mbar_wait(&full[s], (it / a.depth) & 1);
            const int8_t* st = ring + s * S::BYTES;
            const int8_t* const b[2] = {st + (w * 8) * BK, st + S::W1 + (w * 8) * BK};
            stage_mma<MI, 2, true>(part, st + 2 * S::W1, BK, 0, b, lane);
            release_stage(&empty[s], lane);
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ag[i][q] = sg_corr(ag[i][q], part[i][0][q], xs[i][q >> 1], gs[q & 1]);
              au[i][q] = sg_corr(au[i][q], part[i][1][q], xs[i][q >> 1], us[q & 1]);
            }
        }
        // the activation, rounded to bf16, into the bf16 scratch
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = i * 16 + g + 8 * h;
            if (row >= rv) continue;
            *reinterpret_cast<uint32_t*>(a.hb + (erow + row) * a.F + c_w + 2 * t) =
                pack_bf16x2(moe_act(ag[i][2 * h], au[i][2 * h], a.act, a.limit),
                            moe_act(ag[i][2 * h + 1], au[i][2 * h + 1], a.act, a.limit));
          }
        __threadfence();
        bar_consumers();
        int* grp = groups + (item.slot * nrb + item.rb) * nsgf + fs;
        if (tid == 0) {
          __threadfence();
          *flag = atom_add_acq_rel(grp, 1) == NQ - 1;
          __threadfence();
        }
        bar_consumers();
        if (*flag) {
          // the last of the group's items: requantize each row's 256 values by 1/scale
          __threadfence();
          for (int row = w; row < rv; row += CONSUMERS / 32) {
            const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
                a.hb + (erow + row) * a.F + fs * COLS + lane * 8));
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
            const float sc = amax / 127.0f;
            const float inv = sc > 0.0f ? 1.0f / sc : 0.0f;
            uint32_t packed[2] = {0u, 0u};
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int cq = max(-127, min(127, __float2int_rn(fmul(v[q], inv))));
              packed[q >> 2] |= static_cast<uint32_t>(cq & 0xff) << (8 * (q & 3));
            }
            *reinterpret_cast<uint2*>(a.hq + (erow + row) * a.F + fs * COLS + lane * 8) =
                make_uint2(packed[0], packed[1]);
            if (lane == 0) a.hs[(erow + row) * nsgf + fs] = sc;
          }
          __threadfence();
          bar_consumers();
          if (tid == 0) {
            __threadfence();
            red_add_release(&ready[item.slot * nrb + item.rb], 1);
          }
        }
      } else {
        // phase 2: wait for the slot's h, stage its int8 rows, the down sweep
        if (tid == 0) {
          while (ld_acquire(&ready[item.slot * nrb + item.rb]) < nsgf) __nanosleep(128);
          __threadfence();
        }
        bar_consumers();
        const int cpr = a.F / 16;
        for (int c = tid; c < rv * cpr; c += CONSUMERS) {   // every copy in flight at once
          const int row = c / cpr, ch = c % cpr;
          cp_async16(region + row * ldh + ch * 16, a.hq + (erow + row) * a.F + ch * 16);
        }
        cp_async_commit();
        cp_async_wait<0>();
        bar_consumers();
        int part[MI][4][4];
        float ad[MI][4][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) ad[i][j][q] = 0.0f;
        const int c_w = item.idx * COLS + w * 32;
        for (int sg = 0; sg < nsgf; ++sg) {
          float hsv[MI][2], ds[4][2];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              hsv[i][h] = __ldcg(a.hs + (erow + min(i * 16 + g + 8 * h, rv - 1)) * nsgf + sg);
          const float* dsb = a.dsw + ((size_t)e * nsgf + sg) * a.E;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) ds[j][h] = __ldg(dsb + min(c_w + 8 * j + 2 * t + h, a.E - 1));
          zero_parts<MI, 4>(part);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2, ++it) {
            const int s = it % a.depth;
            mbar_wait(&full[s], (it / a.depth) & 1);
            const int8_t* st = ring + s * S::BYTES + (w * 32) * BK;
            const int8_t* const b[4] = {st, st + 8 * BK, st + 16 * BK, st + 24 * BK};
            stage_mma<MI, 4, false>(part, region, ldh, (2 * sg + h2) * BK, b, lane);
            release_stage(&empty[s], lane);
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                ad[i][j][q] = sg_corr(ad[i][j][q], part[i][j][q], hsv[i][q >> 1], ds[j][q & 1]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = i * 16 + g + 8 * h, col = c_w + 8 * j + 2 * t;
              if (row >= rv) continue;
              float* o = a.out + (erow + row) * a.E + col;
              if (col + 1 < a.E && (a.E & 1) == 0) {
                *reinterpret_cast<float2*>(o) = make_float2(ad[i][j][2 * h], ad[i][j][2 * h + 1]);
              } else {
                if (col < a.E) o[0] = ad[i][j][2 * h];
                if (col + 1 < a.E) o[1] = ad[i][j][2 * h + 1];
              }
            }
      }
    }
  }

  // the last block to finish leaves the counters zero for the next call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atom_add_acq_rel(done, 1) == (int)gridDim.x - 1) {
      __threadfence();
      for (int i = 0; i < a.G * nrb * (1 + nsgf); ++i) ready[i] = 0;
      *ticket = 0;
      *done = 0;
      __threadfence();
    }
  }
}

// Dynamic shared memory of a block (ops/moe_qmm.py:fused_prefill_plan).
int smem_bytes(int mi, int F, int depth) {
  const int stage = max(2 * SWEEP * BK + 16 * mi * BK, COLS * BK);
  return 1024 + depth * stage + 16 * mi * (F + 16) + (2 * MAX_DEPTH + 4) * 8 +
         2 * (int)sizeof(Item) + 16;
}

template <int MI>
cudaError_t launch(const void* xg, const void* gate, const void* up, const void* down,
                   const Args& a, int blocks, cudaStream_t stream) {
  const int smem = smem_bytes(MI, a.F, a.depth);
  if (smem > MOE_SMEM_MAX) return cudaErrorInvalidValue;
  static bool smem_set = false;
  auto kern = fused_prefill_i8_kernel<MI>;
  cudaError_t e = set_smem(kern, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mg, mu, md;
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if ((e = tensor_map_2d(&mx, xg, u8, a.K, (uint64_t)a.G * a.R, a.K, BK, 16 * MI, sw)) != cudaSuccess ||
      (e = tensor_map_2d(&mg, gate, u8, a.K, (uint64_t)a.G * a.F, a.K, BK, SWEEP, sw)) != cudaSuccess ||
      (e = tensor_map_2d(&mu, up, u8, a.K, (uint64_t)a.G * a.F, a.K, BK, SWEEP, sw)) != cudaSuccess ||
      (e = tensor_map_2d(&md, down, u8, a.F, (uint64_t)a.G * a.E, a.F, BK, COLS, sw)) != cudaSuccess)
    return e;
  kern<<<blocks, THREADS, smem, stream>>>(mx, mg, mu, md, a);
  return cudaGetLastError();
}

}  // namespace fused9

}  // namespace

// K % 256 == 0, M >= 1, 1 <= G <= 1024; blocks (the persistent grid) from
// ops/moe_qmm.ragged_i8_plan.
extern "C" int ik_ragged_qmatmul_i8(const void* xq, const void* xst, int s_sg, int s_m,
                                    const void* codes, const void* sw, const void* gsz,
                                    void* out, int M, int N, int K, int G, int blocks,
                                    void* stream) {
  if (K % MOE_SG || K < MOE_SG || M < 1 || N < 1 || G < 1 || G > MAXG || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto x = static_cast<const float*>(xst);
  auto w = static_cast<const float*>(sw);
  auto gs = static_cast<const int*>(gsz);
  auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      grouped10::launch(xq, x, s_sg, s_m, codes, w, gs, o, M, N, K, G, blocks, s));
}

// R % 8 == 0, K and F multiples of 256; hb a bf16 (G, R, F), hq an int8
// (G, R, F) and hs an f32 (G, R, F/256) scratch; counters 2 + G *
// ceil(R/64) * (1 + F/256) zeroed int32 (left zero); mi = ceil(min(R, 64) /
// 16), depth and blocks from the plan.
extern "C" int ik_fused_moe_prefill_i8(const void* xg, const void* xst, int st_g, int st_sg,
                                       int st_r, const void* eids, const void* n_live,
                                       const void* gate, const void* gsw, const void* up,
                                       const void* usw, const void* down, const void* dsw,
                                       void* hb, void* hq, void* hs, void* counters, void* out, int G,
                                       int R, int K, int F, int E, int act, float limit, int mi,
                                       int depth, int blocks, void* stream) {
  if (K % MOE_SG || F % MOE_SG || R % 8 || R < 8 || depth < 2 || depth > fused9::MAX_DEPTH ||
      mi != (R < 64 ? (R + 15) / 16 : 4) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  fused9::Args a{static_cast<const float*>(xst), st_g, st_sg, st_r,
                 static_cast<const int*>(eids), static_cast<const int*>(n_live),
                 static_cast<const float*>(gsw), static_cast<const float*>(usw),
                 static_cast<const float*>(dsw), static_cast<__nv_bfloat16*>(hb),
                 static_cast<int8_t*>(hq),
                 static_cast<float*>(hs), static_cast<int*>(counters), static_cast<float*>(out),
                 G, R, K, F, E, act, depth, limit};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (mi) {
    case 1: e = fused9::launch<1>(xg, gate, up, down, a, blocks, s); break;
    case 2: e = fused9::launch<2>(xg, gate, up, down, a, blocks, s); break;
    case 3: e = fused9::launch<3>(xg, gate, up, down, a, blocks, s); break;
    default: e = fused9::launch<4>(xg, gate, up, down, a, blocks, s); break;
  }
  return static_cast<int>(e);
}
