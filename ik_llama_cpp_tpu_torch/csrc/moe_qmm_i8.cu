// MoE prefill over int8 supergroup-256 experts: the grouped (ragged) int8
// GEMM (kernel 10) and the capacity-bucketed whole-FFN kernel (kernel 9).
//
// Replaces ik_llama_cpp_tpu/ops/moe_qmm.py:ragged_qmatmul_i8 and
// :fused_moe_prefill_i8 (the Pallas kernels of the MoE prefill).
//
// Codes are stored (G, N, K) so that both mma.sync operands are
// K-contiguous; activation scales are read through strides (the JAX layout
// keeps them transposed). Every 256-deep supergroup's int32 products are
// exact; its float correction part * (sx * sw) is added in supergroup order
// with no contraction into FMA, the order and rounding of the plain
// versions.
//
// Kernel 10, ragged: out[m, n] = sum_g xs[m, g] sw[e(m), g, n] dot_g(xq[m], w[e(m), n])
// with e(m) the group that owns sorted row m. Bound by int8 tensor-core work
// for long groups and by the expert bytes for short ones. The grid is
// (N tiles, row tiles) from M alone; each block prefix-sums group_sizes in
// shared memory, skips out when its rows are past the last group (so an
// empty overflow pass costs one launch and no host sync), and runs one K
// sweep per group that owns some of its rows, storing only those rows.
// Rows at or past sum(group_sizes) are never written.
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
#include "moe_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int LDS = MOE_SG + 16;   // padded shared row: conflict-free fragment loads
constexpr int NT = 256;            // threads a block (8 warps)
constexpr int TILE = 64;           // rows / columns of a staged tile
constexpr int MAXG = 1024;         // groups the ragged kernel's prefix sum holds
constexpr unsigned FULL = 0xffffffffu;

// cp.async of `rows` rows x 256 bytes from src (row stride ld bytes) into a
// padded tile; rows at or past `valid` repeat row valid - 1.
IK_DEV void stage_rows(int8_t* dst, const int8_t* src, size_t ld, int rows, int valid, int tid) {
  for (int c = tid; c < rows * 16; c += NT) {
    const int r = c >> 4, col = (c & 15) * 16;
    cp_async16(dst + r * LDS + col, src + (size_t)min(r, valid - 1) * ld + col);
  }
}

// Exact int32 products of one 256-deep stage for a warp's MI x NI tiles of
// 16 x 8: a is the warp's first A row (lda bytes a row), b its first B row
// (one row per output column, ldb bytes a row).
template <int MI, int NI>
IK_DEV void mma_stage(int (&part)[MI][NI][4], const int8_t* a, int lda,
                      const int8_t* b, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < MOE_SG; kk += 32) {
    uint32_t af[MI][4], bf[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int8_t* p = a + (i * 16 + g) * lda + kk + t * 4;
      af[i][0] = ld32(p);
      af[i][1] = ld32(p + 8 * lda);
      af[i][2] = ld32(p + 16);
      af[i][3] = ld32(p + 8 * lda + 16);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int8_t* p = b + (j * 8 + g) * ldb + kk + t * 4;
      bf[j][0] = ld32(p);
      bf[j][1] = ld32(p + 16);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8_16832(part[i][j], af[i], bf[j]);
  }
}

// ------------------------------------------------------------- kernel 10 --
// 64 x 64 tiles, warps 2 (rows) x 4 (columns) of 32 x 16.
__global__ void __launch_bounds__(NT)
ragged_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xst, int s_sg,
              int s_m, const int8_t* __restrict__ codes, const float* __restrict__ sw,
              const int* __restrict__ gsz, float* __restrict__ out, int M, int N, int K,
              int G) {
  extern __shared__ __align__(16) int8_t smem[];   // [2][A 64 rows, B 64 rows][LDS]
  __shared__ int s_end[MAXG];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int nsg = K / MOE_SG;
  for (int i = tid; i < G; i += NT) s_end[i] = gsz[i];
  __syncthreads();
  if (tid == 0)
    for (int i = 1; i < G; ++i) s_end[i] += s_end[i - 1];
  __syncthreads();
  const int rows_end = min(s_end[G - 1], M);
  if (m0 >= rows_end) return;
  const int m1 = min(m0 + TILE, rows_end);
  int grp = 0;
  while (s_end[grp] <= m0) ++grp;

  for (; grp < G; ++grp) {
    const int start = grp ? s_end[grp - 1] : 0, end = s_end[grp];
    if (start >= m1) break;
    if (end == start) continue;
    const int lo = max(start, m0), hi = min(end, m1);
    const int8_t* bsrc = codes + ((size_t)grp * N + n0) * K;
    const float* swg = sw + (size_t)grp * nsg * N;
    auto load = [&](int slot, int s) {
      int8_t* st = smem + slot * 2 * TILE * LDS;
      stage_rows(st, xq + (size_t)m0 * K + s * MOE_SG, K, TILE, M - m0, tid);
      stage_rows(st + TILE * LDS, bsrc + s * MOE_SG, K, TILE, N - n0, tid);
    };
    float acc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    load(0, 0);
    cp_async_commit();
    for (int s = 0; s < nsg; ++s) {
      if (s + 1 < nsg) {
        load((s + 1) & 1, s + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* st = smem + (s & 1) * 2 * TILE * LDS;
      int part[2][2][4];
      mma_stage<2, 2>(part, st + wm * LDS, LDS, st + (TILE + wn) * LDS, LDS, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = min(m0 + wm + i * 16 + g8, M - 1), r1 = min(r0 + 8, M - 1);
        const float xs0 = xst[(size_t)s * s_sg + (size_t)r0 * s_m];
        const float xs1 = xst[(size_t)s * s_sg + (size_t)r1 * s_m];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c0 = min(n0 + wn + j * 8 + 2 * t4, N - 1), c1 = min(c0 + 1, N - 1);
          const float sw0 = swg[(size_t)s * N + c0], sw1 = swg[(size_t)s * N + c1];
          acc[i][j][0] = sg_corr(acc[i][j][0], part[i][j][0], xs0, sw0);
          acc[i][j][1] = sg_corr(acc[i][j][1], part[i][j][1], xs0, sw1);
          acc[i][j][2] = sg_corr(acc[i][j][2], part[i][j][2], xs1, sw0);
          acc[i][j][3] = sg_corr(acc[i][j][3], part[i][j][3], xs1, sw1);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + wn + j * 8 + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + wm + i * 16 + g8 + h * 8;
          if (r < lo || r >= hi) continue;
          if (c < N) out[(size_t)r * N + c] = acc[i][j][2 * h];
          if (c + 1 < N) out[(size_t)r * N + c + 1] = acc[i][j][2 * h + 1];
        }
      }
  }
}

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

IK_DEV void bar_consumers() { asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory"); }

IK_DEV int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
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
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
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
        if (tid == 0) *flag = atomicAdd(grp, 1) == NQ - 1;
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
          if (tid == 0) atomicAdd(&ready[item.slot * nrb + item.rb], 1);
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
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
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
    if (atomicAdd(done, 1) == (int)gridDim.x - 1) {
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

extern "C" int ik_ragged_qmatmul_i8(const void* xq, const void* xst, int s_sg, int s_m,
                                    const void* codes, const void* sw, const void* gsz,
                                    void* out, int M, int N, int K, int G, void* stream) {
  // the prefix sum's static shared memory counts against the same limit,
  // so the dynamic limit is exactly what the tiles need
  constexpr int smem = 2 * 2 * TILE * LDS;
  static bool smem_set = false;
  cudaError_t e = set_smem(ragged_kernel, smem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  ragged_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xst), s_sg, s_m,
      static_cast<const int8_t*>(codes), static_cast<const float*>(sw),
      static_cast<const int*>(gsz), static_cast<float*>(out), M, N, K, G);
  return static_cast<int>(cudaGetLastError());
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
