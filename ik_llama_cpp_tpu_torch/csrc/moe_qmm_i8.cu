// MoE prefill over int8 supergroup-256 experts: the grouped (ragged) int8
// GEMM (kernel 10) and the capacity-bucketed whole-FFN kernel (kernel 9).
//
// Replaces ik_llama_cpp_tpu/ops/moe_qmm.py:ragged_qmatmul_i8 and
// :fused_moe_prefill_i8 (the Pallas kernels of the MoE prefill).
//
// Codes are stored (G, N, K) so that both mma.sync operands are
// K-contiguous; activation scales are read through strides (the JAX layout
// keeps them transposed). Every 256-deep supergroup is one pipeline stage
// whose int32 products are exact; its float correction part * (sx * sw) is
// added in supergroup order with no contraction into FMA, the order and
// rounding of the plain versions.
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
// 64-row block of its capacity bucket, gate and up (2 x 64-column tiles per
// K sweep), the activation, bf16 rounding, the per-(row, 256) requant of h
// by multiplying by 1/scale, then the down projection. Bound by the live
// experts' code bytes. The TPU's sequential grid over n_live becomes a grid
// over (slot, row block) whose blocks share nothing; the int8 h (64 x FF)
// stays in shared memory between the two halves (50 KB at FF 768). A
// cp.async double buffer keeps the next 256-deep tile in flight. wgmma, TMA
// and splitting an expert over several SMs are later work.
#include "moe_common.cuh"

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
// 64-row blocks; 64-column tiles; warps 4 (rows) x 2 (columns) of 16 x 32.
__global__ void __launch_bounds__(NT)
fused_kernel(const int8_t* __restrict__ xg, const float* __restrict__ xst, int st_g,
             int st_sg, int st_r, const int* __restrict__ eids,
             const int* __restrict__ n_live, const int8_t* __restrict__ gate,
             const float* __restrict__ gsw, const int8_t* __restrict__ up,
             const float* __restrict__ usw, const int8_t* __restrict__ down,
             const float* __restrict__ dsw, float* __restrict__ out, int R, int K, int F,
             int E, int act, float limit) {
  const int slot = blockIdx.x;
  if (slot >= *n_live) return;
  const int e = eids[slot];
  const int r0 = blockIdx.y * TILE, rv = min(TILE, R - r0);
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* stages = smem;                                     // [2][x, gate, up][64][LDS]
  __nv_bfloat16* hslab = reinterpret_cast<__nv_bfloat16*>(smem + 2 * 3 * TILE * LDS);
  int8_t* hq = reinterpret_cast<int8_t*>(hslab + TILE * MOE_SG);   // [64][F + 16]
  const int ldh = F + 16;
  float* hs = reinterpret_cast<float*>(hq + (size_t)TILE * ldh);   // [64][F / 256]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  const int nsg_k = K / MOE_SG, nsg_f = F / MOE_SG;
  const int ra = min(wm + g8, rv - 1), rb = min(wm + g8 + 8, rv - 1);   // scale rows
  const int8_t* xb = xg + ((size_t)e * R + r0) * K;
  const float* xsb = xst + (size_t)e * st_g + (size_t)r0 * st_r;
  const size_t eF = (size_t)e * F;

  // phase 1: gate and up over 64-column tiles of FF, one K sweep each
  const int n1 = (F / TILE) * nsg_k;
  auto load1 = [&](int buf, int it) {
    const int nt = it / nsg_k, s = it % nsg_k;
    int8_t* st = stages + buf * 3 * TILE * LDS;
    stage_rows(st, xb + s * MOE_SG, K, TILE, rv, tid);
    stage_rows(st + TILE * LDS, gate + (eF + nt * TILE) * K + s * MOE_SG, K, TILE, TILE, tid);
    stage_rows(st + 2 * TILE * LDS, up + (eF + nt * TILE) * K + s * MOE_SG, K, TILE, TILE, tid);
  };
  float ag[4][4], au[4][4];
  load1(0, 0);
  cp_async_commit();
  for (int it = 0; it < n1; ++it) {
    const int nt = it / nsg_k, s = it % nsg_k;
    if (it + 1 < n1) {
      load1((it + 1) & 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) ag[j][q] = au[j][q] = 0.0f;
    }
    const int8_t* st = stages + (it & 1) * 3 * TILE * LDS;
    int pg[1][4][4], pu[1][4][4];
    mma_stage<1, 4>(pg, st + wm * LDS, LDS, st + (TILE + wn) * LDS, LDS, lane);
    mma_stage<1, 4>(pu, st + wm * LDS, LDS, st + (2 * TILE + wn) * LDS, LDS, lane);
    const float xs0 = xsb[(size_t)s * st_sg + (size_t)ra * st_r];
    const float xs1 = xsb[(size_t)s * st_sg + (size_t)rb * st_r];
    const float* gs = gsw + ((size_t)e * nsg_k + s) * F;
    const float* us = usw + ((size_t)e * nsg_k + s) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = nt * TILE + wn + j * 8 + 2 * t4;
      ag[j][0] = sg_corr(ag[j][0], pg[0][j][0], xs0, gs[c]);
      ag[j][1] = sg_corr(ag[j][1], pg[0][j][1], xs0, gs[c + 1]);
      ag[j][2] = sg_corr(ag[j][2], pg[0][j][2], xs1, gs[c]);
      ag[j][3] = sg_corr(ag[j][3], pg[0][j][3], xs1, gs[c + 1]);
      au[j][0] = sg_corr(au[j][0], pu[0][j][0], xs0, us[c]);
      au[j][1] = sg_corr(au[j][1], pu[0][j][1], xs0, us[c + 1]);
      au[j][2] = sg_corr(au[j][2], pu[0][j][2], xs1, us[c]);
      au[j][3] = sg_corr(au[j][3], pu[0][j][3], xs1, us[c + 1]);
    }
    if (s == nsg_k - 1) {
      // activation, rounded to bf16, into the slab of this tile's FF supergroup
      const int cb = (nt % (MOE_SG / TILE)) * TILE + wn;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = wm + g8 + (q >> 1) * 8, col = cb + j * 8 + 2 * t4 + (q & 1);
          hslab[row * MOE_SG + col] = __float2bfloat16_rn(moe_act(ag[j][q], au[j][q], act, limit));
        }
      if (nt % (MOE_SG / TILE) == MOE_SG / TILE - 1) {
        // the slab is complete: requantize each row's 256 values by 1/scale
        __syncthreads();
        const int fs = nt / (MOE_SG / TILE);
        for (int row = warp; row < TILE; row += NT / 32) {
          float v[8], amax = 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            v[q] = __bfloat162float(hslab[row * MOE_SG + lane * 8 + q]);
            amax = fmaxf(amax, fabsf(v[q]));
          }
#pragma unroll
          for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
          const float sc = amax / 127.0f;
          const float inv = sc > 0.0f ? 1.0f / sc : 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            hq[row * ldh + fs * MOE_SG + lane * 8 + q] =
                static_cast<int8_t>(max(-127, min(127, __float2int_rn(fmul(v[q], inv)))));
          if (lane == 0) hs[row * nsg_f + fs] = sc;
        }
      }
    }
    __syncthreads();
  }

  // phase 2: down over 64-column tiles of E, one FF sweep each, A = int8 h
  const int8_t* dsrc = down + (size_t)e * E * F;
  const int n2 = ((E + TILE - 1) / TILE) * nsg_f;
  auto load2 = [&](int buf, int it) {
    const int et = it / nsg_f, s = it % nsg_f;
    stage_rows(stages + buf * 3 * TILE * LDS, dsrc + (size_t)et * TILE * F + s * MOE_SG, F,
               TILE, E - et * TILE, tid);
  };
  float ad[4][4];
  load2(0, 0);
  cp_async_commit();
  for (int it = 0; it < n2; ++it) {
    const int et = it / nsg_f, s = it % nsg_f;
    if (it + 1 < n2) {
      load2((it + 1) & 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) ad[j][q] = 0.0f;
    }
    int pd[1][4][4];
    mma_stage<1, 4>(pd, hq + wm * ldh + s * MOE_SG, ldh,
                    stages + (it & 1) * 3 * TILE * LDS + wn * LDS, LDS, lane);
    const float hs0 = hs[(wm + g8) * nsg_f + s], hs1 = hs[(wm + g8 + 8) * nsg_f + s];
    const float* ds = dsw + ((size_t)e * nsg_f + s) * E;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c0 = min(et * TILE + wn + j * 8 + 2 * t4, E - 1), c1 = min(c0 + 1, E - 1);
      ad[j][0] = sg_corr(ad[j][0], pd[0][j][0], hs0, ds[c0]);
      ad[j][1] = sg_corr(ad[j][1], pd[0][j][1], hs0, ds[c1]);
      ad[j][2] = sg_corr(ad[j][2], pd[0][j][2], hs1, ds[c0]);
      ad[j][3] = sg_corr(ad[j][3], pd[0][j][3], hs1, ds[c1]);
    }
    if (s == nsg_f - 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = wm + g8 + (q >> 1) * 8, col = et * TILE + wn + j * 8 + 2 * t4 + (q & 1);
          if (row < rv && col < E) out[((size_t)e * R + r0 + row) * E + col] = ad[j][q];
        }
    }
    __syncthreads();
  }
}

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

extern "C" int ik_fused_moe_prefill_i8(const void* xg, const void* xst, int st_g, int st_sg,
                                       int st_r, const void* eids, const void* n_live,
                                       const void* gate, const void* gsw, const void* up,
                                       const void* usw, const void* down, const void* dsw,
                                       void* out, int G, int R, int K, int F, int E, int act,
                                       float limit, void* stream) {
  static bool smem_set = false;
  cudaError_t e = set_smem(fused_kernel, MOE_SMEM_MAX, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = 2 * 3 * TILE * LDS + TILE * MOE_SG * 2 + TILE * (F + 16) +
                   TILE * (F / MOE_SG) * 4;
  if (smem > MOE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(G, (R + TILE - 1) / TILE);
  fused_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xg), static_cast<const float*>(xst), st_g, st_sg, st_r,
      static_cast<const int*>(eids), static_cast<const int*>(n_live),
      static_cast<const int8_t*>(gate), static_cast<const float*>(gsw),
      static_cast<const int8_t*>(up), static_cast<const float*>(usw),
      static_cast<const int8_t*>(down), static_cast<const float*>(dsw),
      static_cast<float*>(out), R, K, F, E, act, limit);
  return static_cast<int>(cudaGetLastError());
}
