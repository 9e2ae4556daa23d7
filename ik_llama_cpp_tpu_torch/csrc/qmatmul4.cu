// 4-bit packed dequant x matmul.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul4 (Pallas, _make_kernel4).
//
//   out = x @ W,  W[k, n] = bf16(bf16(value(idx[k, n])) * scale[k/G, n]) (+ bias[k/G, n] in bf16)
//
// x: bf16 (M, K) row-major; packed: uint8 (K/2, N), byte i of a column holds
// the 4-bit indices of K rows 2i (low nibble) and 2i + 1 (high nibble);
// value(idx) = lut[idx] with a 16-entry codebook, or idx - 8 without one;
// scale, bias: bf16 (K/G, N), G even; out: f32 (M, N). Any M, N and even K
// with K % G == 0. The dequant chain runs in bf16 with float sums, which is
// qmatmul4_ref's numerics contract.
//
// Three kernels; the wrapper's plans (ops/qmatmul.gemv4_plan, tiled_plan)
// pick one before the launch.
//
// M <= 16, group % 16 == 0 and K a whole number of lcm(G, 32)-row units:
// qmatmul4_gemv_kernel (decode). Bound on the H100 by the weight bytes:
// half a byte a weight plus 2/G of a bf16 scale (M=1 K=4096 N=28672:
// 0.0198 ms at 3.35 TB/s). The design is qmatmul.cu's GEMV (kernel D):
// every packed byte is read once in 16-byte loads (16 columns of one packed
// row), two steps of 32 K rows in flight a warp in registers and no barrier
// in the K sweep; a block's 4 warps share 128 output columns, each with its
// own range of whole units of K, and the blocks of a thread-block cluster
// (the K split, 1-8; gemv4_plan, D's rule) take further ranges; partial
// sums are added in a fixed order, the warps of a block through shared
// memory and the blocks of a cluster through distributed shared memory, so
// a call repeats bit for bit. The product is mma.sync.m16n8k16 with the
// dequantized weights as the A operand (16 columns x 16 k), built in
// registers: a packed byte is the k pair (2i, 2i + 1) of one column,
// exactly one bf16x2 fragment register. Lane (g, t) loads packed rows 4t ..
// 4t + 3 of a step (K rows 8t .. 8t + 7); for the step's mma h (0, 1) its
// k slots (2t, 2t+1) are packed row 4t + 2h and (2t+8, 2t+9) packed row
// 4t + 2h + 1, and x is loaded to match (one 16-byte load of K rows 8t ..
// 8t + 7 feeds both).
//
// The unpack without a codebook is in place: the low and high nibbles of a
// word are masked and 0x43 bytes ORed in beside them (one shift and four
// three-input logic ops a word), one byte permute a byte then gives the
// bf16x2 {128 + lo, 128 + hi} (exact), a bf16x2 subtraction of 136 the code
// (exact) and a bf16x2 multiply by the column's scale rounds once: the bits
// of _dequant4_bf16. Bias is one bf16x2 addition after it. All three are
// the .rn forms, which the compiler may not fuse into one rounding. With a
// codebook a 1 KB shared table maps a byte to its pair of codebook values.
// The K loop holds about 3.0 instructions a weight (chip_smoke.py phase 3
// reads it from cuobjdump -sass), half of them logic and byte-permute ops;
// at the card's instruction rate that is about 12 us at the big shape,
// under its time.
//
// What the card showed (H100 80GB HBM3; the K split sweep is chip_smoke.py
// phase 3's, the rest came from experimental variants of this file): every
// load of the register ring must be unconditional (a load under a branch
// makes the compiler wait for it there, and a deeper ring then ran slower
// than none), so steps past a warp's range reload its last step and the
// ring runs in whole turns with a guarded tail; two steps in flight (127
// registers) were as fast as three or four; the K split is fastest near D's
// 224 blocks, except at M <= 8 on the widest shapes, where two blocks a
// cluster instead of one are about 5% faster (gemv4_plan takes both). On
// the widest shape the kernel runs at about half its byte bound, and its
// loads, not its unpack, set the time: a variant that only loaded took most
// of the kernel's time, and taking half an instruction a weight off the
// unpack gained 2-3%. So the interleaved layout that would save the byte
// permutes (a load-time recode of QLinearI4's buffer) was not taken.
//
// M > 16 (ops/qmatmul.tiled_plan): qmatmul4_wgmma_kernel, bound by bf16
// tensor-core work at large M: the warpgroup-MMA design of
// csrc/dq_wgmma.cuh (the weights as the MMA's A operand, dequantized in
// registers; x by TMA as the B operand; a persistent grid of 128-column by
// 64/128/256-token tiles). A stage is 32 packed rows (64 K rows); one
// ldmatrix.x4.trans a stage, its matrix rows ordered packed rows t, t + 4,
// gives a thread one register a k16 step whose four bytes are its whole A
// fragment (columns 2g, 2g+1 at K rows 2t, 2t+1 and 2t+8, 2t+9), so the
// GEMV kernel's unpack applies as it is: magic_pairs, sub_rn, mul_rn,
// add_rn, or the 1 KB pair table for a codebook.
//
// Other shapes (M <= 16 where the GEMV kernel does not apply; M > 16 with
// N not a multiple of 16, whose packed rows TMA cannot address, or a group
// the wgmma form does not take): qmatmul4_kernel, the first port's tiled
// kernel. Each block dequantizes a 32-deep slice of its 64 columns into
// shared memory, K-contiguous per column, both nibbles of a byte into
// neighbouring K positions (one 32-bit store), so x is taken whole (the
// TPU kernel pre-splits x into even and odd columns to avoid a lane
// interleave); then bf16 mma.sync.m16n8k16 with float accumulators. The
// codebook sits in shared memory. No copy/compute overlap.
#include <cooperative_groups.h>

#include "dq_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64, BK = 32, LDK = BK + 8;  // padded smem row (bf16)

struct Lut16 {
  float v[16];
};

template <int BM, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                const __nv_bfloat16* __restrict__ scale,
                const __nv_bfloat16* __restrict__ bias, float* __restrict__ out,
                int M, int N, int K, int G, int has_lut, Lut16 lut) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) uint16_t sa_raw[BM * LDK];
  __shared__ __align__(16) uint16_t sb_raw[BN * LDK];
  __shared__ float slut[16];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(sa_raw);   // [BM][LDK]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sb_raw);   // [BN][LDK], K-contiguous

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // value(idx) rounded to bf16 once, as the reference rounds the codebook
  if (tid < 16)
    slut[tid] = __bfloat162float(__float2bfloat16_rn(has_lut ? lut.v[tid] : (float)(tid - 8)));
  __syncthreads();

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK; c += NT) {
      const int r = c / BK, kk = c % BK;
      const int gm = m0 + r, gk = k0 + kk;
      sa[r * LDK + kk] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : zero;
    }
    for (int c = tid; c < BN * (BK / 2); c += NT) {
      const int k2 = c / BN, nn = c % BN;      // neighbouring threads: neighbouring columns
      const int gk = k0 + 2 * k2, gn = n0 + nn;
      uint32_t w2 = 0;
      if (gk < K && gn < N) {
        const uint32_t byte = packed[(size_t)(gk >> 1) * N + gn];
        const size_t sidx = (size_t)(gk / G) * N + gn;   // G is even: one group for both
        const float s = __bfloat162float(scale[sidx]);
        __nv_bfloat16 w0 = __float2bfloat16_rn(slut[byte & 0x0F] * s);
        __nv_bfloat16 w1 = __float2bfloat16_rn(slut[byte >> 4] * s);
        if (bias != nullptr) {
          const float bf = __bfloat162float(bias[sidx]);
          w0 = __float2bfloat16_rn(__bfloat162float(w0) + bf);
          w1 = __float2bfloat16_rn(__bfloat162float(w1) + bf);
        }
        w2 = (uint32_t)__bfloat16_as_ushort(w0) | ((uint32_t)__bfloat16_as_ushort(w1) << 16);
      }
      *reinterpret_cast<uint32_t*>(sb + nn * LDK + 2 * k2) = w2;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const __nv_bfloat16* p = sa + (wm + i * 16 + g) * LDK + ks + t * 2;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDK);
        af[i][2] = ld32(p + 8);
        af[i][3] = ld32(p + 8 * LDK + 8);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const __nv_bfloat16* p = sb + (wn + j * 8 + g) * LDK + ks + t * 2;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

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

template <int BM, int WM, int WN>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* packed,
                   const __nv_bfloat16* scale, const __nv_bfloat16* bias, float* out,
                   int M, int N, int K, int G, int has_lut, const Lut16& lut,
                   cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmatmul4_kernel<BM, WM, WN><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
      x, packed, scale, bias, out, M, N, K, G, has_lut, lut);
  return cudaGetLastError();
}

// ------------------------------------------------------------ M <= 16 ----
namespace gemv {

constexpr int WARPS = 4;       // warps of a block: one K range each, the same columns
constexpr int COLS = 128;      // output columns of a block: 8 lane groups x 16
constexpr int MAX_SPLITS = 8;  // blocks of a cluster (the portable cluster size)
constexpr int STEP = 32;       // K rows a step: 16 packed rows, 4 a lane

// 16 packed bytes that are read once: past L1. Not volatile, so that the
// compiler may schedule the ring's loads.
IK_DEV uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

IK_DEV uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// (a & mask) | bits in one logic op: written as C, the two constants are
// two immediates, which one LOP3 cannot take, and it becomes two.
IK_DEV uint32_t and_or(uint32_t a, uint32_t mask, uint32_t bits) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(mask), "r"(bits));
  return d;
}

// The bf16x2 {128 + lo, 128 + hi} of each byte b of w (p[b]; lo the low
// nibble, in the lower half): 0x4300 | n is the bf16 of 128 + n.
IK_DEV void magic_pairs(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t s = w >> 4;
  const uint32_t lo01 = and_or(w, 0x00000F0Fu, 0x43430000u);   // bytes [43 43 l1 l0]
  const uint32_t hi01 = and_or(s, 0x00000F0Fu, 0x43430000u);   // [43 43 h1 h0]
  const uint32_t lo23 = and_or(w, 0x0F0F0000u, 0x00004343u);   // [l3 l2 43 43]
  const uint32_t hi23 = and_or(s, 0x0F0F0000u, 0x00004343u);   // [h3 h2 43 43]
  p[0] = __byte_perm(lo01, hi01, 0x3420);                  // [43 h0 43 l0]
  p[1] = __byte_perm(lo01, hi01, 0x3521);
  p[2] = __byte_perm(lo23, hi23, 0x1602);
  p[3] = __byte_perm(lo23, hi23, 0x1703);
}

// The lane's 16 values of one group row of scale (or bias), two a word
// (word c/2, local column c in half c % 2). VEC: two 16-byte loads at n0,
// which the caller keeps inside the row.
template <bool VEC>
IK_DEV void group_words(uint32_t (&w)[8], const __nv_bfloat16* __restrict__ row, int n0,
                        int N) {
  if (VEC) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + n0));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row + n0 + 8));
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else {
    const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const uint32_t bits = n0 + c < N ? r16[n0 + c] : 0u;
      w[c >> 1] |= (c & 1) ? bits << 16 : bits;
    }
  }
}

// {v, v} of local column c's value in a word array
IK_DEV uint32_t splat(const uint32_t (&w)[8], int c) {
  return __byte_perm(w[c >> 1], 0u, (c & 1) ? 0x3232 : 0x1010);
}

// MT m-tiles of 8 rows (M <= 8 * MT); U steps of 32 K rows in flight.
template <int MT, int U, bool LUT, bool BIAS, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
qmatmul4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                     const __nv_bfloat16* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ bias, float* __restrict__ out, int M,
                     int N, int K, int G, int unit, Lut16 lut) {
  __shared__ float red[WARPS][MT * 8][COLS];
  __shared__ uint32_t tab[LUT ? 256 : 1];   // byte -> bf16x2 {value(lo), value(hi)}
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());

  if (LUT) {
    for (int b = threadIdx.x; b < 256; b += WARPS * 32) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(lut.v[b & 15], lut.v[b >> 4]);
      tab[b] = bf16x2_bits(v);
    }
    __syncthreads();
  }

  // whole units of `unit` K rows (whole groups and whole steps): warp i of
  // the cluster takes units [i * NU / T, (i + 1) * NU / T)
  // (gemv_k_ranges(K, unit, splits) in ops/qmatmul.py)
  const int NU = K / unit, T = splits * WARPS, wi = rank * WARPS + warp;
  const int spu = unit / STEP;
  const int s_lo = (wi * NU / T) * spu, s_hi = ((wi + 1) * NU / T) * spu;

  const int n0 = bx * COLS + 16 * g;          // the lane's first column

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // a ring of U steps in registers: slot u holds step s0 + u; once a slot
  // is summed it is refilled with step s0 + u + U. Every load of the ring
  // is unconditional, so that U steps stay in flight (a load under a branch
  // makes the compiler wait for it): a step past the warp's range reloads
  // its last step, a lane past N (VEC) the tile's last valid columns and an
  // x row past M row M - 1; such slots are not summed, such columns and
  // rows never written.
  uint32_t q[U][4][4];           // [slot][packed row 4t + r][word: columns 4w .. 4w + 3]
  uint32_t xf[U][MT][4];         // x row 8 mt + g at K rows 8t .. 8t + 7 of the step
  uint32_t sw[U][8];             // the lane's group row of scales, bf16 pairs
  uint32_t bw[BIAS ? U : 1][8];  // ... of biases
  const int nl = VEC ? min(n0, N - 16) : n0;          // the lane's loaded columns
  const uint8_t* lane_packed = packed + (size_t)(4 * t) * N + nl;
  auto load_step = [&](int u, int s) {
    s = min(s, s_hi - 1);
    const uint8_t* p = lane_packed + (size_t)s * (STEP / 2) * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (VEC) {
        const uint4 v = ld_stream16(p + (size_t)r * N);
        q[u][r][0] = v.x, q[u][r][1] = v.y, q[u][r][2] = v.z, q[u][r][3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (n0 + 4 * w + b < N)
              word |= static_cast<uint32_t>(p[(size_t)r * N + 4 * w + b]) << (8 * b);
          q[u][r][w] = word;
        }
      }
    }
    const int k0 = s * STEP + 8 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = min(mt * 8 + g, M - 1);
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k0));
      xf[u][mt][0] = v.x, xf[u][mt][1] = v.y, xf[u][mt][2] = v.z, xf[u][mt][3] = v.w;
    }
    // K rows 8t .. 8t + 7 lie in one group (G % 8 == 0)
    const size_t grow = (size_t)(k0 / G) * N;
    group_words<VEC>(sw[u], scale + grow, nl, N);
    if (BIAS) group_words<VEC>(bw[BIAS ? u : 0], bias + grow, nl, N);
  };
  auto sum_step = [&](int u) {
    const uint32_t k136 = 0x43084308u;          // bf16x2 {136, 136}
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // w[rr][c]: bf16x2 of packed row 4t + 2h + rr, local column c
      uint32_t w[2][16];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t p[4];
          if (LUT) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              p[b] = tab[__byte_perm(q[u][2 * h + rr][i], 0u, 0x4440 | b)];
          } else {
            magic_pairs(q[u][2 * h + rr][i], p);
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int c = 4 * i + b;
            uint32_t v = LUT ? p[b] : sub_rn(p[b], k136);
            v = mul_rn(v, splat(sw[u], c));
            if (BIAS) v = add_rn(v, splat(bw[BIAS ? u : 0], c));
            w[rr][c] = v;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // A = W^T: row g -> local column j, row g + 8 -> local column j + 8
        const uint32_t a[4] = {w[0][j], w[0][j + 8], w[1][j], w[1][j + 8]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][j], a, &xf[u][mt][2 * h]);
      }
    }
  };
  if (s_lo < s_hi) {
#pragma unroll
    for (int u = 0; u < U; ++u) load_step(u, s_lo + u);
    int s0 = s_lo;
    for (; s0 + U <= s_hi; s0 += U) {      // whole turns of the ring: no branch
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sum_step(u);
        load_step(u, s0 + u + U);
      }
    }
#pragma unroll
    for (int u = 0; u < U - 1; ++u)        // the last steps, already loaded
      if (s0 + u < s_hi) sum_step(u);
  }

  // D = out^T: d0, d1 = (column j, rows 2t, 2t+1), d2, d3 = (column j + 8, ...)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = mt * 8 + 2 * t;
      red[warp][m][16 * g + j] = acc[mt][j][0];
      red[warp][m + 1][16 * g + j] = acc[mt][j][1];
      red[warp][m][16 * g + j + 8] = acc[mt][j][2];
      red[warp][m + 1][16 * g + j + 8] = acc[mt][j][3];
    }
  }
  __syncthreads();
  // the block's warps in order 0, 1, ...: entry e = m * COLS + local column
  float* r0 = &red[0][0][0];
  const int E = M * COLS;
  for (int e = threadIdx.x; e < E; e += WARPS * 32) {
    float v = r0[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += (&red[w][0][0])[e];
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
    const int m = e / COLS, n = bx * COLS + e % COLS;
    if (n < N) out[(size_t)m * N + n] = v;
  }
  cluster.sync();                 // no block leaves while its shared memory is read
}

template <int MT, bool LUT, bool BIAS, bool VEC>
cudaError_t launch(const __nv_bfloat16* x, const uint8_t* packed, const __nv_bfloat16* scale,
                   const __nv_bfloat16* bias, float* out, int M, int N, int K, int G,
                   int unit, int splits, const Lut16& lut, cudaStream_t s) {
  // two steps in flight: 127 registers at MT = 1 (four blocks an SM fit);
  // deeper rings cost registers and were no faster on the card
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, qmatmul4_gemv_kernel<MT, U, LUT, BIAS, VEC>, x,
                                     packed, scale, bias, out, M, N, K, G, unit, lut);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MT, bool LUT, bool BIAS>
cudaError_t by_vec(const __nv_bfloat16* x, const uint8_t* packed, const __nv_bfloat16* scale,
                   const __nv_bfloat16* bias, float* out, int M, int N, int K, int G,
                   int unit, int splits, const Lut16& lut, cudaStream_t s) {
  return N % 16 == 0   // 16-byte rows of packed bytes and scales
             ? launch<MT, LUT, BIAS, true>(x, packed, scale, bias, out, M, N, K, G, unit,
                                           splits, lut, s)
             : launch<MT, LUT, BIAS, false>(x, packed, scale, bias, out, M, N, K, G, unit,
                                            splits, lut, s);
}

template <bool LUT, bool BIAS>
cudaError_t by_m(const __nv_bfloat16* x, const uint8_t* packed, const __nv_bfloat16* scale,
                 const __nv_bfloat16* bias, float* out, int M, int N, int K, int G, int unit,
                 int splits, const Lut16& lut, cudaStream_t s) {
  return M <= 8 ? by_vec<1, LUT, BIAS>(x, packed, scale, bias, out, M, N, K, G, unit, splits,
                                       lut, s)
                : by_vec<2, LUT, BIAS>(x, packed, scale, bias, out, M, N, K, G, unit, splits,
                                       lut, s);
}

cudaError_t run(const __nv_bfloat16* x, const uint8_t* packed, const __nv_bfloat16* scale,
                const __nv_bfloat16* bias, float* out, int M, int N, int K, int G, int unit,
                int splits, bool has_lut, const Lut16& lut, cudaStream_t s) {
  if (M < 1 || M > 16 || G % 16 != 0 || unit % STEP != 0 || unit % G != 0 || K % unit != 0 ||
      splits < 1 || splits > MAX_SPLITS)
    return cudaErrorInvalidValue;
  if (has_lut)
    return bias ? by_m<true, true>(x, packed, scale, bias, out, M, N, K, G, unit, splits, lut, s)
                : by_m<true, false>(x, packed, scale, bias, out, M, N, K, G, unit, splits, lut, s);
  return bias ? by_m<false, true>(x, packed, scale, bias, out, M, N, K, G, unit, splits, lut, s)
              : by_m<false, false>(x, packed, scale, bias, out, M, N, K, G, unit, splits, lut, s);
}

}  // namespace gemv

// ------------------------------------------------- M > 16, wgmma form ---
// 4-bit packed bytes (K/2, N): 32 packed rows a stage; one
// ldmatrix.x4.trans a stage, matrix i = k16 step i with its rows ordered
// packed rows 0, 4, 1, 5, 2, 6, 3, 7, gives thread (g, t) bytes (t, 2g),
// (t, 2g+1), (t+4, 2g), (t+4, 2g+1) of each step.
template <bool LUT>
struct PackedCodes {
  static constexpr int ROWS = dqw::BK / 2, NREG = 4, STATIC_SMEM = 1024;
  static constexpr bool K_MAJOR = false;
  static int rows_of(int K) { return K / 2; }
  IK_DEV static void load(uint32_t (&r)[NREG], const unsigned char* tile, int lane, int chunk) {
    const int rr = lane & 7, prow = 8 * (lane >> 3) + (rr >> 1) + 4 * (rr & 1);
    ldmatrix_x4_trans(r, tile + prow * 128 + ((chunk ^ (prow & 7)) << 4));
  }
  // byte b of the step's register is fragment register b: the bf16x2 of
  // its two nibbles (K rows 2i, 2i + 1), column l + (b & 1)
  template <bool BIAS>
  IK_DEV static void step(uint32_t (&a)[4], const uint32_t (&r)[NREG], int j, uint32_t sp,
                          uint32_t bp, const uint32_t* tab) {
    uint32_t p[4];
    if (LUT) {
#pragma unroll
      for (int b = 0; b < 4; ++b) p[b] = tab[__byte_perm(r[j], 0u, 0x4440 | b)];
    } else {
      gemv::magic_pairs(r[j], p);
#pragma unroll
      for (int b = 0; b < 4; ++b) p[b] = sub_rn(p[b], 0x43084308u);    // - {136, 136}
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      a[b] = mul_rn(p[b], dqw::splat(sp, b & 1));
      if constexpr (BIAS) a[b] = add_rn(a[b], dqw::splat(bp, b & 1));
    }
  }
};

template <int TM, bool LUT, bool BIAS>
__global__ void __launch_bounds__(dqw::THREADS, 1)
qmatmul4_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_s,
                      const __grid_constant__ CUtensorMap map_b, float* __restrict__ out,
                      const dqw::Args a, Lut16 lut) {
  __shared__ uint32_t tab[LUT ? 256 : 1];    // byte -> bf16x2 {value(lo), value(hi)}
  if (LUT)
    for (int b = threadIdx.x; b < 256; b += dqw::THREADS)
      tab[b] = gemv::bf16x2_bits(__floats2bfloat162_rn(lut.v[b & 15], lut.v[b >> 4]));
  dqw::dq_wgmma_body<PackedCodes<LUT>, TM, dqw::Form<false, BIAS, false>>(&map_x, &map_q, &map_s,
                                                                          &map_b, out, a, tab);
}

template <int TM, bool LUT, bool BIAS>
cudaError_t wgmma_go(const __nv_bfloat16* x, const uint8_t* packed, const __nv_bfloat16* scale,
                     const __nv_bfloat16* bias, float* out, const dqw::Args& a, int blocks,
                     const Lut16& lut, cudaStream_t s) {
  return dqw::launch<PackedCodes<LUT>, TM, qmatmul4_wgmma_kernel<TM, LUT, BIAS>>(
      x, packed, scale, bias, out, a, blocks, s, lut);
}

template <bool LUT, bool BIAS>
cudaError_t wgmma_by_tm(const __nv_bfloat16* x, const uint8_t* packed,
                        const __nv_bfloat16* scale, const __nv_bfloat16* bias, float* out,
                        const dqw::Args& a, int tile_m, int blocks, const Lut16& lut,
                        cudaStream_t s) {
  switch (tile_m) {
    case 256: return wgmma_go<256, LUT, BIAS>(x, packed, scale, bias, out, a, blocks, lut, s);
    case 128: return wgmma_go<128, LUT, BIAS>(x, packed, scale, bias, out, a, blocks, lut, s);
    case 64: return wgmma_go<64, LUT, BIAS>(x, packed, scale, bias, out, a, blocks, lut, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// lut: 16 floats in host memory, or null for value(idx) = idx - 8. tile_m
// 64, 128 or 256: the wgmma kernel with tiles of tile_m tokens on a
// persistent grid of `splits` blocks (M > 16; ops/qmatmul.tiled_plan);
// else splits 1-8: the M <= 16 kernel, with the blocks of a cluster that
// split K in whole units of `unit` rows (ops/qmatmul.gemv4_plan); splits 0:
// the mma.sync tiled kernel.
extern "C" int ik_qmatmul4(const void* x, const void* packed, const void* scale,
                           const void* bias, void* out, int M, int N, int K, int G,
                           const float* lut, int splits, int unit, int tile_m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto p = static_cast<const uint8_t*>(packed);
  auto sc = static_cast<const __nv_bfloat16*>(scale);
  auto bi = static_cast<const __nv_bfloat16*>(bias);
  auto o = static_cast<float*>(out);
  Lut16 l{};
  if (lut != nullptr)
    for (int i = 0; i < 16; ++i) l.v[i] = lut[i];
  const int has_lut = lut != nullptr;
  if (tile_m > 0) {
    dqw::Args a;
    if (!dqw::make_args(&a, M, N, K, G, 0, bias != nullptr, 0, splits))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e;
    if (has_lut)
      e = bi ? wgmma_by_tm<true, true>(xb, p, sc, bi, o, a, tile_m, splits, l, s)
             : wgmma_by_tm<true, false>(xb, p, sc, bi, o, a, tile_m, splits, l, s);
    else
      e = bi ? wgmma_by_tm<false, true>(xb, p, sc, bi, o, a, tile_m, splits, l, s)
             : wgmma_by_tm<false, false>(xb, p, sc, bi, o, a, tile_m, splits, l, s);
    return static_cast<int>(e);
  }
  if (splits > 0)
    return static_cast<int>(gemv::run(xb, p, sc, bi, o, M, N, K, G, unit, splits, has_lut, l, s));
  cudaError_t e = (M <= 16) ? launch<16, 16, 16>(xb, p, sc, bi, o, M, N, K, G, has_lut, l, s)
                            : launch<64, 32, 32>(xb, p, sc, bi, o, M, N, K, G, has_lut, l, s);
  return static_cast<int>(e);
}
