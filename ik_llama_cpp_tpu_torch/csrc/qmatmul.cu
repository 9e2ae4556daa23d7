// Planar dequant x matmul, and its form over codes packed two to a 16-bit
// lane.
//
// Replaces ik_llama_cpp_tpu/ops/qmatmul.py:qmatmul (Pallas, _make_kernel)
// and ik_llama_cpp_tpu/tools/perf_dequant.py:qmatmul_pair (Pallas,
// _pair_kernel: the same arithmetic behind another loader).
//
//   out = x @ W,   W[k, n] = bf16(bf16(codes[k, n]) * scale[k/G, n]) (+ bias[k/G, n] in bf16)
//
// x: bf16 (M, K) row-major; codes: int8 (K, N); scale, bias: bf16 or float32
// (K/G, N), float32 rounded to bf16 here; out: f32 (M, N). K % G == 0. The
// dequant chain runs in bf16 with float sums, which is qmatmul_ref's
// numerics contract. In the pair form codes are int16 (K, N/2): the low
// byte of packed column j is the code of column j, the high byte that of
// column j + N/2.
//
// Three kernels; the wrapper's plans (ops/qmatmul.gemv_plan, tiled_plan)
// pick one before the launch.
//
// M <= 16, qmatmul_gemv_kernel (decode). Bound on the H100 by the weight
// bytes: ~1.06 a weight (the code, 2/G of a bf16 scale) at 2-32 flops a
// byte. Every code byte is read once, in 16-byte loads (16 columns at one
// k, or 8 packed columns, both halves), neighbouring lanes on neighbouring
// addresses, U steps of loads in flight a warp and no barrier in the K
// sweep. A block's 4 warps share 128 output columns and each takes its own
// range of whole groups of K; the blocks of a thread-block cluster (the
// K split, 1-8 blocks, chosen by the wrapper) take further ranges, and the
// sums are added in a fixed order: the warps of a block through shared
// memory, the blocks of a cluster through distributed shared memory. No
// atomics and no workspace: a call repeats bit for bit, and the pair form
// equals the planar form on the unpacked codes bit for bit. The product is
// mma.sync.m16n8k16 with the dequantized weights as the A operand (16
// columns x 16 k) and x as B (16 k x 8 rows of M), built in registers: the
// mma's k slots 2t, 2t+1, 2t+8, 2t+9 of lane (g, t) are mapped to rows
// k0 + 4t .. k0 + 4t + 3, which are the four rows that lane loads, so no
// transpose or shared-memory staging is needed. Codes become bf16 through
// a byte permute into a float magic number (2^23 + u, u = code + 128) and
// one subtraction; code x scale is one bf16x2 multiply of an exact
// product (the same bits as rounding the float product).
//
// M > 16, qmatmul_wgmma_kernel (prefill): the warpgroup-MMA design of
// csrc/dq_wgmma.cuh (the weights as the MMA's A operand, dequantized in
// registers from ldmatrix.trans of the TMA-loaded code tile; x by TMA as
// the B operand; a persistent grid of 128-column by 64/128/256-token
// tiles, ops/qmatmul.tiled_plan). Bound by bf16 tensor-core work at large
// M. A code register from ldmatrix.trans holds codes (k 2t, 2t+1) x
// (columns 2g, 2g+1); codes_pair turns two of its bytes into the bf16x2
// of one fragment register with GEMV's magic-number conversion, and one
// mul.rn.bf16x2 by the column's scale rounds once, as above.
//
// Shapes the wgmma form does not take (ops/qmatmul.tiled_plan routes them
// by name before the launch: N not a multiple of 16, whose code rows TMA
// cannot address, or a group that is not a multiple of 16 dividing 64 or
// divided by it) keep the first port's qmatmul_kernel: each block
// dequantizes a 32-deep slice of its 64 columns into shared memory
// (K-contiguous per column, so the mma's B fragment is one 32-bit load),
// loads the matching x slice, and accumulates mma.sync products in float
// registers, with no copy/compute overlap.
#include <cooperative_groups.h>

#include "dq_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64, BK = 32, LDK = BK + 8;  // padded smem row (bf16)

IK_DEV float as_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
IK_DEV float as_bf16(__nv_bfloat16 v) { return __bfloat162float(v); }

// The output column of a block's local column. Pair form: local columns
// 0-31 are the low bytes of packed columns n0/2 .. n0/2 + 31, 32-63 the
// high bytes (N/2 further on); -1 past the edge.
template <bool PAIR>
IK_DEV int out_col(int n0, int local, int N) {
  if (!PAIR) return n0 + local < N ? n0 + local : -1;
  const int j = (n0 >> 1) + (local & 31);
  return j < N / 2 ? (local >> 5) * (N / 2) + j : -1;
}

template <int BM, int WM, int WN, typename S, bool PAIR>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ codes_,
               const S* __restrict__ scale, const S* __restrict__ bias,
               float* __restrict__ out, int M, int N, int K, int G) {
  const int8_t* codes = static_cast<const int8_t*>(codes_);
  const int16_t* codes16 = static_cast<const int16_t*>(codes_);
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  __shared__ __align__(16) uint16_t sa_raw[BM * LDK];
  __shared__ __align__(16) uint16_t sb_raw[BN * LDK];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(sa_raw);   // [BM][LDK]
  __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(sb_raw);   // [BN][LDK], K-contiguous

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

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
    for (int c = tid; c < BN * BK; c += NT) {
      const int kk = c / BN, nn = c % BN;      // neighbouring threads: neighbouring columns
      const int gk = k0 + kk, gn = out_col<PAIR>(n0, nn, N);
      __nv_bfloat16 w = zero;
      if (gk < K && gn >= 0) {
        const size_t sidx = (size_t)(gk / G) * N + gn;
        float cf;
        if (PAIR) {
          const int v = codes16[(size_t)gk * (N / 2) + (gn % (N / 2))];
          cf = (float)static_cast<int8_t>(nn < 32 ? v : v >> 8);
        } else {
          cf = (float)codes[(size_t)gk * N + gn];
        }
        w = __float2bfloat16_rn(cf * as_bf16(scale[sidx]));
        if (bias != nullptr)
          w = __float2bfloat16_rn(__bfloat162float(w) + as_bf16(bias[sidx]));
      }
      sb[nn * LDK + kk] = w;
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
      const int c0 = out_col<PAIR>(n0, wn + j * 8 + t * 2, N);
      const int c1 = out_col<PAIR>(n0, wn + j * 8 + t * 2 + 1, N);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + i * 16 + g + h * 8;
        if (r >= M) continue;
        if (c0 >= 0) out[(size_t)r * N + c0] = acc[i][j][2 * h];
        if (c1 >= 0) out[(size_t)r * N + c1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <int BM, int WM, int WN, typename S, bool PAIR>
cudaError_t launch(const void* x, const void* codes, const void* scale, const void* bias,
                   void* out, int M, int N, int K, int G, cudaStream_t s) {
  const int cols = PAIR ? N / 2 : N, bn = PAIR ? BN / 2 : BN;
  dim3 grid((cols + bn - 1) / bn, (M + BM - 1) / BM);
  qmatmul_kernel<BM, WM, WN, S, PAIR><<<grid, (BM / WM) * (BN / WN) * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), codes, static_cast<const S*>(scale),
      static_cast<const S*>(bias), static_cast<float*>(out), M, N, K, G);
  return cudaGetLastError();
}

// ------------------------------------------------- M > 16, wgmma form ---
// bf16x2 {lo + b, hi + b}: float sums rounded once to bf16, as
// qmatmul_ref and the GEMV kernel add the bias
IK_DEV uint32_t add_f(uint32_t w, float b) {
  return pack_bf16x2(__uint_as_float(w << 16) + b, __uint_as_float(w & 0xFFFF0000u) + b);
}

// int8 codes (K, N) (or the pair form's int16 (K, N/2), the same bytes):
// 64 code rows a stage; two ldmatrix.x4.trans a stage give a thread
// registers (k 2t, 2t+1) x (columns 2g, 2g+1) of k rows 0-7 and 8-15 of
// each k16 step.
struct PlanarCodes {
  static constexpr int ROWS = dqw::BK, NREG = 8, STATIC_SMEM = 0;
  static constexpr bool K_MAJOR = false;
  static int rows_of(int K) { return K; }
  IK_DEV static void load(uint32_t (&r)[NREG], const unsigned char* tile, int lane, int chunk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 32 * h + lane;
      ldmatrix_x4_trans(r + 4 * h, tile + k * 128 + ((chunk ^ (k & 7)) << 4));
    }
  }
  // fragment: a0 = column l at k 2t, 2t+1 (bytes 0, 2 of the low word),
  // a1 = column l + 1 (bytes 1, 3), a2 / a3 the same at k 2t+8, 2t+9
  template <bool BIAS>
  IK_DEV static void step(uint32_t (&a)[4], const uint32_t (&r)[NREG], int j, uint32_t sp,
                          uint32_t bp, const uint32_t*) {
    const uint32_t lo = r[2 * j] ^ 0x80808080u, hi = r[2 * j + 1] ^ 0x80808080u;
    const uint32_t s0 = dqw::splat(sp, 0), s1 = dqw::splat(sp, 1);
    a[0] = mul_rn(codes_pair(lo, 0, 2), s0);
    a[1] = mul_rn(codes_pair(lo, 1, 3), s1);
    a[2] = mul_rn(codes_pair(hi, 0, 2), s0);
    a[3] = mul_rn(codes_pair(hi, 1, 3), s1);
    if constexpr (BIAS) {
      const float b0 = __uint_as_float(bp << 16), b1 = __uint_as_float(bp & 0xFFFF0000u);
      a[0] = add_f(a[0], b0);
      a[1] = add_f(a[1], b1);
      a[2] = add_f(a[2], b0);
      a[3] = add_f(a[3], b1);
    }
  }
};

template <int TM, bool F32, bool BIAS, bool PAIR>
__global__ void __launch_bounds__(dqw::THREADS, 1)
qmatmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_s,
                     const __grid_constant__ CUtensorMap map_b, float* __restrict__ out,
                     const dqw::Args a) {
  dqw::dq_wgmma_body<PlanarCodes, TM, dqw::Form<F32, BIAS, PAIR>>(&map_x, &map_q, &map_s, &map_b,
                                                                 out, a, nullptr);
}

template <int TM, bool F32, bool BIAS, bool PAIR>
cudaError_t wgmma_go(const void* x, const void* codes, const void* scale, const void* bias,
                     float* out, const dqw::Args& a, int blocks, cudaStream_t s) {
  return dqw::launch<PlanarCodes, TM, qmatmul_wgmma_kernel<TM, F32, BIAS, PAIR>>(
      x, codes, scale, bias, out, a, blocks, s);
}

// the kernel of a launch's form: f32 or bf16 scales, a bias, the pair form
template <int TM>
cudaError_t wgmma_form(const void* x, const void* codes, const void* scale, const void* bias,
                       float* out, const dqw::Args& a, int blocks, cudaStream_t s) {
  if (a.pair)
    return a.s_f32 ? wgmma_go<TM, true, false, true>(x, codes, scale, bias, out, a, blocks, s)
                   : wgmma_go<TM, false, false, true>(x, codes, scale, bias, out, a, blocks, s);
  if (a.has_bias)
    return a.s_f32 ? wgmma_go<TM, true, true, false>(x, codes, scale, bias, out, a, blocks, s)
                   : wgmma_go<TM, false, true, false>(x, codes, scale, bias, out, a, blocks, s);
  return a.s_f32 ? wgmma_go<TM, true, false, false>(x, codes, scale, bias, out, a, blocks, s)
                 : wgmma_go<TM, false, false, false>(x, codes, scale, bias, out, a, blocks, s);
}

// tile_m: the tokens of a tile (64, 128 or 256), blocks: the persistent
// grid (ops/qmatmul.tiled_plan)
cudaError_t wgmma_launch(const void* x, const void* codes, const void* scale, const void* bias,
                         void* out, int M, int N, int K, int G, int s_f32, int pair, int tile_m,
                         int blocks, cudaStream_t s) {
  dqw::Args a;
  if (!dqw::make_args(&a, M, N, K, G, s_f32, bias != nullptr, pair, blocks))
    return cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  switch (tile_m) {
    case 256: return wgmma_form<256>(x, codes, scale, bias, o, a, blocks, s);
    case 128: return wgmma_form<128>(x, codes, scale, bias, o, a, blocks, s);
    case 64: return wgmma_form<64>(x, codes, scale, bias, o, a, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ M <= 16 ----
namespace gemv {

constexpr int WARPS = 4;       // warps of a block: one K range each, the same columns
constexpr int COLS = 128;      // output columns of a block: 8 lane groups x 16
constexpr int MAX_SPLITS = 8;  // blocks of a cluster (the portable cluster size)

// 16 code bytes that are read once: past L1.
IK_DEV uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// The byte of a lane's 16-byte slice that holds its local column c (0-15).
// Planar: columns in order. Pair: 8 packed columns, c < 8 their low bytes,
// c >= 8 their high bytes.
template <bool PAIR>
IK_DEV constexpr int byte_of(int c) { return PAIR ? (((c & 7) << 1) | (c >> 3)) : c; }

// The output column of local column c of lane group g in column tile bx, or
// -1 past the edge. A tile is 128 columns (planar) or 64 packed columns and
// their 64 high halves (pair); either way its lanes' byte slices are bytes
// bx * 128 + 16 g .. + 15 of a code row.
template <bool PAIR>
IK_DEV int col_of(int bx, int g, int c, int N) {
  if (!PAIR) {
    const int n = bx * COLS + 16 * g + c;
    return n < N ? n : -1;
  }
  const int j = bx * (COLS / 2) + 8 * g + (c & 7);
  return j < N / 2 ? (c >> 3) * (N / 2) + j : -1;
}

// bf16x2 {code a, code b} of byte b of two words whose bytes were XORed
// with 0x80 (u = code + 128): 2^23 + u as a float, minus 2^23 + 128, is the
// code exactly; its upper 16 bits are then the bf16 of the code.
IK_DEV uint32_t codes_bf16x2(uint32_t qa, uint32_t qb, int b) {
  const uint32_t sel = 0x7650u | static_cast<uint32_t>(b);
  const float fa = __uint_as_float(__byte_perm(qa, 0x4B000000u, sel)) - 8388736.f;
  const float fb = __uint_as_float(__byte_perm(qb, 0x4B000000u, sel)) - 8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

IK_DEV uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
IK_DEV __nv_bfloat162 as_bf162(uint32_t v) { return *reinterpret_cast<__nv_bfloat162*>(&v); }

// The lane's 16 values of one group row of scale (or bias), rounded to
// bf16, packed two a word (word c/2, local column c in half c % 2). VEC:
// 16-byte loads (every column of the lane valid, or none): p0 -> local
// columns 0-7, p1 -> 8-15 (pair form: the low and the high halves).
template <typename S, bool PAIR, bool VEC>
IK_DEV void scale_words(uint32_t (&w)[8], const S* __restrict__ row, int bx, int g, int N,
                        bool live) {
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0u;
  if (VEC) {
    if (!live) return;
    const S* p0 = row + (PAIR ? bx * (COLS / 2) + 8 * g : bx * COLS + 16 * g);
    const S* p1 = PAIR ? p0 + N / 2 : p0 + 8;
    if constexpr (sizeof(S) == 2) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p1));
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
      w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    } else {
      const float4 f[4] = {__ldg(reinterpret_cast<const float4*>(p0)),
                           __ldg(reinterpret_cast<const float4*>(p0) + 1),
                           __ldg(reinterpret_cast<const float4*>(p1)),
                           __ldg(reinterpret_cast<const float4*>(p1) + 1)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[2 * i] = bf16x2_bits(__floats2bfloat162_rn(f[i].x, f[i].y));
        w[2 * i + 1] = bf16x2_bits(__floats2bfloat162_rn(f[i].z, f[i].w));
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = col_of<PAIR>(bx, g, c, N);
      const __nv_bfloat16 v = __float2bfloat16_rn(live && n >= 0 ? as_bf16(row[n]) : 0.f);
      const uint32_t bits = __bfloat16_as_ushort(v);
      w[c >> 1] |= (c & 1) ? bits << 16 : bits;
    }
  }
}

// Local column c's value of a word array: bf16 as float.
IK_DEV float word_half(const uint32_t (&w)[8], int c) {
  return __uint_as_float((c & 1) ? (w[c >> 1] & 0xFFFF0000u) : (w[c >> 1] << 16));
}

// MT m-tiles of 8 rows (M <= 8 * MT); U 16-deep K steps in flight.
template <int MT, int U, typename S, bool PAIR, bool VEC, bool BIAS>
__global__ void __launch_bounds__(WARPS * 32)
qmatmul_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                    const S* __restrict__ scale, const S* __restrict__ bias,
                    float* __restrict__ out, int M, int N, int K, int G) {
  __shared__ float red[WARPS][MT * 8][COLS];
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bx = blockIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());

  // whole groups of G rows: warp i of the cluster takes groups
  // [i * NG / T, (i + 1) * NG / T) (gemv_k_ranges in ops/qmatmul.py)
  const int NG = K / G, T = splits * WARPS, wi = rank * WARPS + warp;
  const int spg = G / 16;
  const int s_lo = (wi * NG / T) * spg, s_hi = ((wi + 1) * NG / T) * spg;

  const int byte0 = bx * COLS + 16 * g;        // the lane's slice of a code row
  const bool lane_valid = byte0 < N;          // VEC: all 16 bytes or none

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // a ring of U steps in registers: slot u holds step s0 + u; once a slot
  // is summed it is refilled with step s0 + u + U, so U - 1 steps of loads
  // stay in flight while one is summed
  uint32_t q[U][4][4];           // [slot][row 4t + r][word]
  uint32_t xf[U][MT][2];         // B fragments: x rows 8 mt + g at k0 + 4t .. + 3
  uint32_t sw[U][8];             // the step's group row of scales, bf16 pairs
  uint32_t bw[BIAS ? U : 1][8];  // ... of biases
  auto load_step = [&](int u, int s) {
    const bool live = s < s_hi;
    const int k0 = s * 16 + 4 * t;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int8_t* row = codes + (size_t)(k0 + r) * N;
      if (VEC) {
        const uint4 v = (live && lane_valid) ? ld_stream16(row + byte0)
                                             : make_uint4(0u, 0u, 0u, 0u);
        q[u][r][0] = v.x, q[u][r][1] = v.y, q[u][r][2] = v.z, q[u][r][3] = v.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int off = byte0 + 4 * w + b;
            if (live && off < N)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(row[off])) << (8 * b);
          }
          q[u][r][w] = word;
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 8 + g;
      uint2 v = make_uint2(0u, 0u);
      if (live && m < M) v = __ldg(reinterpret_cast<const uint2*>(x + (size_t)m * K + k0));
      xf[u][mt][0] = v.x, xf[u][mt][1] = v.y;
    }
    const size_t grow = (size_t)((live ? s : s_lo) * 16 / G) * N;
    scale_words<S, PAIR, VEC>(sw[u], scale + grow, bx, g, N, live && lane_valid);
    if (BIAS)
      scale_words<S, PAIR, VEC>(bw[BIAS ? u : 0], bias + grow, bx, g, N, live && lane_valid);
  };
  auto sum_step = [&](int u) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int w = 0; w < 4; ++w) q[u][r][w] ^= 0x80808080u;
    // w(c) for the row pair (r0, r1) = rows (0, 1) or (2, 3): bf16x2 of
    // bf16(code * scale) (+ bias, rounded again), the lower row low
    auto weights = [&](int r0, int c) -> uint32_t {
      const int b = byte_of<PAIR>(c);
      const uint32_t codes2 = codes_bf16x2(q[u][r0][b >> 2], q[u][r0 + 1][b >> 2], b & 3);
      const __nv_bfloat162 s2 = as_bf162(sw[u][c >> 1]);
      __nv_bfloat162 w2 = __hmul2(as_bf162(codes2),
                                  (c & 1) ? __high2bfloat162(s2) : __low2bfloat162(s2));
      if (BIAS) {
        const float bb = word_half(bw[BIAS ? u : 0], c);
        w2 = __floats2bfloat162_rn(__low2float(w2) + bb, __high2float(w2) + bb);
      }
      return bf16x2_bits(w2);
    };
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // A = W^T: row g -> local column j, row g + 8 -> local column j + 8;
      // k slots (2t, 2t+1) -> rows 4t, 4t+1, (2t+8, 2t+9) -> rows 4t+2, 4t+3
      uint32_t a[4];
      a[0] = weights(0, j);
      a[1] = weights(0, j + 8);
      a[2] = weights(2, j);
      a[3] = weights(2, j + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][j], a, xf[u][mt]);
    }
  };
#pragma unroll
  for (int u = 0; u < U; ++u) load_step(u, s_lo + u);
  for (int s0 = s_lo; s0 < s_hi; s0 += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < s_hi) sum_step(u);
      load_step(u, s0 + u + U);
    }
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
    const int m = e / COLS, lc = e % COLS;
    const int n = col_of<PAIR>(bx, lc >> 4, lc & 15, N);
    if (n >= 0) out[(size_t)m * N + n] = v;
  }
  cluster.sync();                 // no block leaves while its shared memory is read
}

template <int MT, typename S, bool PAIR, bool VEC, bool BIAS>
cudaError_t launch(const void* x, const void* codes, const void* scale, const void* bias,
                   void* out, int M, int N, int K, int G, int splits, cudaStream_t s) {
  constexpr int U = MT == 1 ? 4 : 2;     // registers: MT = 2 holds twice the sums
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
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, qmatmul_gemv_kernel<MT, U, S, PAIR, VEC, BIAS>,
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const S*>(scale), static_cast<const S*>(bias), static_cast<float*>(out),
      M, N, K, G);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename S, bool PAIR, bool BIAS>
cudaError_t by_m(const void* x, const void* codes, const void* scale, const void* bias,
                 void* out, int M, int N, int K, int G, int splits, cudaStream_t s) {
  if (G % 16 != 0 || K % G != 0 || splits < 1 || splits > MAX_SPLITS)
    return cudaErrorInvalidValue;
  const bool vec = N % 16 == 0;     // 16-byte rows of codes and scales
  if (M <= 8)
    return vec ? launch<1, S, PAIR, true, BIAS>(x, codes, scale, bias, out, M, N, K, G, splits, s)
               : launch<1, S, PAIR, false, BIAS>(x, codes, scale, bias, out, M, N, K, G, splits, s);
  return vec ? launch<2, S, PAIR, true, BIAS>(x, codes, scale, bias, out, M, N, K, G, splits, s)
             : launch<2, S, PAIR, false, BIAS>(x, codes, scale, bias, out, M, N, K, G, splits, s);
}

}  // namespace gemv

template <typename S, bool PAIR>
cudaError_t by_rows(const void* x, const void* codes, const void* scale, const void* bias,
                    void* out, int M, int N, int K, int G, int splits, int tile_m,
                    cudaStream_t s) {
  if (M > 16 && tile_m > 0)
    return wgmma_launch(x, codes, scale, bias, out, M, N, K, G, sizeof(S) == 4, PAIR, tile_m,
                        splits, s);
  if (M > 16) return launch<64, 32, 32, S, PAIR>(x, codes, scale, bias, out, M, N, K, G, s);
  if constexpr (!PAIR)
    if (bias != nullptr)
      return gemv::by_m<S, false, true>(x, codes, scale, bias, out, M, N, K, G, splits, s);
  return gemv::by_m<S, PAIR, false>(x, codes, scale, nullptr, out, M, N, K, G, splits, s);
}

}  // namespace

// scale_bf16: scale (and bias) are bf16, else float32. M <= 16: splits,
// the blocks of a cluster that split K (1-8; ops/qmatmul.gemv_plan). M > 16
// (ops/qmatmul.tiled_plan): tile_m, the tokens of a wgmma tile (64, 128 or
// 256), and splits its persistent grid's blocks; tile_m 0 takes the
// mma.sync tiled kernel.
extern "C" int ik_qmatmul(const void* x, const void* codes, const void* scale,
                          const void* bias, int scale_bf16, void* out, int M, int N, int K,
                          int G, int splits, int tile_m, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16
          ? by_rows<__nv_bfloat16, false>(x, codes, scale, bias, out, M, N, K, G, splits, tile_m,
                                          s)
          : by_rows<float, false>(x, codes, scale, bias, out, M, N, K, G, splits, tile_m, s));
}

// codes16: int16 (K, N/2), two int8 codes a lane; N even; no bias.
extern "C" int ik_qmatmul_pair(const void* x, const void* codes16, const void* scale,
                               int scale_bf16, void* out, int M, int N, int K, int G,
                               int splits, int tile_m, void* stream) {
  if (N % 2) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      scale_bf16
          ? by_rows<__nv_bfloat16, true>(x, codes16, scale, nullptr, out, M, N, K, G, splits,
                                         tile_m, s)
          : by_rows<float, true>(x, codes16, scale, nullptr, out, M, N, K, G, splits, tile_m, s));
}
