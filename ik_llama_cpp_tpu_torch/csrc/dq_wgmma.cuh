// The prefill form of the dequant GEMMs, shared by kernel D
// (qmatmul_wgmma_kernel, csrc/qmatmul.cu: int8 planar codes, and the pair
// form of kernel 16) and kernel 15 (qmatmul4_wgmma_kernel, csrc/qmatmul4.cu:
// 4-bit packed indices).
//
//   out[m, n] = sum_k x[m, k] * W[k, n],   W = bf16(bf16(value) * bf16(scale)) [+ bias, rounded]
//
// Bound by bf16 tensor-core work from M ~ 64 up (M = 512, K = 4096, N =
// 28672: 0.1216 ms at 989 TFLOP/s, against 0.035 ms for the int8 code
// bytes at 3.35 TB/s). Hopper reaches that rate only through the
// warpgroup MMA, and a dequantized weight has to become its operand. The
// design is the mixed-input GEMM shape: the product is computed as
// out^T = W^T x^T, so the weights are the MMA's A operand, which wgmma
// takes from registers: each thread dequantizes its own A fragment in
// registers (no bf16 tile is written to shared memory and no barrier sits
// between the dequant and the MMA), and x, already bf16, is the B operand
// that TMA puts in shared memory in the 128-byte swizzle wgmma reads.
// - wgmma.mma_async m64nTMk16 f32.bf16.bf16 (TM = 64, 128 or 256 tokens)
//   with A in registers: a tile is 128 weight columns (two consumer
//   warpgroups of 64) by TM tokens, so each weight is dequantized once per
//   TM tokens (twice a call at M = 512, TM = 256);
// - a ring of 64-deep K stages (x: TM rows of 128 bytes; the raw code tile:
//   128 columns by 64 code rows, or 32 packed rows, in 128-byte swizzle;
//   the stage's scale and bias rows) loaded by TMA under full/empty
//   mbarriers by one producer thread; what lies past M, N or K reads as
//   zeros;
// - a warp's 16 weight columns are one 16-byte chunk of a code row;
//   ldmatrix.trans over those chunks gives thread (g, t) exactly the
//   codes of its A fragment once the fragment's rows g and g + 8 are taken
//   as columns 2g and 2g + 1 (a permutation of the output rows, undone at
//   the store): for int8 codes matrix rows are k rows and a register holds
//   (k 2t, 2t+1) x (columns 2g, 2g+1); for packed bytes the matrix rows are
//   ordered packed rows t, t + 4 (K rows 2t, 2t+1 and 2t+8, 2t+9), and one
//   register is the whole fragment of a k16 step;
// - a stage's four k16 steps go in two groups of two MMAs: the dequant of
//   the next two steps runs while the group before runs (two fragment
//   buffers, wgmma.wait_group 1 after each group), and the two consumer
//   warpgroups share the tensor cores; setmaxnreg gives them 232
//   registers each and the producer 40. On the H100 a group of two ran
//   10-20% faster than one MMA a group; a group of four (a stage) ran
//   12-20% slower than two, and dequantizing one step or one stage ahead
//   of the wait was slower too (ptxas injected a warpgroup wait into one
//   of those loops, C7517);
// - the weights' form (f32 or bf16 scales, a bias, D's pair form) is a
//   template argument: with runtime flags the K loop held every form's
//   loads and branches (~116 instructions a k16 step against ~50 now);
// - the x tile is not shared across a thread-block cluster: multicasting
//   it to 2 or 4 blocks of neighbouring column tiles gained nothing, and
//   the cluster launch cost ~40% even at one block a cluster;
// - one block an SM walks the output tiles (ops/qmatmul.tiled_plan's
//   persistent grid), tokens fastest, so that the blocks in flight share
//   each code tile in L2; K is never split: a call repeats bit for bit.
// Each weight keeps the plain version's bits (the .rn bf16x2 forms, never
// a contracted FMA); the sums are float32 in another order than the plain
// version's (the MMA's k16 steps in K order).
#pragma once

#include "hopper.cuh"

namespace {

// bf16x2 arithmetic that rounds at each step: the .rn forms, which the
// compiler may not contract into one fused multiply-add (__hmul2 then
// __hadd2 may become one, which rounds once where the plain version
// rounds twice).
IK_DEV uint32_t sub_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
IK_DEV uint32_t mul_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
IK_DEV uint32_t add_rn(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16x2 {code of byte b0, code of byte b1} of a word whose bytes are int8
// codes XORed with 0x80: each byte into a float magic number (2^23 + u, u =
// code + 128) less 2^23 + 128, exact; the high halves are the bf16 values.
IK_DEV uint32_t codes_pair(uint32_t q, int b0, int b1) {
  const float f0 = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7650 | b0)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7650 | b1)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

namespace dqw {

constexpr int TN = 128;          // weight columns of a tile: two consumer warpgroups of 64
constexpr int BK = 64;           // K of a stage: a 128-byte swizzled row of x a token
constexpr int THREADS = 384;     // the producer warpgroup, then two consumer warpgroups
constexpr int SC_BYTES = 2048;   // a stage's scale (or bias) rows: up to 4 x 128 f32
constexpr int SMEM_MAX = 232448;

struct Args {
  int M, N, K, G;
  int sr;         // scale rows a stage (the TMA box's rows: 64 / G, or 1 for G >= 64)
  int jsh;        // step j of a stage reads scale row j >> jsh
  int s_f32;      // scale and bias are float32 (else bf16), rounded to bf16 here
  int has_bias;
  int pair;       // D's pair form: a code byte column b is output column
                  // (b & 1) * N/2 + b / 2; scales come in two 64-column halves
};

// D (f32, 64 x 64) += A (bf16, 64 x 16, registers) * B (bf16, 64 x 16, K-major
// in shared memory)^T; D = A * B^T where scale_d is 0.
IK_DEV void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (f32, 64 x 128) += A (bf16, 64 x 16, registers) * B (bf16, 128 x 16, K-major
// in shared memory)^T; D = A * B^T where scale_d is 0.
IK_DEV void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (f32, 64 x 256) += A (bf16, 64 x 16, registers) * B (bf16, 256 x 16, K-major
// in shared memory)^T; D = A * B^T where scale_d is 0.
IK_DEV void wgmma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int TM>
IK_DEV void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (TM == 256) wgmma_rs_n256(d, a, db, scale_d);
  else if constexpr (TM == 128) wgmma_rs_n128(d, a, db, scale_d);
  else wgmma_rs_n64(d, a, db, scale_d);
}

// {v, v} of the low (h = 0) or high (h = 1) bf16 of a word
IK_DEV uint32_t splat(uint32_t w, int h) { return __byte_perm(w, 0u, h ? 0x3232 : 0x1010); }

// RESERVE: static shared memory the kernel holds beside the ring
template <int TM, int ROWS, int RESERVE = 0>
struct Layout {
  static constexpr int X = TM * 128;                  // bytes of a stage's x tile
  static constexpr int Q = ROWS * 128;                // ... of its code tile
  static constexpr int STAGE = X + Q + 2 * SC_BYTES;  // + scale and bias rows
  static constexpr int FIT = (SMEM_MAX - 2048 - RESERVE) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BYTES = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// One K sweep: tokens [m0, m0 + TM) against weight columns [n0, n0 + TN);
// rows below m_end are stored. q0: the first code row of the sweep's
// weights (an expert's), s0 its first scale row.
struct Sweep {
  int m0, m_end, n0, q0, s0;
};

// The work of kernels D and 15: the output tiles of one weight, tokens
// fastest, so that the blocks in flight share each code tile in L2.
struct DenseTiles {
  static constexpr int SMEM = 0;
  template <int TM, class Fn>
  IK_DEV void each(const Args& a, Fn&& fn) const {
    const int tiles_m = (a.M + TM - 1) / TM, tiles = tiles_m * ((a.N + TN - 1) / TN);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      fn(Sweep{(tile % tiles_m) * TM, a.M, (tile / tiles_m) * TN, 0, 0});
  }
};

// What a launch's weights are, fixed at compile time so that the K loop
// holds no branch on them: float32 scales (rounded to bf16 here, else
// bf16), a bias, D's pair form.
template <bool F32, bool BIAS, bool PAIR>
struct Form {
  static constexpr bool f32 = F32, bias = BIAS, pair = PAIR;
  static constexpr int es = F32 ? 4 : 2;      // bytes of a scale
};

// The thread's scale (or bias) pair {column l, column l + 1} of a stage's
// row as bf16x2; p points at column l's entry. Pair form: two boxes of 64
// columns, [half][row][64]; l is the low byte of packed column l / 2 of
// the tile, l + 1 its high byte, `half` bytes further.
template <class F>
IK_DEV uint32_t scale_pair(const unsigned char* p, int half) {
  if constexpr (!F::pair) {
    if constexpr (F::f32) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      return pack_bf16x2(f.x, f.y);
    } else {
      return *reinterpret_cast<const uint32_t*>(p);
    }
  } else if constexpr (F::f32) {
    return pack_bf16x2(*reinterpret_cast<const float*>(p),
                       *reinterpret_cast<const float*>(p + half));
  } else {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) |
           (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p + half)) << 16);
  }
}

// Q: the code format (csrc/qmatmul.cu, csrc/qmatmul4.cu, csrc/moe_qmm.cu):
// ROWS * 128 bytes of codes a stage, NREG registers of raw codes a thread
// a stage (Q::load, from the warp's chunk of the stage's code tile), Q::step
// the A fragment of k16 step j from them and the scale / bias pairs;
// Q::K_MAJOR: the code tile is TN columns by BK k bytes (else ROWS code
// rows by TN columns). F: the Form. W: the sweeps a block runs (W::each).
template <class Q, int TM, class F, class W = DenseTiles>
IK_DEV void dq_wgmma_body(const CUtensorMap* map_x, const CUtensorMap* map_q,
                          const CUtensorMap* map_s, const CUtensorMap* map_b,
                          float* __restrict__ out, const Args& a, const uint32_t* tab,
                          const W& work = W{}) {
  using L = Layout<TM, Q::ROWS, W::SMEM>;
  constexpr int NR = TM / 2;                 // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned stages: the swizzle pattern repeats every 8 rows
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sx = base;                                  // [STAGES][TM][128]
  unsigned char* sq = sx + L::STAGES * L::X;                 // [STAGES][ROWS][128]
  unsigned char* ssc = sq + L::STAGES * L::Q;                // [STAGES][scale | bias]
  uint64_t* full = reinterpret_cast<uint64_t*>(ssc + L::STAGES * 2 * SC_BYTES);
  uint64_t* empty = full + L::STAGES;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid & 31;
  const int nkb = (a.K + BK - 1) / BK;

  if (tid == 0) {
    // full: the producer's expect_tx arrive; empty: the 8 consumer warps
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps STAGES stages in flight
    setmaxnreg_dec<40>();
    if (tid == 0) {
      const uint32_t sc_box = a.sr * TN * F::es;
      const uint32_t tx = L::X + L::Q + sc_box * (F::bias ? 2 : 1);
      int it = 0;
      work.template each<TM>(a, [&](const Sweep& sw) {
        const int n0 = sw.n0;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % L::STAGES;
          mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], tx);
          tma_load_2d(sx + s * L::X, map_x, &full[s], kb * BK, sw.m0);
          if constexpr (Q::K_MAJOR)
            tma_load_2d(sq + s * L::Q, map_q, &full[s], kb * BK, sw.q0 + n0);
          else
            tma_load_2d(sq + s * L::Q, map_q, &full[s], n0, sw.q0 + kb * Q::ROWS);
          unsigned char* sc = ssc + s * 2 * SC_BYTES;
          const int row = sw.s0 + kb * BK / a.G;
          if (F::pair) {
            tma_load_2d(sc, map_s, &full[s], n0 / 2, row);
            tma_load_2d(sc + sc_box / 2, map_s, &full[s], a.N / 2 + n0 / 2, row);
          } else {
            tma_load_2d(sc, map_s, &full[s], n0, row);
            if (F::bias) tma_load_2d(sc + SC_BYTES, map_b, &full[s], n0, row);
          }
        }
      });
    }
  } else {
    // consumers: warpgroup c owns weight columns 64c .. 64c + 63 of the
    // tile, its warp w columns 64c + 16w .. + 15 (one 16-byte chunk of a
    // code row); the thread's A rows g and g + 8 are columns l and l + 1
    setmaxnreg_inc<232>();
    const int c = wg - 1, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int chunk = 4 * c + w, l = 64 * c + 16 * w + 2 * g;
    // the thread's scale entry in a stage's rows, the rows' distance, and
    // (pair form) the distance of the high half
    const int s_off = (F::pair ? l / 2 : l) * F::es;
    const int s_row = (F::pair ? TN / 2 : TN) * F::es, s_half = a.sr * s_row;
    float acc[NR];
    uint32_t frag[2][2][4];
    // a stage goes back to the producer
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % L::STAGES]);
    };
    int it = 0;
    work.template each<TM>(a, [&](const Sweep& sw) {
      const int m0 = sw.m0, n0 = sw.n0;
      fence_regs<NR>(acc);
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int s = it % L::STAGES;
        mbar_wait(&full[s], (it / L::STAGES) & 1);
        uint32_t raw[Q::NREG];
        Q::load(raw, sq + s * L::Q, lane, chunk);
        const unsigned char* sc = ssc + s * 2 * SC_BYTES + s_off;
        const uint64_t dx = desc_sw128(sx + s * L::X);
#pragma unroll
        for (int h = 0; h < BK / 32; ++h) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * h + jj;
            const unsigned char* sr = sc + (j >> a.jsh) * s_row;
            const uint32_t sp = scale_pair<F>(sr, s_half);
            const uint32_t bp = F::bias ? scale_pair<F>(sr + SC_BYTES, s_half) : 0u;
            Q::template step<F::bias>(frag[h][jj], raw, j, sp, bp, tab);
          }
          wgmma_fence();
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            wgmma_rs<TM>(acc, frag[h][jj], dx + 2 * (2 * h + jj), (kb | h | jj) != 0);
          wgmma_commit();
          wgmma_wait<1>();
          if (h == 0 && kb > 0) release(it - 1);    // its MMAs are done
        }
      }
      wgmma_wait<0>();
      fence_regs<NR>(acc);
      release(it - 1);
      // acc[4jj + e]: A row g + 8 (e >> 1) = column l + (e >> 1), token
      // 8jj + 2t + (e & 1)
#pragma unroll
      for (int jj = 0; jj < TM / 8; ++jj) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int m = m0 + 8 * jj + 2 * t + p;
          if (m >= sw.m_end) continue;
          float* o = out + (size_t)m * a.N;
          if constexpr (!F::pair) {
            if (n0 + l < a.N)
              *reinterpret_cast<float2*>(o + n0 + l) = make_float2(acc[4 * jj + p], acc[4 * jj + 2 + p]);
          } else {
            const int j2 = (n0 + l) / 2;
            if (j2 < a.N / 2) {
              o[j2] = acc[4 * jj + p];
              o[a.N / 2 + j2] = acc[4 * jj + 2 + p];
            }
          }
        }
      }
    });
  }
}

// Host side: the four tensor maps and the launch. x bf16 (M, K); codes
// (rows, N) bytes; scale and bias (K / G, N) bf16 or f32 (`es` bytes).
template <class Q, int TM, auto kern, class... Extra>
cudaError_t launch(const void* x, const void* codes, const void* scale, const void* bias,
                   float* out, Args a, int blocks, cudaStream_t s, Extra... extra) {
  using L = Layout<TM, Q::ROWS>;
  static_assert(L::BYTES <= SMEM_MAX - Q::STATIC_SMEM, "shared memory of one block");
  static bool smem_set = false;        // one a kernel: kern is a template argument
  cudaError_t e = set_smem(kern, L::BYTES, smem_set);
  if (e != cudaSuccess) return e;
  const int es = a.s_f32 ? 4 : 2;
  const CUtensorMapDataType st = a.s_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT16;
  const uint32_t sbox = a.pair ? TN / 2 : TN;
  CUtensorMap mx, mq, ms, mb;
  if ((e = tensor_map_2d(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.K, a.M, (uint64_t)a.K * 2,
                         BK, TM, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return e;
  if ((e = tensor_map_2d(&mq, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.N, Q::rows_of(a.K), a.N,
                         TN, Q::ROWS, CU_TENSOR_MAP_SWIZZLE_128B)) != cudaSuccess)
    return e;
  if ((e = tensor_map_2d(&ms, scale, st, a.N, a.K / a.G, (uint64_t)a.N * es, sbox, a.sr,
                         CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
    return e;
  mb = ms;
  if (bias != nullptr &&
      (e = tensor_map_2d(&mb, bias, st, a.N, a.K / a.G, (uint64_t)a.N * es, sbox, a.sr,
                         CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
    return e;
  kern<<<blocks, THREADS, L::BYTES, s>>>(mx, mq, ms, mb, out, a, extra...);
  return cudaGetLastError();
}

// The Args of a weight of group G, checked: G a multiple of 16 that
// divides 64 or that 64 divides (a stage's scale rows are one TMA box), K
// a multiple of G, and M, N positive.
inline bool group_args(Args* a, int M, int N, int K, int G, int s_f32, int has_bias, int pair) {
  if (M <= 0 || N <= 0 || G <= 0 || G % 16 != 0 || (BK % G != 0 && G % BK != 0) || K <= 0 ||
      K % G != 0)
    return false;
  *a = Args{M, N, K, G, G >= BK ? 1 : BK / G, G >= BK ? 2 : (G == 32 ? 1 : 0), s_f32,
            has_bias, pair};
  return true;
}

// The plan's arguments, checked: M > 16, N a multiple of 16 (16-byte code
// rows for TMA), the group as group_args takes it; a grid.
inline bool make_args(Args* a, int M, int N, int K, int G, int s_f32, int has_bias, int pair,
                      int blocks) {
  return M > 16 && N % 16 == 0 && blocks >= 1 &&
         group_args(a, M, N, K, G, s_f32, has_bias, pair);
}

}  // namespace dqw
}  // namespace
