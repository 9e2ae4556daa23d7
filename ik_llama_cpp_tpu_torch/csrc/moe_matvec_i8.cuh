// The int8 supergroup matvec shared by the MoE decode kernels (7, 8 and
// the single-kernel decode 11): one warp per output column, each lane
// streams 16-byte chunks of the column's K-contiguous row into __dp4a, the
// 16 lanes of a half-warp cover one 256-deep supergroup, and each
// supergroup's exact int32 sum gets its float correction in supergroup
// order (the order of the plain versions).
#pragma once

#include "moe_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int COLS = 16;         // output columns per block
constexpr int BATCH = 4;         // 16-byte chunks loaded ahead per lane per row
constexpr unsigned FULL = 0xffffffffu;

IK_DEV int dot16(const int4& a, const int4& b) {
  int s = __dp4a(a.x, b.x, 0);
  s = __dp4a(a.y, b.y, s);
  s = __dp4a(a.z, b.z, s);
  return __dp4a(a.w, b.w, s);
}

IK_DEV int4 ldg16(const int8_t* p) { return __ldg(reinterpret_cast<const int4*>(p)); }

// Exact int32 sums of the two supergroups a warp covers in one pass: the
// lower half-warp holds supergroup 2i, the upper one 2i + 1.
IK_DEV void half_sums(int v, int& s0, int& s1) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  s0 = __shfl_sync(FULL, v, 0);
  s1 = __shfl_sync(FULL, v, 16);
}

// Accumulates sum_g sa[g] * sb(g) * dot_g(x, row) into acc, in supergroup
// order; x is the activation row in shared memory (K bytes), nch = K / 16.
template <typename ScaleB>
IK_DEV float row_dot(const int8_t* x, const int8_t* row, const float* sa,
                     ScaleB sb, int nch, int nsg, float acc, int lane) {
  for (int c0 = 0; c0 < nch; c0 += 32 * BATCH) {
    int part[BATCH];
    int4 w[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = c0 + 32 * i + lane;
      w[i] = c < nch ? ldg16(row + 16 * c) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int c = c0 + 32 * i + lane;
      part[i] = c < nch ? dot16(reinterpret_cast<const int4*>(x)[c], w[i]) : 0;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int g0 = (c0 + 32 * i) / 16;
      if (g0 >= nsg) break;
      int s0, s1;
      half_sums(part[i], s0, s1);
      acc = sg_corr(acc, s0, sa[g0], sb(g0));
      if (g0 + 1 < nsg) acc = sg_corr(acc, s1, sa[g0 + 1], sb(g0 + 1));
    }
  }
  return acc;
}

}  // namespace
