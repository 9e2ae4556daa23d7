// The grouped work list of the MoE prefill GEMMs over expert-sorted rows:
// kernel 14 (ragged_wgmma_kernel, csrc/moe_qmm.cu) and kernel 10
// (ragged_i8_wgmma_kernel, csrc/moe_qmm_i8.cu).
//
// A call's work is its sweeps (expert with rows, column tile, TM of the
// expert's rows), numbered experts first, then column tiles, then token
// tiles, and taken round robin by the blocks of a persistent grid: the
// sweeps of one (expert, column tile) are consecutive, so neighbouring
// blocks run them at once and read the tile's codes from device memory
// about once, sharing them in L2, and a large expert's sweeps spread over
// as many blocks as it has token tiles. The group sizes stay on the device:
// every block builds the map from them (rows_map) in shared memory, with no
// host read and no step table. The ops/moe_qmm.py plans count the most
// sweeps a call can have and size the grid from it; tests model the order
// (tests/test_torch_moe_qmm_grouped.py, tests/test_torch_moe_qmm_i8_grouped.py).
#pragma once

#include "common.cuh"

namespace {

constexpr int MAXG = 1024;         // groups the prefix sums hold

// The map's arrays from the G group sizes. end: each expert's end row (the
// prefix sums of the group sizes, clamped to M); live: the experts with
// rows, n_live of them; first: the number of token tiles of the live
// experts before each (n_live + 1 entries). Every thread loads, warp 0 scans
// 32 groups at a time (rows, then token tiles of TM). Visible to the block
// after its next barrier.
template <int TM>
IK_DEV void rows_map(const int* __restrict__ gsz, int G, int M, int* end, int* live, int* first,
                     int* n_live) {
  for (int i = threadIdx.x; i < G; i += blockDim.x) end[i] = gsz[i];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0, tcarry = 0, n = 0;
  for (int base = 0; base < G; base += 32) {
    const int e = base + lane;
    const int c = e < G ? end[e] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const int stop = min(carry + x, M), start = min(carry + x - c, M);
    const int tiles = e < G ? (stop - start + TM - 1) / TM : 0;
    int tx = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, tx, o);
      if (lane >= o) tx += y;
    }
    if (e < G) end[e] = stop;
    const unsigned mask = __ballot_sync(0xffffffffu, tiles > 0);
    if (tiles > 0) {
      const int at = n + __popc(mask & ((1u << lane) - 1u));
      live[at] = e;
      first[at] = tcarry + tx - tiles;
    }
    n += __popc(mask);
    carry = __shfl_sync(0xffffffffu, carry + x, 31);
    tcarry = __shfl_sync(0xffffffffu, tcarry + tx, 31);
  }
  if (lane == 0) {
    *n_live = n;
    first[n] = tcarry;
  }
}

// The block's sweeps in order: fn(expert, m0, m_end, column tile) for the
// tokens [m0, m0 + TM) of the expert (rows below m_end are its own) against
// column tile `tile` of tiles_n.
template <int TM, class Fn>
IK_DEV void grouped_sweeps(const int* end, const int* live, const int* first, int n_live,
                           int tiles_n, Fn&& fn) {
  const int total = first[n_live] * tiles_n;
  int i = 0;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    while (first[i + 1] * tiles_n <= u) ++i;
    const int e = live[i], te = first[i + 1] - first[i], r = u - first[i] * tiles_n;
    const int m0 = (e ? end[e - 1] : 0) + (r % te) * TM;
    fn(e, m0, min(m0 + TM, end[e]), r / te);
  }
}

}  // namespace
