// Prefill flash attention (T > 16).
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention (Pallas,
// _fa_kernel with the _make_tile_clamp index maps).
//
// q: bf16 (B, T, H, Dk); k: bf16 (B, S, Hkv, Dk); v: bf16 (B, S, Hkv, Dv),
// all with a unit last stride and the other strides given in elements;
// q_pos0, kv_len: int32 (B,) on the device; sinks: f32 (H,) or null.
// out: bf16 (B, T, H, Dv) contiguous. Causal online softmax with GQA,
// logit softcap, sliding window, llama4 attention chunks and per-head sinks.
//
// Bound on the H100: bf16 tensor-core operations over the live (causal)
// part of the score matrix; at T = 512 the K/V bytes are small next to
// them, and a block's serial walk over its key tiles (the last query tile
// walks the most) sets the time more than the card's rate. Design: one
// block per (head, batch, 64-query tile), four warps of 16 query rows,
// 64-key tiles (32 for head dims above 128). A block loops only over its
// live key range, from the first key its window or chunk allows to
// min(kv_len, last query position + 1), which is what the TPU kernel's
// tile clamp did with skipped DMAs. Each piece of a tile's round is kept
// short:
// - K and V stay row-major in shared memory, rows padded by 16 bytes so
//   the eight rows of an 8x8 ldmatrix fall in distinct banks; K's B
//   fragments come from ldmatrix, V's from ldmatrix.trans (no transpose).
// - A two-stage cp.async ring: tile j + 1 is in flight while tile j's QK^T,
//   softmax and PV run; one barrier a tile.
// - Q's A fragments are loaded once with ldmatrix and held in registers
//   for D <= 128 (at D = 256 the output accumulator takes 128 registers a
//   lane, so Q stays in shared memory and is read with ldmatrix).
// - The query tiles with the longest key ranges (the last ones) are
//   launched first: the grid's slowest dimension walks the tiles backwards.
// - A tile's round is short in instructions. With one warp on each SM
//   sub-partition there is little to hide latency, and code that does not
//   run still costs fetch time (the first form of this kernel, with an
//   unused softcap branch and a per-score mask test in the round, took
//   twice as long; PERF.md): the mask is two compares a score
//   against each row's key bounds [lo, hi), only on tiles some row of the
//   warp does not see whole; softcap is a template parameter; Q, K and V
//   are zero-filled past Dk and Dv, so no loop has a runtime bound.
// - The softmax keeps the float arithmetic of this kernel's first port
//   (scale, softcap, expf, the same order of sums), so the redesign gives
//   its bits (PERF.md): a faster ex2 in log2 units moved some
//   outputs by a bf16 ulp, enough to flip a near-tie greedy pick in
//   chip_smoke.py's phase 5.
// The products are mma.sync.m16n8k16 (bf16, float accumulate); wgmma and
// TMA are later work. The frame (the row loader, the tile mask test, one
// warp's round and its store) is fa_prefill.cuh, shared with kernel 6
// (flash_attention_q8.cu), which feeds the same round from an int8 cache.
#include "fa_prefill.cuh"

namespace {

constexpr int BQ = FA_BQ, NT = FA_HEAD_WARPS * 32;

template <int D, int KT>
struct Layout {
  static constexpr int LD = D + 8;          // padded row (bf16)
  static constexpr int Q = BQ * LD;         // the query tile
  static constexpr int TILE = KT * LD;      // one K or V tile
  static constexpr int BYTES = (Q + 4 * TILE) * 2;   // Q, two stages of K and V
};

// CAP: a logit softcap (a second instantiation, so the common path carries
// no tanh code).
template <int D, int KT, bool CAP>
__global__ void __launch_bounds__(NT)
fa_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ q_pos0, const int* __restrict__ kv_len,
                  const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                  int T, int H, int Hkv, int Dk, int Dv, long long sqb, long long sqt,
                  long long sqh, long long skb, long long sks, long long skh,
                  long long svb, long long svs, long long svh, float scale,
                  float softcap, int swa, int chunk) {
  using L = Layout<D, KT>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LD]
  __nv_bfloat16* sk = sq + L::Q;                                     // [2][KT][LD]
  __nv_bfloat16* sv = sk + 2 * L::TILE;                              // [2][KT][LD]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest key ranges first
  const int hk = h / (H / Hkv);
  const int nrows = min(BQ, T - row0);
  const int qpos = q_pos0[b];
  const FaMask mk{kv_len[b], swa, chunk};

  const FaKeyRange kr = fa_key_range<KT>(qpos + row0, nrows, mk);
  const __nv_bfloat16* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const __nv_bfloat16* vb = v + (size_t)b * svb + (size_t)hk * svh;
  auto load_tile = [&](int stage, int key0) {
    fa_load_rows<D, KT, LD, NT>(sk + stage * L::TILE, kb, sks, key0, kr.end, Dk, tid);
    fa_load_rows<D, KT, LD, NT>(sv + stage * L::TILE, vb, svs, key0, kr.end, Dv, tid);
  };

  // Q, K and V are zero past Dk / Dv, so the products run over all D dims
  fa_load_rows<D, BQ, LD, NT>(sq, q + (size_t)b * sqb + (size_t)h * sqh, sqt, row0, T, Dk, tid);
  cp_async_commit();
  if (kr.ntiles > 0) load_tile(0, kr.start);
  cp_async_commit();

  FaPrefillWarp<D, KT, CAP> w;
  w.init(sq + warp * 16 * LD, qpos + row0 + warp * 16, nrows - warp * 16, mk);
  cp_async_wait<1>();          // the query tile
  __syncthreads();
  w.load_q();

  for (int j = 0; j < kr.ntiles; ++j) {
    cp_async_wait<0>();        // tile j is in shared memory ...
    __syncthreads();           // ... for every thread, and tile j - 1 is read
    const int key0 = kr.start + j * KT;
    if (j + 1 < kr.ntiles) load_tile((j + 1) & 1, key0 + KT);
    cp_async_commit();
    w.template round<false>(sk + (j & 1) * L::TILE, sv + (j & 1) * L::TILE, nullptr, key0, mk,
                            scale, softcap);
  }
  cp_async_wait<0>();
  w.store(out, sinks, b, T, H, h, row0, warp * 16, nrows, Dv);
}

template <int D, int KT, bool CAP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, int B, int T,
                   int H, int Hkv, int Dk, int Dv, const long long* st, float scale,
                   float softcap, int swa, int chunk, cudaStream_t s) {
  static bool smem_set = false;
  constexpr int smem = Layout<D, KT>::BYTES;
  auto kern = fa_prefill_kernel<D, KT, CAP>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int tiles = (T + BQ - 1) / BQ;
  if (B > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(H, B, tiles);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kl), static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, Dk, Dv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, swa, chunk);
  return cudaGetLastError();
}

template <int D, int KT>
cudaError_t by_cap(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, int B, int T, int H,
                   int Hkv, int Dk, int Dv, const long long* st, float scale,
                   float softcap, int swa, int chunk, cudaStream_t s) {
  return softcap > 0.f
             ? launch<D, KT, true>(q, k, v, qp, kl, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                                   scale, softcap, swa, chunk, s)
             : launch<D, KT, false>(q, k, v, qp, kl, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                                    scale, softcap, swa, chunk, s);
}

}  // namespace

extern "C" int ik_flash_attention(const void* q, const void* k, const void* v,
                                  const void* q_pos0, const void* kv_len,
                                  const void* sinks, void* out, int B, int T,
                                  int H, int Hkv, int Dk, int Dv, long long sqb,
                                  long long sqt, long long sqh, long long skb,
                                  long long sks, long long skh, long long svb,
                                  long long svs, long long svh, float scale,
                                  float softcap, int swa, int chunk,
                                  void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh};
  auto s = static_cast<cudaStream_t>(stream);
  const int dmax = Dk > Dv ? Dk : Dv;
  cudaError_t e;
  if (dmax <= 64)
    e = by_cap<64, 64>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                       st, scale, softcap, swa, chunk, s);
  else if (dmax <= 128)
    e = by_cap<128, 64>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                        st, scale, softcap, swa, chunk, s);
  else
    e = by_cap<256, 32>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                        st, scale, softcap, swa, chunk, s);
  return static_cast<int>(e);
}
