// Flash attention over the MLA latent cache (the DeepSeek-2 family's absorb
// path, any T): many query heads over one kv head of head dims up to
// 576 / 512.
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention (Pallas,
// _fa_kernel) at the shapes models/deepseek2.py gives it: q (B, T, H, 576)
// = [latent-absorbed nope | roped pe] per head, k (B, S, 1, 576) the cached
// [latent | pe] rows, v (B, S, 1, 512) their first 512 columns. Kernel B
// (flash_attention.cu) takes head dims up to 256; this form takes the rest
// where there is one kv head.
//
// q: bf16 (B, T, H, Dk); k: bf16 (B, S, 1, Dk); v: bf16 (B, S, 1, Dv),
// Dk <= 576, Dv <= 512, multiples of 8, unit last strides, 16-byte aligned
// rows; q_pos0, kv_len: int32 (B,) on the device. out: bf16 (B, T, H, Dv)
// contiguous. Causal online softmax against the cache fill level (no
// window, chunk, softcap or sinks: the wrapper refuses them). Rows are
// packed MQA-style: a row tile holds query rows row = t * H + h of one
// batch, so the one latent head is read once for all heads; a row's causal
// bound comes from its position t, and the tiles of the last rows (the
// longest key ranges) launch first. Two kernels, chosen on the host by
// ops/flash_attention.mla_plan from the shapes and the SM count:
//
// fa_mla_wgmma_kernel (prefill, T * H > 128 rows). Bound by bf16
// tensor-core work on the live scores ((Dk + Dv) * 2 flops a live (row,
// key) pair: 0.068 ms at T = 512 over 4,000 keys). Hopper reaches that rate
// only through the warpgroup MMA, so the design is Hopper's attention shape:
// - 64 query rows a block; three warpgroups: a producer, whose one thread
//   keeps TMA loads in flight under full/empty mbarriers (Q once, then a
//   two-stage ring of BN-key K tiles), and two consumers that own output
//   columns 0-255 and 256-511 (a 64 x 256 f32 accumulator, 128 registers a
//   thread; setmaxnreg moves registers from the producer to them);
// - every tile is 9 boxes of 64 columns in the 128-byte swizzle that wgmma
//   reads; V is the first 512 columns of the same K tile (v a view of k),
//   read as the transposed (MN-major) B operand, so each key row is loaded
//   once (BN = 64: Q 72 KB + 2 x 72 KB of K + 8 KB of P in 227 KB);
//   where v is a tensor of its own it has its own boxes in each stage and
//   BN = 32;
// - S = Q K^T over all 576 dims is one accumulator (wgmma m64nBNk16, Q and
//   K both K-major in shared memory). Consumer 0 computes it and the
//   softmax (schedule (a); (b), the two consumers taking alternate tiles
//   each with its own softmax, needs a second P buffer and a row-max
//   exchange a tile, and Q + two 64-key stages + two P buffers is 237,568
//   bytes), keeps P in registers as the A fragment of its own O += P V
//   (wgmma m64n256k16) and publishes P (bf16, swizzled) and the rows'
//   rescale factors in shared memory for consumer 1's P V. A tile: P V of
//   tile j, then S of tile j + 1 behind it; P V is done first and its
//   stage goes back to the producer at once, so the load of tile j + 2
//   overlaps S and the softmax of tile j + 1;
// - the first k16 step of S writes its registers without reading them (no
//   value the softmax left there is an MMA input), the softmax touches S
//   only once S is waited for, and P's fragments stay pinned until their
//   MMAs are done: else ptxas serializes every warpgroup MMA of the kernel
//   (it did, at 0.28-0.31 ms for row 2m against 0.21-0.22);
// - only tiles past the least row bound of a warp are masked; rows past
//   the block's last live key (stale cache rows, perhaps not finite: TMA
//   zero-fills only past the tensor) get p = 0 and, in the one tail tile,
//   zeroed V rows, so 0 x NaN never reaches O.
// What bounds it now is consumer 0's chain a tile (clock64 at 2m, cycles):
// issuing S's 36 MMAs ~1,750 (Q read from shared memory at every m64n64k16
// step), the softmax ~770, P V and the rescale ~380, the publish ~350; the
// loads alone stream the tiles in a quarter of the kernel's time. 4 stages
// of 32 keys, pairs of blocks sharing K tiles by TMA multicast, S as two
// 32-key chains, and the softmax beside P V ran slower or no faster
// (PERF.md).
//
// fa_mla_decode_kernel (decode, T * H <= 128 rows: 16 at T = 1, H = 16).
// Bound by the cache bytes (4,000 keys x 1,152 bytes: 1.4 us at
// 3.35 TB/s); its tensor work is small (0.14 GFLOP), so mma.sync.m16n8k16
// serves. A block takes a 16-row tile (no rows padded to 64) and a range of
// 32-key chunks; the keys are split over enough blocks to put every SM to
// reading, and a block puts its whole range in flight at once (a cp.async
// ring of up to 5 chunks; rows past the range are zero-filled, never read).
// Its 8 warps split a chunk's scores by 8 keys x half the dims, sum the
// halves through shared memory (half 0 + half 1), each run the same
// softmax on the 32 keys and multiply P into its own 64 output columns.
//
// Key splits (both forms, where B x row tiles leave SMs idle): each split
// block writes its float32 (max, sum, unnormalised output) to a scratch
// slot, then the group's blocks merge together: a cooperative launch
// (every block resident) lets each block wait for its group's count and
// merge its own share of the (row, 4-column) outputs (spread_merge); one
// launch, no host sync, and a call repeats bit for bit. The last block to
// leave resets the group's two counters.
//
// The softmax keeps kernel B's float arithmetic (scale, expf, p rounded to
// bf16 for the PV product).
#include "fa_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MLA_DK = 576, MLA_DV = 512;   // the largest head dims taken
constexpr int MLA_SMEM_MAX = 232448;        // dynamic shared memory a block may use
constexpr int MLA_MAX_SPLITS = 256;         // key splits of a row tile

IK_DEV void bar_named(int id, int n) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory"); }

IK_DEV int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A row tile's live keys [0, end) cut into `used` ranges of `per` keys, a
// whole number of KT-key tiles (the last may be shorter); used <= 1 is the
// whole range in one block (ops/flash_attention.mla_key_ranges).
struct KeySplit {
  int lo, hi, used;
  bool whole;
  IK_DEV KeySplit(int end, int splits, int split, int kt) {
    const int per = max(((end + splits - 1) / splits + kt - 1) / kt * kt, kt);
    used = (end + per - 1) / per;
    whole = used <= 1;
    lo = whole ? 0 : split * per;
    hi = whole ? end : min(lo + per, end);
  }
  // blocks past the last range, and every block but the first of a whole range
  IK_DEV bool idle(int split) const { return whole ? split > 0 : split >= used; }
};

// The merge of one group's split slots p0 [used][ROWS * (Dv + 2)]: o
// [ROWS][Dv], m [ROWS], l [ROWS]. Called by NT threads (tid 0 .. NT - 1,
// named barrier 1) of the block of split `split` once its own slot is
// written; cnt: the group's two zeroed counters (arrived, left); ob: the
// group's first output row. Each block merges its share of the group's
// (row, 4 columns) outputs, a team of ts lanes an output (as many as fill
// the block, at most 16): lane q folds splits q, q + ts, ... into a running
// (max, sum, output), issuing every load before the arithmetic that needs
// it (the merge is bound by the latency of its reads from L2), and the
// team's states are folded by a fixed butterfly; the order is fixed by the
// shapes, so a call repeats bit for bit.
struct MergeState {
  float m, l;
  float4 o;
  IK_DEV void fold(float m2, float l2, const float4& o2) {
    const float mn = fmaxf(m, m2), fa = expf(m - mn), fb = expf(m2 - mn);
    l = l * fa + l2 * fb;
    o.x = o.x * fa + o2.x * fb;
    o.y = o.y * fa + o2.y * fb;
    o.z = o.z * fa + o2.z * fb;
    o.w = o.w * fa + o2.w * fb;
    m = mn;
  }
};

template <int ROWS, int NT>
IK_DEV void spread_merge(const float* __restrict__ p0, int used, int split, int nrows, int Dv,
                         __nv_bfloat16* __restrict__ ob, int* cnt, int tid) {
  static_assert(NT % 32 == 0, "whole warps");
  const size_t psz = (size_t)ROWS * (Dv + 2);
  __threadfence();
  bar_named(1, NT);
  if (tid == 0) {
    atomicAdd(&cnt[0], 1);
    while (ld_acquire(&cnt[0]) < used) __nanosleep(32);
    __threadfence();
  }
  bar_named(1, NT);
  const int per_row = Dv / 4, items = nrows * per_row, ipb = (items + used - 1) / used;
  const int i0 = split * ipb, i1 = min(i0 + ipb, items);
  int ts = 16;
  while (ts > 1 && ts * ipb > NT) ts >>= 1;
  const int teams = NT / ts, q = tid % ts, team = tid / ts;
  for (int base = i0; base < i1; base += teams) {
    const int it = base + team;
    const bool act = it < i1;
    const int r = act ? it / per_row : 0, c = act ? (it % per_row) * 4 : 0;
    const float* px = p0 + (size_t)r * Dv + c;          // split j's output at px + j psz
    const float* pm = p0 + (size_t)ROWS * Dv + r;       // ... its m, and l ROWS on
    MergeState st{FA_NEG, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
    constexpr int U = 4;
    int j = act ? q : used;
    for (; j + (U - 1) * ts < used; j += U * ts) {
      float mj[U], lj[U];
      float4 xj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t off = (size_t)(j + u * ts) * psz;
        mj[u] = __ldcg(pm + off);
        lj[u] = __ldcg(pm + off + ROWS);
        xj[u] = __ldcg(reinterpret_cast<const float4*>(px + off));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) st.fold(mj[u], lj[u], xj[u]);
    }
    for (; j < used; j += ts) {
      const size_t off = (size_t)j * psz;
      st.fold(__ldcg(pm + off), __ldcg(pm + off + ROWS),
              __ldcg(reinterpret_cast<const float4*>(px + off)));
    }
    for (int o = ts / 2; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, st.m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, st.l, o);
      float4 o2;
      o2.x = __shfl_xor_sync(0xffffffffu, st.o.x, o);
      o2.y = __shfl_xor_sync(0xffffffffu, st.o.y, o);
      o2.z = __shfl_xor_sync(0xffffffffu, st.o.z, o);
      o2.w = __shfl_xor_sync(0xffffffffu, st.o.w, o);
      st.fold(m2, l2, o2);
    }
    if (act && q == 0) {
      const float inv = 1.f / (st.l > 0.f ? st.l : 1.f);
      __nv_bfloat16* o = ob + (size_t)r * Dv + c;
      *reinterpret_cast<uint32_t*>(o) = pack_bf16x2(st.o.x * inv, st.o.y * inv);
      *reinterpret_cast<uint32_t*>(o + 2) = pack_bf16x2(st.o.z * inv, st.o.w * inv);
    }
  }
  // the last block to leave resets the counters for the next call
  bar_named(1, NT);
  if (tid == 0 && atomicAdd(&cnt[1], 1) == used - 1) {
    cnt[0] = 0;
    cnt[1] = 0;
  }
}

// One launch of either form: cooperative where blocks of a group wait for
// each other (splits > 1), so that every block is resident.
template <typename Kern, typename... Args>
cudaError_t launch_grid(Kern kern, dim3 grid, int threads, int smem, bool coop, cudaStream_t s,
                        Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = coop ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ------------------------------------------------------------ decode -----
namespace dec {

constexpr int RT = 16;                  // query rows of a tile
constexpr int KC = 32;                  // keys a chunk
constexpr int NW = 8, NT = NW * 32;     // 4 key groups x 2 halves of the dims; 8 column slices
constexpr int LDK = MLA_DK + 8;         // padded Q / K row (bf16): 73 16-byte units
constexpr int LDV = MLA_DV + 8;         // padded V row (bf16)
constexpr int DH = MLA_DK / 2;          // a warp's half of the QK^T dims
constexpr int CW = MLA_DV / NW;         // a warp's output columns

template <bool ALIAS>
struct Layout {
  static constexpr int Q = RT * LDK;                  // bf16
  static constexpr int KCH = KC * LDK;                // bf16 a chunk
  static constexpr int VCH = ALIAS ? 0 : KC * LDV;
  static constexpr int X = 2 * 2 * RT * KC;           // floats: [chunk parity][half][RT][KC]
  static constexpr int FIXED = Q * 2 + X * 4;
  static constexpr int FIT = (MLA_SMEM_MAX - FIXED) / ((KCH + VCH) * 2);
  static constexpr int STAGES = FIT < 5 ? FIT : 5;
  static constexpr int BYTES = FIXED + STAGES * (KCH + VCH) * 2;
  static_assert(STAGES >= 2, "a two-chunk ring at least");
};

// Rows [row0, row0 + ROWS) of a bf16 matrix of row stride rs into shared
// memory (ROWS x LD) by 16-byte cp.async copies; zero at rows >= end and at
// dims >= d (nothing past them is read).
template <int W, int ROWS, int LD>
IK_DEV void load_rows(__nv_bfloat16* s, const __nv_bfloat16* base, long long rs, int row0, int end,
                      int d, int tid) {
  constexpr int CH = W / 8, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int c = tid + i * NT;
    if (c < N) {
      const int r = c / CH, d0 = (c % CH) * 8;
      const bool ok = d0 < d && row0 + r < end;
      cp_async16_zfill(s + r * LD + d0, ok ? base + (size_t)(row0 + r) * rs + d0 : base,
                       ok ? 16 : 0);
    }
  }
}

template <bool ALIAS>
__global__ void __launch_bounds__(NT, 1)
fa_mla_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos0,
                     const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part, int* __restrict__ counters, int splits, int T,
                     int H, int S, int Dk, int Dv, long long sqb, long long sqt, long long sqh,
                     long long skb, long long sks, long long svb, long long svs, float scale) {
  using Lt = Layout<ALIAS>;
  constexpr int ST = Lt::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [RT][LDK]
  float* sx = reinterpret_cast<float*>(sq + Lt::Q);                   // [2][2][RT][KC]
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(sx + Lt::X);   // [ST][KC][LDK]
  __nv_bfloat16* sv = sk + ST * Lt::KCH;                              // [ST][KC][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, lr = lane & 7, lm = lane >> 3;
  const int b = blockIdx.y, tile = gridDim.x - 1 - blockIdx.x, split = blockIdx.z;
  const int R = T * H, row0 = tile * RT, nrows = min(RT, R - row0);
  const int qpos = q_pos0[b], kvl = min(kv_len[b], S);
  const int end = max(min(kvl, qpos + (row0 + nrows - 1) / H + 1), 0);
  const KeySplit ks(end, splits, split, KC);
  if (ks.idle(split)) return;
  const int lo = ks.lo, hi = ks.hi;
  const int nch = hi > lo ? (hi - lo + KC - 1) / KC : 0;
  const __nv_bfloat16* kb = k + (size_t)b * skb;
  const __nv_bfloat16* vb = v + (size_t)b * svb;
  auto load_chunk = [&](int stage, int c) {
    load_rows<MLA_DK, KC, LDK>(sk + stage * Lt::KCH, kb, sks, lo + c * KC, hi, Dk, tid);
    if (!ALIAS) load_rows<MLA_DV, KC, LDV>(sv + stage * Lt::VCH, vb, svs, lo + c * KC, hi, Dv, tid);
  };

  // the tile's query rows (row r = t * H + h), zero past R and past Dk, in
  // the first group with chunk 0; ST - 1 chunks in flight before the loop
  {
    constexpr int CH = MLA_DK / 8, N = RT * CH;
    const __nv_bfloat16* qb = q + (size_t)b * sqb;
#pragma unroll
    for (int i = 0; i < (N + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (c < N) {
        const int r = c / CH, d0 = (c % CH) * 8, gr = row0 + r;
        const bool ok = d0 < Dk && r < nrows;
        cp_async16_zfill(sq + r * LDK + d0,
                         ok ? qb + (size_t)(gr / H) * sqt + (size_t)(gr % H) * sqh + d0 : qb,
                         ok ? 16 : 0);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < nch) load_chunk(c, c);
    cp_async_commit();
  }

  // lane rows g and g + 8: their key bound (0 past the tile's rows) and the
  // least bound of the tile (chunks below it need no mask)
  int rhi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + g + 8 * r;
    rhi[r] = g + 8 * r < nrows ? min(min(qpos + gr / H + 1, kvl), hi) : 0;
  }
  const int wmin = __reduce_min_sync(0xffffffffu, min(rhi[0], rhi[1]));
  const int kg = warp & 3, hf = warp >> 2;     // this warp's 8 keys of a chunk, half of the dims
  float o[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
  uint32_t qa[DH / 16][4];                      // Q's A fragments of this warp's half

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<ST - 2>();     // chunk c (and Q) in shared memory ...
    __syncthreads();             // ... for every thread; chunk c - 1's stage is free
    {
      const int cn = c + ST - 1;
      if (cn < nch) load_chunk(cn % ST, cn);
      cp_async_commit();
    }
    if (c == 0) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        ldmatrix_x4(qa[kd], sq + (lr + (lm & 1) * 8) * LDK + hf * DH + kd * 16 + (lm >> 1) * 8);
    }
    const __nv_bfloat16* skc = sk + (c % ST) * Lt::KCH;

    // partial scores: 16 rows x this warp's 8 keys over its half of the
    // dims (two accumulators, even and odd k16 steps)
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kd = 0; kd < DH / 32; ++kd) {
      uint32_t kf[4];
      ldmatrix_x4(kf, skc + (8 * kg + lr) * LDK + hf * DH + kd * 32 + lm * 8);
      mma_bf16_16816(s0, qa[2 * kd], kf);
      mma_bf16_16816(s1, qa[2 * kd + 1], kf + 2);
    }
    float* xw = sx + ((c & 1) * 2 + hf) * RT * KC;
    *reinterpret_cast<float2*>(xw + g * KC + 8 * kg + 2 * t4) = make_float2(s0[0] + s1[0], s0[1] + s1[1]);
    *reinterpret_cast<float2*>(xw + (g + 8) * KC + 8 * kg + 2 * t4) =
        make_float2(s0[2] + s1[2], s0[3] + s1[3]);
    __syncthreads();

    // every warp: the chunk's 32 scores of the 16 rows (half 0 + half 1),
    // in the mma accumulator layout, and the same online softmax
    const float* x0 = sx + (c & 1) * 2 * RT * KC;
    const float* x1 = x0 + RT * KC;
    const int key0 = lo + c * KC;
    float s[KC / 8][4];
#pragma unroll
    for (int i = 0; i < KC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (g + 8 * (e >> 1)) * KC + 8 * i + 2 * t4 + (e & 1);
        s[i][e] = (x0[idx] + x1[idx]) * scale;
      }
    if (key0 + KC > wmin) {
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * i + 2 * t4 + (e & 1) >= rhi[e >> 1]) s[i][e] = FA_NEG;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < KC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < KC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[i][e], ex = expf(x - mx[e >> 1]);   // a select, no branch
        const float p = (x <= 0.1f * FA_NEG) ? 0.f : ex;
        s[i][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over this warp's columns: V's fragments by ldmatrix.trans of
    // row-major V (the chunk's first columns where v is a view of k)
    if (warp * CW < Dv) {
      const __nv_bfloat16* svc = ALIAS ? skc : sv + (c % ST) * Lt::VCH;
      constexpr int LDT = ALIAS ? LDK : LDV;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int np = 0; np < CW / 16; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, svc + (kk * 16 + (lm & 1) * 8 + lr) * LDT + warp * CW + np * 16 +
                                    (lm >> 1) * 8);
          mma_bf16_16816(o[2 * np], a, vf);
          mma_bf16_16816(o[2 * np + 1], a, vf + 2);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (ks.whole) {              // out row (b, t, h) = b * R + row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= nrows) continue;
      __nv_bfloat16* ob = out + ((size_t)b * R + row0 + row) * Dv;
      const float f = 1.f / ((l[r] > 0.f) ? l[r] : 1.f);
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const int col = warp * CW + n * 8 + 2 * t4;
        if (col < Dv)
          *reinterpret_cast<uint32_t*>(ob + col) = pack_bf16x2(o[n][2 * r] * f, o[n][2 * r + 1] * f);
      }
    }
    return;
  }

  // a split: the slot [group][split] = o [RT][Dv], m [RT], l [RT]; then the
  // group's blocks merge
  const int gi = b * gridDim.x + tile;
  const size_t psz = (size_t)RT * (Dv + 2);
  float* pb = part + ((size_t)gi * splits + split) * psz;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
      const int col = warp * CW + n * 8 + 2 * t4;
      if (col < Dv)
        *reinterpret_cast<float2*>(pb + (size_t)row * Dv + col) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    if (warp == 0 && t4 == 0) {
      pb[(size_t)RT * Dv + row] = m[r];
      pb[(size_t)RT * Dv + RT + row] = l[r];
    }
  }
  spread_merge<RT, NT>(part + (size_t)gi * splits * psz, ks.used, split, nrows, Dv,
                       out + ((size_t)b * R + row0) * Dv, counters + 2 * gi, tid);
}

template <bool ALIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp, const void* kl,
                   void* out, void* part, void* counters, int splits, int B, int T, int H,
                   int S, int Dk, int Dv, const long long* st, float scale, cudaStream_t s) {
  static bool smem_set = false;
  constexpr int smem = Layout<ALIAS>::BYTES;
  auto kern = fa_mla_decode_kernel<ALIAS>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const long long tiles = ((long long)T * H + RT - 1) / RT;
  if (B > 65535 || splits > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_grid(kern, dim3((unsigned)tiles, B, splits), NT, smem, splits > 1, s,
                     static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                     static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
                     static_cast<const int*>(kl), static_cast<__nv_bfloat16*>(out),
                     static_cast<float*>(part), static_cast<int*>(counters), splits, T, H, S,
                     Dk, Dv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], scale);
}

}  // namespace dec

// ------------------------------------------------------------ prefill ----
namespace wg {

constexpr int BM = 64;                  // query rows of a block
constexpr int NBOX = MLA_DK / 64;       // 64-column boxes of a Q or K row (9)
constexpr int VBOX = MLA_DV / 64;       // ... of a V row (8)
constexpr int NT = 384;                 // producer + two consumer warpgroups

template <int BN, int STAGES, bool ALIAS>
struct Layout {
  static constexpr int QBOX = BM * 128, KBOX = BN * 128;   // bytes of a box
  static constexpr int Q = NBOX * QBOX;
  static constexpr int K = NBOX * KBOX;
  static constexpr int V = ALIAS ? 0 : VBOX * KBOX;
  static constexpr int STAGE = K + V;
  static constexpr int P = BM * 128;                       // P: 64 rows of 128 bytes
  static constexpr int OFF_K = Q, OFF_P = Q + STAGES * STAGE, OFF_F = OFF_P + P;
  static constexpr int OFF_BAR = OFF_F + 3 * BM * 4;       // alpha, m, l of the rows
  static constexpr int BYTES = 1024 + OFF_BAR + (2 * STAGES + 3) * 8;
  static_assert(BYTES <= MLA_SMEM_MAX, "shared memory of one block");
};

// S (f32, 64 x 64) = A (bf16, 64 x 16) * B (bf16, 64 x 16)^T (+ S if scale_d),
// both K-major in shared memory.
IK_DEV void wgmma_qk_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (f32, 64 x 32) = A (bf16, 64 x 16) * B (bf16, 32 x 16)^T (+ S if scale_d),
// both K-major in shared memory.
IK_DEV void wgmma_qk_n32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (f32, 64 x 64) = A (bf16, 64 x 16) * B (bf16, 64 x 16)^T: the first
// k16 step, which reads no accumulator (scale-d false).
IK_DEV void wgmma_qk_n64_first(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// S (f32, 64 x 32) = A (bf16, 64 x 16) * B (bf16, 32 x 16)^T: the first
// k16 step, which reads no accumulator (scale-d false).
IK_DEV void wgmma_qk_n32_first(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

// O (f32, 64 x 256) += P (bf16, 64 x 16, registers) * V (bf16, 16 x 256,
// MN-major in shared memory: the transposed B operand).
IK_DEV void wgmma_pv_rs(float* d, const uint32_t (&a)[4], uint64_t db, int scale_d) {
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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

// O (f32, 64 x 256) += P (bf16, 64 x 16, K-major in shared memory) * V
// (bf16, 16 x 256, MN-major in shared memory).
IK_DEV void wgmma_pv_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// Descriptor of the transposed (MN-major) B operand in 128-byte swizzled
// boxes of 64 columns: a box's rows (keys) 128 bytes apart, 8-row groups
// 1,024 apart (SBO), the next 64 columns `box` bytes on (LBO).
IK_DEV uint64_t desc_mn_sw128(const void* p, int box) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(box >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// S's k16 step: the first writes S without reading it, so that no value
// the softmax left in S's registers is an input of the MMA (ptxas would
// serialize every warpgroup MMA of the kernel).
template <int BN>
IK_DEV void wgmma_qk(float* d, uint64_t da, uint64_t db, bool first) {
  if constexpr (BN == 64) {
    if (first) wgmma_qk_n64_first(d, da, db);
    else wgmma_qk_n64(d, da, db, 1);
  } else {
    if (first) wgmma_qk_n32_first(d, da, db);
    else wgmma_qk_n32(d, da, db, 1);
  }
}

template <int BN, int STAGES, bool ALIAS>
__global__ void __launch_bounds__(NT, 1)
fa_mla_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const int* __restrict__ q_pos0,
                    const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counters, int splits, int T,
                    int H, int S, int Dk, int Dv, float scale) {
  using L = Layout<BN, STAGES, ALIAS>;
  constexpr int NS = BN / 2;             // score registers a thread
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned boxes: the swizzle pattern repeats every 8 rows
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = base;                                   // [NBOX][BM][128]
  unsigned char* sk = base + L::OFF_K;                        // [STAGES][NBOX (+VBOX)][BN][128]
  unsigned char* sp = base + L::OFF_P;                        // [BM][128]
  float* salpha = reinterpret_cast<float*>(base + L::OFF_F);  // [BM]
  float* sm = salpha + BM;                                    // [BM]
  float* sl = sm + BM;                                        // [BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  uint64_t* pfull = qbar + 1;            // consumer 0 published P and alpha
  uint64_t* pempty = pfull + 1;          // consumer 1 is done with them

  const int tid = threadIdx.x, wgi = tid / 128, lane = tid & 31;
  const int b = blockIdx.y, tile = gridDim.x - 1 - blockIdx.x, split = blockIdx.z;
  const int R = T * H, row0 = tile * BM, nrows = min(BM, R - row0);
  const int qpos = q_pos0[b], kvl = min(kv_len[b], S);
  const int end = max(min(kvl, qpos + (row0 + nrows - 1) / H + 1), 0);
  const KeySplit ks(end, splits, split, BN);
  // boxes of 64 columns that hold Q / K columns and V columns: TMA loads
  // no box wholly past Dk or Dv
  const int nbox = (Dk + 63) / 64, nvbox = (Dv + 63) / 64;
  if (ks.idle(split)) return;
  const int lo = ks.lo, hi = ks.hi;
  const int ntiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // the 8 consumer warps
    }
    mbar_init(qbar, 1);
    mbar_init(pfull, 4);
    mbar_init(pempty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // producer: Q once, then the ring of K (and V) tiles
    setmaxnreg_dec<40>();
    if (tid == 0) {
      mbar_expect_tx(qbar, nbox * L::QBOX);
      for (int c = 0; c < nbox; ++c)
        tma_load_2d(sq + c * L::QBOX, &mq, qbar, 64 * c, b * R + row0);
      const uint32_t tx = (nbox + (ALIAS ? 0 : nvbox)) * L::KBOX;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES, key = lo + j * BN;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], tx);
        unsigned char* st = sk + s * L::STAGE;
        for (int c = 0; c < nbox; ++c) tma_load_3d(st + c * L::KBOX, &mk, &full[s], 64 * c, key, b);
        if (!ALIAS)
          for (int c = 0; c < nvbox; ++c)
            tma_load_3d(st + L::K + c * L::KBOX, &mv, &full[s], 64 * c, key, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wgi - 1;                // consumer: output columns 256 cw .. 256 cw + 255
  const int ctid = tid - 128, w = (tid / 32) & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w + g;             // this thread's rows r0 and r0 + 8 of the block
  // V of stage s, k16 step kk, for this consumer's 256 columns
  auto desc_v = [&](int s, int kk) {
    return desc_mn_sw128(sk + s * L::STAGE + (ALIAS ? 0 : L::K) + 4 * cw * L::KBOX + kk * 16 * 128,
                         L::KBOX);
  };
  // boxes past Dk (Q, every stage's K) and past Dv (a V of its own) are
  // never loaded: zero them once, so that every MMA takes all boxes
  if (nbox < NBOX || (!ALIAS && nvbox < VBOX)) {
    for (int c = nbox; c < NBOX; ++c)
      for (int i = ctid; i < L::QBOX / 16; i += 256)
        reinterpret_cast<uint4*>(sq + c * L::QBOX)[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int st = 0; st < STAGES; ++st) {
      unsigned char* kt = sk + st * L::STAGE;
      for (int c = nbox; c < NBOX; ++c)
        for (int i = ctid; i < L::KBOX / 16; i += 256)
          reinterpret_cast<uint4*>(kt + c * L::KBOX)[i] = make_uint4(0u, 0u, 0u, 0u);
      for (int c = ALIAS ? VBOX : nvbox; c < VBOX; ++c)
        for (int i = ctid; i < L::KBOX / 16; i += 256)
          reinterpret_cast<uint4*>(kt + L::K + c * L::KBOX)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
    bar_named(1, 256);
  }
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float mrow[2] = {FA_NEG, FA_NEG}, lrow[2] = {0.f, 0.f};

  if (cw == 0) {
    // S = Q K^T over all dims, the softmax, P to registers and to shared
    // memory, this consumer's P V, then the next tile's S
    int rhi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = row0 + r0 + 8 * r;
      rhi[r] = r0 + 8 * r < nrows ? min(min(qpos + gr / H + 1, kvl), hi) : 0;
    }
    const int wmin = __reduce_min_sync(0xffffffffu, min(rhi[0], rhi[1]));
    float s[NS];
    uint32_t pa[BN / 16][4];             // P of the tile whose P V runs
    float an[2] = {1.f, 1.f};            // its row rescale factors
    // S's MMAs of stage st (the first writes S without reading it)
    auto issue_s = [&](int st) {
      const unsigned char* kt = sk + st * L::STAGE;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NBOX; ++c) {
        const uint64_t da = desc_sw128(sq + c * L::QBOX), db = desc_sw128(kt + c * L::KBOX);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_qk<BN>(s, da + 2 * kk, db + 2 * kk, (c | kk) == 0);
      }
      wgmma_commit();
      fence_regs<NS>(s);
    };
    // The online softmax of tile jt, in place on S's registers (their MMAs
    // are done): s[i] becomes p, an the rows' rescale factors, m and l
    // updated. s[4i + e]: row r0 + 8 (e >> 1), key key0 + 8i + 2t + (e & 1).
    auto softmax = [&](int jt) {
      const int key0 = lo + jt * BN;
      if (key0 + BN > wmin) {              // some row of the warp does not see the whole tile
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (key0 + 8 * (i >> 2) + 2 * t + (i & 1) >= rhi[(i >> 1) & 1]) s[i] = FA_NEG;
          else s[i] *= scale;
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] *= scale;
      }
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      an[0] = expf(mrow[0] - mx[0]);
      an[1] = expf(mrow[1] - mx[1]);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        // expf of every score, then a select: a branch around each expf
        // leaves one dependent chain an element and took 3.5x as long
        const float x = s[i], e = expf(x - mx[(i >> 1) & 1]);
        s[i] = (x <= 0.1f * FA_NEG) ? 0.f : e;
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lrow[r] = lrow[r] * an[r] + rs[r];
        mrow[r] = mx[r];
      }
    };
    // P of tile jt to registers (bf16, the A fragment of k16 step kk: {s[8kk
    // + 2h], s[8kk + 2h + 1]}) and, for consumer 1, to shared memory with
    // the rows' rescale factors; first the tail tile's stale V rows are
    // zeroed (p is 0 there, but 0 x NaN is NaN)
    auto publish = [&](int jt) {
      const int st = jt % STAGES, key0 = lo + jt * BN;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) pa[kk][h] = pack_bf16x2(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
      if (key0 + BN > hi) {
        const int z0 = max(hi - key0, 0);
        unsigned char* vt = sk + st * L::STAGE + (ALIAS ? 0 : L::K);
        const int n = (BN - z0) * nvbox * 8;
        for (int i = ctid; i < n; i += 128) {
          const int c = i / ((BN - z0) * 8), rem = i % ((BN - z0) * 8);
          *reinterpret_cast<uint4*>(vt + c * L::KBOX + (z0 + rem / 8) * 128 + (rem % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();
        bar_named(2, 128);
      }
      // 128-byte swizzle: 16-byte chunk i of row r at i ^ (r & 7)
      mbar_wait(pempty, (jt & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          *reinterpret_cast<uint32_t*>(sp + row * 128 + ((i ^ (row & 7)) << 4) + 4 * t) =
              pa[i >> 1][2 * (i & 1) + r];
        }
      }
      if (t == 0) {
        salpha[r0] = an[0];
        salpha[r0 + 8] = an[1];
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(pfull);
    };
    // P V of tile st's stage, after the rows are rescaled; P's fragments
    // and O stay pinned until the MMAs that use them are done
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= an[(i >> 1) & 1];
      fence_regs<128>(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv_rs(o, pa[kk], desc_v(st, kk), 1);
      wgmma_commit();
      fence_regs<128>(o);
    };
    // once P V of stage st is done: its registers are free, the stage goes back
    auto close_pv = [&](int st) {
      fence_regs<128>(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kk][e])::"memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    };

    mbar_wait(qbar, 0);
    if (ntiles > 0) {
      mbar_wait(&full[0], 0);
      issue_s(0);
      wgmma_wait<0>();
      fence_regs<NS>(s);
      softmax(0);
      publish(0);
    }
    // tile j: P V of tile j, then S of tile j + 1 behind it on the tensor
    // cores; P V is done first and its stage goes back at once (the load of
    // tile j + 2 overlaps S and the softmax of tile j + 1)
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      const bool next = j + 1 < ntiles;
      issue_pv(st);
      if (next) {
        const int sn = (j + 1) % STAGES;
        mbar_wait(&full[sn], ((j + 1) / STAGES) & 1);
        issue_s(sn);
        wgmma_wait<1>();                 // P V of tile j is done
        close_pv(st);
        wgmma_wait<0>();                 // ... and S of tile j + 1
        fence_regs<NS>(s);
        softmax(j + 1);
        publish(j + 1);
      } else {
        wgmma_wait<0>();
        close_pv(st);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    }
    if (t == 0) {
      sm[r0] = mrow[0];
      sm[r0 + 8] = mrow[1];
      sl[r0] = lrow[0];
      sl[r0 + 8] = lrow[1];
    }
  } else {
    // consumer 1: P (from shared memory) V over columns 256 .. 511
    const uint64_t dp = desc_sw128(sp);
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      mbar_wait(&full[st], (j / STAGES) & 1);
      mbar_wait(pfull, j & 1);
      const float alpha[2] = {salpha[r0], salpha[r0 + 8]};
#pragma unroll
      for (int i = 0; i < 128; ++i) o[i] *= alpha[(i >> 1) & 1];
      if (Dv > 256) {
        fence_regs<128>(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv_ss(o, dp + 2 * kk, desc_v(st, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<128>(o);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(pempty);
        mbar_arrive(&empty[st]);
      }
    }
  }
  bar_named(1, 256);               // the rows' m and l in shared memory
  const float lr2[2] = {sl[r0], sl[r0 + 8]};

  // o[4i + e]: row r0 + 8 (e >> 1), column 256 cw + 8i + 2t + (e & 1)
  if (ks.whole) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= nrows) continue;
      __nv_bfloat16* ob = out + ((size_t)b * R + row0 + row) * Dv;
      const float f = 1.f / ((lr2[r] > 0.f) ? lr2[r] : 1.f);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 256 * cw + 8 * i + 2 * t;
        if (col < Dv)
          *reinterpret_cast<uint32_t*>(ob + col) =
              pack_bf16x2(o[4 * i + 2 * r] * f, o[4 * i + 2 * r + 1] * f);
      }
    }
    return;
  }

  const int gi = b * gridDim.x + tile;
  const size_t psz = (size_t)BM * (Dv + 2);
  float* pb = part + ((size_t)gi * splits + split) * psz;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 256 * cw + 8 * i + 2 * t;
      if (col < Dv)
        *reinterpret_cast<float2*>(pb + (size_t)row * Dv + col) =
            make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
    }
    if (cw == 0 && t == 0) {
      pb[(size_t)BM * Dv + row] = sm[row];
      pb[(size_t)BM * Dv + BM + row] = lr2[r];
    }
  }
  spread_merge<BM, 256>(part + (size_t)gi * splits * psz, ks.used, split, nrows, Dv,
                        out + ((size_t)b * R + row0) * Dv, counters + 2 * gi, ctid);
}

template <int BN, int STAGES, bool ALIAS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp, const void* kl,
                   void* out, void* part, void* counters, int splits, int B, int T, int H, int S,
                   int Dk, int Dv, const long long* st, float scale, cudaStream_t s) {
  using L = Layout<BN, STAGES, ALIAS>;
  static bool smem_set = false;
  auto kern = fa_mla_wgmma_kernel<BN, STAGES, ALIAS>;
  cudaError_t e = set_smem(kern, L::BYTES, smem_set);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)T * H, tiles = (rows + BM - 1) / BM;
  // q: the contiguous (B * T * H, Dk) rows; k, v: (B, S, D) planes of rows
  if (B > 65535 || splits > 65535 || tiles > 0x7fffffffLL || st[2] != Dk ||
      st[1] != (long long)H * Dk || st[0] != rows * Dk)
    return cudaErrorInvalidValue;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // a batch of one: its plane stride is never stepped over
  const long long kplane = B > 1 ? st[3] : (long long)S * st[4];
  const long long vplane = B > 1 ? st[5] : (long long)S * st[6];
  CUtensorMap mq, mk, mv;
  if ((e = tensor_map_2d(&mq, q, bf, Dk, (uint64_t)B * rows, (uint64_t)Dk * 2, 64, BM, sw)) !=
      cudaSuccess)
    return e;
  if ((e = tensor_map_3d(&mk, k, bf, Dk, S, B, (uint64_t)st[4] * 2, (uint64_t)kplane * 2, 64, BN,
                         sw)) != cudaSuccess)
    return e;
  mv = mk;
  if (!ALIAS && (e = tensor_map_3d(&mv, v, bf, Dv, S, B, (uint64_t)st[6] * 2,
                                   (uint64_t)vplane * 2, 64, BN, sw)) != cudaSuccess)
    return e;
  return launch_grid(kern, dim3((unsigned)tiles, B, splits), NT, L::BYTES, splits > 1, s, mq, mk,
                     mv, static_cast<const int*>(qp), static_cast<const int*>(kl),
                     static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
                     static_cast<int*>(counters), splits, T, H, S, Dk, Dv, scale);
}

}  // namespace wg

}  // namespace

// form: 0 the decode kernel (16-row tiles, mma.sync), 1 the wgmma kernel
// (64-row tiles); ops/flash_attention.mla_plan picks it. alias: v is a view
// of k's first Dv columns (the same base and strides). part / counters: the
// split scratch (groups x splits x rows x (Dv + 2) floats) and 2 x groups
// zeroed counters; unused (may be null) where splits == 1.
extern "C" int ik_flash_attention_mla(const void* q, const void* k, const void* v,
                                      const void* q_pos0, const void* kv_len, void* out,
                                      void* part, void* counters, int form, int splits,
                                      int alias, int B, int T, int H, int S, int Dk, int Dv,
                                      long long sqb, long long sqt, long long sqh,
                                      long long skb, long long sks, long long svb,
                                      long long svs, float scale, void* stream) {
  const long long st[7] = {sqb, sqt, sqh, skb, sks, svb, svs};
  auto s = static_cast<cudaStream_t>(stream);
  if (Dk > MLA_DK || Dv > MLA_DV || Dk % 8 || Dv % 8 || (alias && Dv > Dk) || splits < 1 ||
      splits > MLA_MAX_SPLITS || B < 1 || T < 1 || H < 1 || S < 1 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (form == 0)
    e = alias ? dec::launch<true>(q, k, v, q_pos0, kv_len, out, part, counters, splits, B, T, H,
                                  S, Dk, Dv, st, scale, s)
              : dec::launch<false>(q, k, v, q_pos0, kv_len, out, part, counters, splits, B, T,
                                   H, S, Dk, Dv, st, scale, s);
  else if (form == 1)
    e = alias ? wg::launch<64, 2, true>(q, k, v, q_pos0, kv_len, out, part, counters, splits, B,
                                        T, H, S, Dk, Dv, st, scale, s)
              : wg::launch<32, 2, false>(q, k, v, q_pos0, kv_len, out, part, counters, splits, B,
                                         T, H, S, Dk, Dv, st, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
