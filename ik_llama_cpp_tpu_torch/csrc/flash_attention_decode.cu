// Decode / short-chunk flash attention (T <= 16) over the native
// (B, S, Hkv, D) cache slab of one layer: split-K flash decoding.
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention_decode
// (Pallas, _fa_decode_common / _fa_dec_kernel with quant="none").
//
// q: bf16 (B, T, H, Dk); k: bf16 (B, S, Hkv, Dk); v: bf16 (B, S, Hkv, Dv),
// unit last stride, other strides in elements (a layer slab kv.k[i] is a
// view); q_pos0, kv_len: int32 (B,) on the device; sinks: f32 (H,) or null.
// out: bf16 (B, T, H, Dv) contiguous. Same function as the prefill kernel.
//
// Bound on the H100 by the bytes of the live K/V rows (a few operations a
// byte). The query rows of one kv head's GQA group (row = head_in_group *
// T + token, as the TPU kernel packs them) go through the tensor cores
// together, so each K/V tile is read once per kv head for all its q heads.
// One block per (batch, kv head, row tile) reaches only 8 of 132 SMs at
// batch 1, so the live key range of each such group is split over
// gridDim.z blocks (ops/flash_attention.decode_split_plan picks the count
// from the SMs, the groups and the slab capacity S, never from kv_len,
// which stays on the device):
// - each block derives its own contiguous range from kv_len / q_pos0: the
//   live keys [key_start, key_end) in chunks of a whole number of 32-key
//   tiles, at least one tile a warp; the split needs no host sync;
// - inside a block the warps take interleaved 32-key tiles, each with its
//   own online softmax (FaWarp: expf, scale then softcap then mask, p
//   rounded to bf16 before PV), and K/V arrive by cp.async in a staggered
//   pair: the next tile's K loads during this tile's PV, its V during the
//   next QK^T. V stays row-major and its B fragments come from
//   ldmatrix.trans;
// - a block writes its merged (max, sum, unnormalised output) in float32
//   to a scratch the wrapper allocates; after a __threadfence the last
//   block of the group to finish (an atomicAdd counter, which it resets to
//   zero) merges the splits in split order, with the sinks, so one launch
//   a call repeats bit for bit;
// - where the live range fits one round of the block's warps (one tile a
//   warp), or the plan gives one split, block 0 alone runs the partition
//   and merge of the kernel's first port and writes the output: the same
//   bits for short ranges (a 128-token prompt and its first decode steps).
// Any S and any head dim up to 256 that is a multiple of 8. The split frame
// (the grid, the blocks' key ranges, the query rows, the merges) is
// fa_decode.cuh, shared with kernel 5 (flash_attention_decode_q.cu).
#include "fa_decode.cuh"

namespace {

constexpr int KT = FA_DEC_KT;

// Keys [key0, key0 + KT) of one kv head, row-major (KT x LD), by one
// warp's cp.async copies; zero at keys >= end and at dims >= d.
template <int D, int LD>
IK_DEV void warp_load_tile(__nv_bfloat16* s, const __nv_bfloat16* base, long long rs,
                           int key0, int end, int d, int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane + 32 * i, r = c / CH, d0 = (c % CH) * 8;
    const bool ok = key0 + r < end && d0 < d;
    cp_async16_zfill(s + r * LD + d0, ok ? base + (size_t)(key0 + r) * rs + d0 : base,
                     ok ? 16 : 0);
  }
}

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_decode_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_pos0, const int* __restrict__ kv_len,
                 const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ counters,
                 int T, int H, int Hkv, int Dk, int Dv, int MTB, long long sqb,
                 long long sqt, long long sqh, long long skb, long long sks,
                 long long skh, long long svb, long long svs, long long svh,
                 float scale, float softcap, int swa, int chunk) {
  constexpr int LDQ = D + 8, LD = D + 8, TILE = KT * LD;
  constexpr int WARP_BYTES_KV = 2 * TILE * 2;
  constexpr int WARP_BYTES_CMB = (32 + 16 * D) * 4;
  constexpr int WARP_BYTES = WARP_BYTES_KV > WARP_BYTES_CMB ? WARP_BYTES_KV : WARP_BYTES_CMB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [MTB*16][LDQ]
  unsigned char* warp_area = smem_raw + MTB * 16 * LDQ * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int qpos = q_pos0[blockIdx.x / Hkv];
  const FaMask mk{kv_len[blockIdx.x / Hkv], swa, chunk};
  FaDecBlock blk;
  if (!fa_dec_block(blk, qpos, mk, T, H, Hkv, MTB, NW)) return;
  const int b = blk.b, hk = blk.hk, R = blk.R, row_base = blk.row_base;
  const int ksplit = blk.ksplit, round = ksplit * KT;
  const int lo = blk.lo, hi = blk.hi, key_end = blk.key_end;

  fa_dec_load_q<D, NW>(sq, q, blk, Dk, sqb, sqt, sqh);
  __syncthreads();

  const int mt = warp / ksplit, ks = warp % ksplit;
  const int r0 = row_base + mt * 16 + g, r1 = r0 + 8;
  const int qp0 = qpos + r0 % T, qp1 = qpos + r1 % T;
  const __nv_bfloat16* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const __nv_bfloat16* vb = v + (size_t)b * svb + (size_t)hk * svh;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(warp_area + warp * WARP_BYTES);
  __nv_bfloat16* sv = sk + TILE;

  FaWarp<D, KT> st;
  st.init();
  int key0 = lo + ks * KT;
  if (row_base + mt * 16 < R && key0 < hi) {
    warp_load_tile<D, LD>(sk, kb, sks, key0, key_end, Dk, lane);
    cp_async_commit();
    warp_load_tile<D, LD>(sv, vb, svs, key0, key_end, Dv, lane);
    cp_async_commit();
    for (;;) {
      cp_async_wait<1>();                 // this tile's K
      __syncwarp();
      float s[KT / 8][4];
      st.template softmax<LDQ, LD>(s, sq + mt * 16 * LDQ, sk, key0, qp0, qp1, mk, scale,
                                   softcap, Dk);
      const int nxt = key0 + round;
      const bool more = nxt < hi;
      __syncwarp();                       // every lane is done with K
      if (more) {
        warp_load_tile<D, LD>(sk, kb, sks, nxt, key_end, Dk, lane);
        cp_async_commit();
        cp_async_wait<1>();               // this tile's V; the next K in flight
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      st.template pv_rows<LD>(s, sv, Dv);
      if (!more) break;
      __syncwarp();                       // every lane is done with V
      warp_load_tile<D, LD>(sv, vb, svs, nxt, key_end, Dv, lane);
      cp_async_commit();
      key0 = nxt;
    }
  }
  fa_dec_finish<D, NW>(st, smem_raw, warp_area, WARP_BYTES, blk, sinks, out, part, counters,
                       Dv);
}

template <int D, int NW>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, void* part, void* counters,
                   int splits, int B, int T, int H, int Hkv, int Dk, int Dv,
                   const long long* st, float scale, float softcap, int swa, int chunk,
                   cudaStream_t s) {
  constexpr int LDQ = D + 8, LD = D + 8;
  constexpr int kv_bytes = 2 * KT * LD * 2;
  constexpr int cmb_bytes = (32 + 16 * D) * 4;
  constexpr int warp_bytes = kv_bytes > cmb_bytes ? kv_bytes : cmb_bytes;
  const int R = (H / Hkv) * T, MT = (R + 15) / 16;
  const int MTB = fa_dec_mtb(R, NW);
  const int smem = MTB * 16 * LDQ * 2 + NW * warp_bytes;
  static bool smem_set = false;
  auto kern = fa_decode_kernel<D, NW>;
  constexpr int smem_max = NW * 16 * LDQ * 2 + NW * warp_bytes;
  cudaError_t e = set_smem(kern, smem_max, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid(B * Hkv, (MT + MTB - 1) / MTB, splits);
  kern<<<grid, NW * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kl), static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), T, H, Hkv, Dk, Dv, MTB, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, swa, chunk);
  return cudaGetLastError();
}

}  // namespace

// splits: blocks a (batch, kv head, row tile) group (gridDim.z, 1-32,
// ops/flash_attention.decode_split_plan). Above 1, part holds
// groups * splits * rows * (Dv + 2) floats and counters one zero int a
// group (the kernel leaves it zero).
extern "C" int ik_flash_attention_decode(
    const void* q, const void* k, const void* v, const void* q_pos0,
    const void* kv_len, const void* sinks, void* out, void* part, void* counters,
    int splits, int B, int T, int H, int Hkv, int Dk, int Dv, long long sqb,
    long long sqt, long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, float scale, float softcap, int swa,
    int chunk, void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh};
  auto s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 32 || (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dmax = Dk > Dv ? Dk : Dv;
  cudaError_t e;
  if (dmax <= 64)
    e = launch<64, 8>(q, k, v, q_pos0, kv_len, sinks, out, part, counters, splits, B, T, H,
                      Hkv, Dk, Dv, st, scale, softcap, swa, chunk, s);
  else if (dmax <= 128)
    e = launch<128, 8>(q, k, v, q_pos0, kv_len, sinks, out, part, counters, splits, B, T, H,
                       Hkv, Dk, Dv, st, scale, softcap, swa, chunk, s);
  else
    e = launch<256, 4>(q, k, v, q_pos0, kv_len, sinks, out, part, counters, splits, B, T, H,
                       Hkv, Dk, Dv, st, scale, softcap, swa, chunk, s);
  return static_cast<int>(e);
}
