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
// Any S and any head dim up to 256 that is a multiple of 8.
#include "fa_common.cuh"

namespace {

constexpr int KT = 32;

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
  __shared__ int last_block;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [MTB*16][LDQ]
  unsigned char* warp_area = smem_raw + MTB * 16 * LDQ * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int rep = H / Hkv, R = rep * T, RB = MTB * 16;
  const int row_base = blockIdx.y * RB;
  const int ksplit = NW / MTB, round = ksplit * KT;
  const int splits = gridDim.z, split = blockIdx.z;
  const int gi = blockIdx.x * gridDim.y + blockIdx.y;     // the group's scratch and counter
  const int qpos = q_pos0[b];
  const FaMask mk{kv_len[b], swa, chunk};

  // this block's keys [lo, hi) of the group's live [key_start, key_end)
  const int key_end = min(mk.kv_len, qpos + T);
  const int key_start = fa_first_key(qpos, mk);
  const int live = max(key_end - key_start, 0);
  const bool whole = splits == 1 || live <= round;
  int lo = key_start, hi = key_end, used = 1;
  if (whole) {
    if (split != 0) return;
  } else {
    const int per = max(((live + splits - 1) / splits + KT - 1) / KT * KT, round);
    used = (live + per - 1) / per;
    if (split >= used) return;
    lo = key_start + split * per;
    hi = min(lo + per, key_end);
  }

  {  // the group's query rows, zero past R and past Dk
    constexpr int CH = D / 8;
    for (int c = tid; c < RB * CH; c += NW * 32) {
      const int r = c / CH, d0 = (c % CH) * 8;
      const int gr = row_base + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gr < R && d0 < Dk) {
        const int tt = gr % T, h = hk * rep + gr / T;
        val = *reinterpret_cast<const uint4*>(q + (size_t)b * sqb + (size_t)tt * sqt +
                                              (size_t)h * sqh + d0);
      }
      *reinterpret_cast<uint4*>(sq + r * LDQ + d0) = val;
    }
  }
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
  st.finish();
  __syncthreads();   // every warp is done with its K/V tiles: reuse them

  // per warp: m[16], l[16], o[16][D] (float)
  {
    const int t = lane & 3;
    float* cm = reinterpret_cast<float*>(warp_area + warp * WARP_BYTES);
    if (t == 0) {
      cm[g] = st.m[0];
      cm[g + 8] = st.m[1];
      cm[16 + g] = st.l[0];
      cm[16 + g + 8] = st.l[1];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      cm[32 + g * D + c] = st.o[n][0];
      cm[32 + g * D + c + 1] = st.o[n][1];
      cm[32 + (g + 8) * D + c] = st.o[n][2];
      cm[32 + (g + 8) * D + c + 1] = st.o[n][3];
    }
  }
  __syncthreads();
  auto warp_part = [&](int mtl, int w) {
    return reinterpret_cast<const float*>(warp_area + (mtl * ksplit + w) * WARP_BYTES);
  };
  // per row, once (the query tile is free): the max over the warps (with
  // the sink where this block gives the output), each warp's factor
  // exp(m_w - max) and the sum l, in warp order; [RB][ksplit + 2]
  float* rowv = reinterpret_cast<float*>(smem_raw);
  const int RV = ksplit + 2;
  for (int r = tid; r < RB; r += NW * 32) {
    const int mtl = r / 16, row = r % 16, gr = row_base + r;
    if (gr >= R) continue;
    float mm = FA_NEG;
    for (int w = 0; w < ksplit; ++w) mm = fmaxf(mm, warp_part(mtl, w)[row]);
    const bool sink_here = whole && sinks != nullptr;
    float sink = 0.f;
    if (sink_here) {
      sink = sinks[hk * rep + gr / T];
      mm = fmaxf(mm, sink);
    }
    float l = 0.f;
    for (int w = 0; w < ksplit; ++w) {
      const float* c = warp_part(mtl, w);
      const float f = expf(c[row] - mm);
      l += c[16 + row] * f;
      rowv[r * RV + w] = f;
    }
    if (sink_here) l += expf(sink - mm);
    rowv[r * RV + ksplit] = mm;
    rowv[r * RV + ksplit + 1] = l;
  }
  __syncthreads();

  // whole: the output; else this split's (max, sum, unnormalised output) a
  // row to the scratch [group][split] = o [RB][Dv], m [RB], l [RB]
  const size_t psz = (size_t)RB * (Dv + 2);
  float* pb = part + ((size_t)gi * splits + split) * psz;
  for (int idx = tid; idx < RB * Dv; idx += NW * 32) {
    const int r = idx / Dv, d = idx % Dv, mtl = r / 16, row = r % 16;
    const int gr = row_base + r;
    if (gr >= R) continue;
    float o = 0.f;
    for (int w = 0; w < ksplit; ++w) o += warp_part(mtl, w)[32 + row * D + d] * rowv[r * RV + w];
    if (whole) {
      const int tt = gr % T, h = hk * rep + gr / T;
      const float l = rowv[r * RV + ksplit + 1];
      out[(((size_t)b * T + tt) * H + h) * Dv + d] = __float2bfloat16_rn(o / (l > 0.f ? l : 1.f));
    } else {
      pb[r * Dv + d] = o;
      if (d == 0) {
        pb[RB * Dv + r] = rowv[r * RV + ksplit];
        pb[RB * Dv + RB + r] = rowv[r * RV + ksplit + 1];
      }
    }
  }
  if (whole) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&counters[gi], 1);
    last_block = prev == used - 1;
    if (last_block) counters[gi] = 0;    // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block merges the splits in split order, with the sinks: per
  // row the max, each split's factor and the sum; then each output
  const float* p0 = part + (size_t)gi * splits * psz;
  const int SV = used + 2;                 // [RB][used + 2], used <= 32
  for (int r = tid; r < RB; r += NW * 32) {
    const int gr = row_base + r;
    if (gr >= R) continue;
    float mm = FA_NEG;
    for (int j = 0; j < used; ++j) mm = fmaxf(mm, __ldcg(p0 + j * psz + RB * Dv + r));
    float sink = 0.f;
    if (sinks != nullptr) {
      sink = sinks[hk * rep + gr / T];
      mm = fmaxf(mm, sink);
    }
    float l = 0.f;
    for (int j = 0; j < used; ++j) {
      const float* pj = p0 + j * psz;
      const float f = expf(__ldcg(pj + RB * Dv + r) - mm);
      l += __ldcg(pj + RB * Dv + RB + r) * f;
      rowv[r * SV + j] = f;
    }
    if (sinks != nullptr) l += expf(sink - mm);
    rowv[r * SV + used] = l;
  }
  __syncthreads();
  for (int idx = tid; idx < RB * Dv; idx += NW * 32) {
    const int r = idx / Dv, d = idx % Dv;
    const int gr = row_base + r;
    if (gr >= R) continue;
    const int tt = gr % T, h = hk * rep + gr / T;
    float o = 0.f;
    for (int j = 0; j < used; ++j) o += __ldcg(p0 + j * psz + r * Dv + d) * rowv[r * SV + j];
    const float l = rowv[r * SV + used];
    out[(((size_t)b * T + tt) * H + h) * Dv + d] = __float2bfloat16_rn(o / (l > 0.f ? l : 1.f));
  }
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
  int MTB = 1;
  while (MTB < MT && MTB < NW) MTB *= 2;
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
