// Decode / short-chunk flash attention (T <= 16) over the native
// (B, S, Hkv, D) cache slab of one layer.
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention_decode
// (Pallas, _fa_decode_common / _fa_dec_kernel with quant="none").
//
// q: bf16 (B, T, H, Dk); k: bf16 (B, S, Hkv, Dk); v: bf16 (B, S, Hkv, Dv),
// unit last stride, other strides in elements (a layer slab kv.k[i] is a
// view); q_pos0, kv_len: int32 (B,) on the device; sinks: f32 (H,) or null.
// out: bf16 (B, T, H, Dv) contiguous. Same function as the prefill kernel.
//
// Bound on the H100: the bytes of the filled K/V rows. Design: the query
// rows of one kv head's GQA group (row = head_in_group * T + token, as the
// TPU kernel packs them) go through the tensor cores together, so each
// K/V tile is read once per kv head for all its q heads. One block per
// (batch, kv head); its warps split the live key range into interleaved
// 32-key tiles, each warp running its own online softmax in its own shared
// memory, and the block merges the warps' (max, sum, output) at the end.
// Any S and any head dim up to 256 that is a multiple of 8. Only B * Hkv
// blocks run (8 at batch 1 for an 8-kv-head model), which caps the share
// of the card's bandwidth it reaches: a split over blocks is later work.
#include "fa_common.cuh"

namespace {

constexpr int KT = 32;

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_decode_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_pos0, const int* __restrict__ kv_len,
                 const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                 int T, int H, int Hkv, int Dk, int Dv, int MTB, long long sqb,
                 long long sqt, long long sqh, long long skb, long long sks,
                 long long skh, long long svb, long long svs, long long svh,
                 float scale, float softcap, int swa, int chunk) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = KT + 8;
  constexpr int WARP_BYTES_KV = (KT * LDK + D * LDV) * 2;
  constexpr int WARP_BYTES_CMB = (32 + 16 * D) * 4;
  constexpr int WARP_BYTES = WARP_BYTES_KV > WARP_BYTES_CMB ? WARP_BYTES_KV : WARP_BYTES_CMB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [MTB*16][LDQ]
  unsigned char* warp_area = smem_raw + MTB * 16 * LDQ * 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int rep = H / Hkv, R = rep * T;
  const int row_base = blockIdx.y * MTB * 16;
  const int ksplit = NW / MTB;
  const int qpos = q_pos0[b];
  const FaMask mk{kv_len[b], swa, chunk};

  {  // the group's query rows, zero past R and past Dk
    constexpr int CH = D / 8;
    for (int c = tid; c < MTB * 16 * CH; c += NW * 32) {
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
  const int key_end = min(mk.kv_len, qpos + T);
  const int key_start = fa_first_key(qpos, mk);
  const __nv_bfloat16* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const __nv_bfloat16* vb = v + (size_t)b * svb + (size_t)hk * svh;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(warp_area + warp * WARP_BYTES);
  __nv_bfloat16* svt = sk + KT * LDK;

  FaWarp<D, KT> st;
  st.init();
  if (row_base + mt * 16 < R) {
    for (int key0 = key_start + ks * KT; key0 < key_end; key0 += ksplit * KT) {
      __syncwarp();
      fa_load_kv<D, KT, LDK, LDV>(sk, svt, kb, vb, sks, svs, key0, key_end, Dk, Dv,
                                  lane, 32);
      __syncwarp();
      st.template step<LDQ, LDK, LDV>(sq + mt * 16 * LDQ, sk, svt, key0, qp0, qp1,
                                      mk, scale, softcap, Dk, Dv);
    }
  }
  st.finish();
  __syncthreads();   // every warp is done with its K/V tiles: reuse them

  // per warp: m[16], l[16], o[16][D] (float)
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
  __syncthreads();

  for (int idx = tid; idx < MTB * 16 * Dv; idx += NW * 32) {
    const int mtl = idx / (16 * Dv), rem = idx % (16 * Dv);
    const int row = rem / Dv, d = rem % Dv;
    const int gr = row_base + mtl * 16 + row;
    if (gr >= R) continue;
    const int tt = gr % T, h = hk * rep + gr / T;
    float mm = FA_NEG;
    for (int w = 0; w < ksplit; ++w) {
      const float* c = reinterpret_cast<const float*>(warp_area + (mtl * ksplit + w) * WARP_BYTES);
      mm = fmaxf(mm, c[row]);
    }
    float sink = 0.f;
    if (sinks != nullptr) {
      sink = sinks[h];
      mm = fmaxf(mm, sink);
    }
    float l = 0.f, o = 0.f;
    for (int w = 0; w < ksplit; ++w) {
      const float* c = reinterpret_cast<const float*>(warp_area + (mtl * ksplit + w) * WARP_BYTES);
      const float f = expf(c[row] - mm);
      l += c[16 + row] * f;
      o += c[32 + row * D + d] * f;
    }
    if (sinks != nullptr) l += expf(sink - mm);
    out[(((size_t)b * T + tt) * H + h) * Dv + d] = __float2bfloat16_rn(o / (l > 0.f ? l : 1.f));
  }
}

template <int D, int NW>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, int B, int T,
                   int H, int Hkv, int Dk, int Dv, const long long* st, float scale,
                   float softcap, int swa, int chunk, cudaStream_t s) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = KT + 8;
  constexpr int kv_bytes = (KT * LDK + D * LDV) * 2;
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
  dim3 grid(B * Hkv, (MT + MTB - 1) / MTB);
  kern<<<grid, NW * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kl), static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, Dk, Dv, MTB, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, swa, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ik_flash_attention_decode(
    const void* q, const void* k, const void* v, const void* q_pos0,
    const void* kv_len, const void* sinks, void* out, int B, int T, int H,
    int Hkv, int Dk, int Dv, long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, float scale, float softcap, int swa, int chunk, void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh};
  auto s = static_cast<cudaStream_t>(stream);
  const int dmax = Dk > Dv ? Dk : Dv;
  cudaError_t e;
  if (dmax <= 64)
    e = launch<64, 8>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                      scale, softcap, swa, chunk, s);
  else if (dmax <= 128)
    e = launch<128, 8>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                       scale, softcap, swa, chunk, s);
  else
    e = launch<256, 4>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv, st,
                       scale, softcap, swa, chunk, s);
  return static_cast<int>(e);
}
