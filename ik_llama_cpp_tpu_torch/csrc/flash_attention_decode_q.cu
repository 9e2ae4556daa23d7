// Decode / short-chunk flash attention (T <= 16) over the quantized
// (B, S, Hkv, W) cache slab of one layer, for the four KV codecs of
// ops/kv_quant.py (q8, q4, q6, nl4).
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention_decode_q8
// (Pallas, _fa_decode_common / _fa_dec_kernel with quant q8/q4/q6/nl4).
//
// q: bf16 (B, T, H, Dk), unit last stride; k, v: the codes of one layer,
// int8 or uint8 (B, S, Hkv, W) with W the codec's stored width, unit last
// stride, other strides in bytes (a layer slab kv.k[i] is a view); k_s, v_s:
// float32 (B, S, Hkv) row scales, unit last stride, other strides in
// elements; q_pos0, kv_len: int32 (B,) on the device; sinks: f32 (H,) or
// null. out: bf16 (B, T, H, Dv) contiguous.
//
// Numerics as in the TPU kernel: a score is the float32 product of q with
// code * k_scale (here: the mma over the raw codes, which are exact in bf16,
// then one float32 multiply by the key's scale), the probabilities and
// code * v_scale are both rounded to bf16 before the PV product.
//
// Bound on the H100: the stored bytes of the filled rows (codes and scales),
// a half to an eighth of the bf16 cache's; at a context of a few hundred
// rows that is well under a microsecond, so the kernel is latency-bound
// there. Design: the block layout of flash_attention_decode.cu (one block
// per (batch, kv head), the GQA group's query rows packed as
// row = head_in_group * T + token, the warps split the live keys into
// interleaved 32-key tiles and merge their (max, sum, output) at the end);
// what changes is the tile loader (fa_quant.cuh), which unpacks the stored
// rows into bf16 tiles in shared memory. Only B * Hkv blocks run.
#include "fa_quant.cuh"

namespace {

constexpr int KT = 32;

template <int CODEC, int D, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_decode_q_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                   const float* __restrict__ k_s, const uint8_t* __restrict__ v,
                   const float* __restrict__ v_s, const int* __restrict__ q_pos0,
                   const int* __restrict__ kv_len, const float* __restrict__ sinks,
                   __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int Dk,
                   int Dv, int MTB, long long sqb, long long sqt, long long sqh,
                   long long skb, long long sks, long long skh, long long svb,
                   long long svs, long long svh, long long sksb, long long skss,
                   long long svsb, long long svss, float scale, float softcap,
                   int swa, int chunk) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = KT + 8;
  constexpr int WARP_BYTES_KV = (KT * LDK + D * LDV) * 2 + KT * 4;
  constexpr int WARP_BYTES_CMB = (32 + 16 * D) * 4;
  constexpr int WARP_BYTES = WARP_BYTES_KV > WARP_BYTES_CMB ? WARP_BYTES_KV : WARP_BYTES_CMB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float lut[16];
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

  if (tid < 16) lut[tid] = KVQ_NL4_LEVELS[tid];
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
  const uint8_t* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const uint8_t* vb = v + (size_t)b * svb + (size_t)hk * svh;
  const float* ksb = k_s + (size_t)b * sksb + hk;
  const float* vsb = v_s + (size_t)b * svsb + hk;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(warp_area + warp * WARP_BYTES);
  __nv_bfloat16* svt = sk + KT * LDK;
  float* ksc = reinterpret_cast<float*>(svt + D * LDV);

  FaWarp<D, KT> st;
  st.init();
  if (row_base + mt * 16 < R) {
    for (int key0 = key_start + ks * KT; key0 < key_end; key0 += ksplit * KT) {
      __syncwarp();
      fa_load_kv_quant<CODEC, D, KT, LDK, LDV>(sk, svt, ksc, kb, vb, ksb, vsb, sks, svs,
                                               skss, svss, key0, key_end, Dk, Dv, lut,
                                               lane, 32);
      __syncwarp();
      st.template step<LDQ, LDK, LDV>(sq + mt * 16 * LDQ, sk, svt, key0, qp0, qp1,
                                      mk, scale, softcap, Dk, Dv, ksc);
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

  // merge the warps of a row tile; a sink is one more term (m = sink, l = 1)
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

template <int CODEC, int D, int NW>
cudaError_t launch(const FaQuantArgs& a) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = KT + 8;
  constexpr int kv_bytes = (KT * LDK + D * LDV) * 2 + KT * 4;
  constexpr int cmb_bytes = (32 + 16 * D) * 4;
  constexpr int warp_bytes = kv_bytes > cmb_bytes ? kv_bytes : cmb_bytes;
  const int R = (a.H / a.Hkv) * a.T, MT = (R + 15) / 16;
  int MTB = 1;
  while (MTB < MT && MTB < NW) MTB *= 2;
  const int smem = MTB * 16 * LDQ * 2 + NW * warp_bytes;
  static bool smem_set = false;
  auto kern = fa_decode_q_kernel<CODEC, D, NW>;
  constexpr int smem_max = NW * 16 * LDQ * 2 + NW * warp_bytes;
  cudaError_t e = set_smem(kern, smem_max, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hkv, (MT + MTB - 1) / MTB);
  const long long* st = a.st;
  kern<<<grid, NW * 32, smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const float*>(a.k_s), static_cast<const uint8_t*>(a.v),
      static_cast<const float*>(a.v_s), static_cast<const int*>(a.qp),
      static_cast<const int*>(a.kl), static_cast<const float*>(a.sinks),
      static_cast<__nv_bfloat16*>(a.out), a.T, a.H, a.Hkv, a.Dk, a.Dv, MTB, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      a.scale, a.softcap, a.swa, a.chunk);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t launch_codec(const FaQuantArgs& a) {
  const int dmax = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (dmax <= 64) return launch<CODEC, 64, 8>(a);
  if (dmax <= 128) return launch<CODEC, 128, 8>(a);
  return launch<CODEC, 256, 4>(a);
}

}  // namespace

// codec: 0 q8, 1 q4, 2 q6, 3 nl4; strides as FaQuantArgs says (fa_quant.cuh).
extern "C" int ik_flash_attention_decode_q(
    const void* q, const void* k, const void* k_s, const void* v, const void* v_s,
    const void* q_pos0, const void* kv_len, const void* sinks, void* out, int codec,
    int B, int T, int H, int Hkv, int Dk, int Dv, long long sqb, long long sqt,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, long long sksb, long long skss, long long svsb,
    long long svss, float scale, float softcap, int swa, int chunk, void* stream) {
  const FaQuantArgs a{q, k, k_s, v, v_s, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
               {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sksb, skss, svsb, svss},
               scale, softcap, swa, chunk, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (codec) {
    case KVQ_Q8: e = launch_codec<KVQ_Q8>(a); break;
    case KVQ_Q4: e = launch_codec<KVQ_Q4>(a); break;
    case KVQ_Q6: e = launch_codec<KVQ_Q6>(a); break;
    case KVQ_NL4: e = launch_codec<KVQ_NL4>(a); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
