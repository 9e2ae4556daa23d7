// Prefill flash attention (any T) over an int8 KV cache with one float32
// scale per (row, kv head).
//
// Replaces ik_llama_cpp_tpu/ops/flash_attention.py:flash_attention_q8
// (Pallas, _fa_q8_kernel).
//
// q: bf16 (B, T, H, Dk), unit last stride, other strides in elements; k, v:
// int8 (B, S, Hkv, D*), unit last stride, other strides in bytes; k_s, v_s:
// float32 (B, S, Hkv), unit last stride, other strides in elements; q_pos0,
// kv_len: int32 (B,) on the device; sinks: f32 (H,) or null. out: bf16
// (B, T, H, Dv) contiguous. Causal online softmax with GQA, logit softcap,
// sliding window, llama4 attention chunks and per-head sinks.
//
// Numerics as in the TPU kernel: a score is the float32 product of q with
// code * k_scale (here: the mma over the raw codes, exact in bf16, then one
// float32 multiply by the key's scale); the probabilities and
// code * v_scale are rounded to bf16 before the PV product.
//
// Bound on the H100: bf16 tensor-core operations over the live (causal)
// part of the score matrix; the int8 K/V bytes are half the bf16 kernel's.
// Design: the block layout of flash_attention.cu (one block per (64-query
// tile, head, batch), four warps of 16 query rows, 64-key tiles, 32 for head
// dims above 128) with the int8 tile loader of fa_quant.cuh; a block loops
// only over its live key range. The TPU kernel's whole-row-axis scale
// blocks and its 128-row tile rule are tiling rules of that chip and are
// not carried over. No copy/compute overlap yet.
#include "fa_quant.cuh"

namespace {

constexpr int BQ = 64, NWARP = 4;

template <int D, int KT>
__global__ void __launch_bounds__(NWARP * 32)
fa_q8_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
             const float* __restrict__ k_s, const uint8_t* __restrict__ v,
             const float* __restrict__ v_s, const int* __restrict__ q_pos0,
             const int* __restrict__ kv_len, const float* __restrict__ sinks,
             __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int Dk, int Dv,
             long long sqb, long long sqt, long long sqh, long long skb, long long sks,
             long long skh, long long svb, long long svs, long long svh,
             long long sksb, long long skss, long long svsb, long long svss,
             float scale, float softcap, int swa, int chunk) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = KT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LDQ]
  __nv_bfloat16* sk = sq + BQ * LDQ;                                 // [KT][LDK]
  __nv_bfloat16* svt = sk + KT * LDK;                                // [D][LDV]
  float* ksc = reinterpret_cast<float*>(svt + D * LDV);              // [KT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv);
  const int nrows = min(BQ, T - row0);
  const int qpos = q_pos0[b];
  const FaMask mk{kv_len[b], swa, chunk};

  {  // query tile, zero past T and past Dk
    constexpr int CH = D / 8;
    const __nv_bfloat16* qb = q + (size_t)b * sqb + (size_t)h * sqh;
    for (int c = tid; c < BQ * CH; c += NWARP * 32) {
      const int r = c / CH, d0 = (c % CH) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < nrows && d0 < Dk)
        val = *reinterpret_cast<const uint4*>(qb + (size_t)(row0 + r) * sqt + d0);
      *reinterpret_cast<uint4*>(sq + r * LDQ + d0) = val;
    }
  }

  const int key_end = min(mk.kv_len, qpos + row0 + nrows);
  const int key_start = fa_first_key(qpos + row0, mk);
  const int qp0 = qpos + row0 + warp * 16 + g, qp1 = qp0 + 8;
  const uint8_t* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const uint8_t* vb = v + (size_t)b * svb + (size_t)hk * svh;
  const float* ksb = k_s + (size_t)b * sksb + hk;
  const float* vsb = v_s + (size_t)b * svsb + hk;

  FaWarp<D, KT> st;
  st.init();
  for (int key0 = key_start; key0 < key_end; key0 += KT) {
    __syncthreads();
    fa_load_kv_quant<KVQ_Q8, D, KT, LDK, LDV>(sk, svt, ksc, kb, vb, ksb, vsb, sks, svs,
                                              skss, svss, key0, key_end, Dk, Dv, nullptr,
                                              tid, NWARP * 32);
    __syncthreads();
    st.template step<LDQ, LDK, LDV>(sq + warp * 16 * LDQ, sk, svt, key0, qp0, qp1,
                                    mk, scale, softcap, Dk, Dv, ksc);
  }
  st.finish();

  float corr[2] = {1.f, 1.f}, denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    if (sinks != nullptr) {  // extra per-head logit in the denominator
      const float sk_ = sinks[h];
      const float mm = fmaxf(st.m[r], sk_);
      corr[r] = expf(st.m[r] - mm);
      l = l * corr[r] + expf(sk_ - mm);
    }
    denom[r] = (l > 0.f) ? l : 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* ob = out + (((size_t)b * T + row0 + row) * H + h) * Dv;
    const float f = corr[r] / denom[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c >= Dv) break;
      *reinterpret_cast<uint32_t*>(ob + c) =
          pack_bf16x2(st.o[n][2 * r] * f, st.o[n][2 * r + 1] * f);
    }
  }
}

template <int D, int KT>
cudaError_t launch(const FaQuantArgs& a) {
  static bool smem_set = false;
  constexpr int smem = ((BQ + KT) * (D + 8) + D * (KT + 8)) * 2 + KT * 4;
  auto kern = fa_q8_kernel<D, KT>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  const long long* st = a.st;
  kern<<<grid, NWARP * 32, smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const float*>(a.k_s), static_cast<const uint8_t*>(a.v),
      static_cast<const float*>(a.v_s), static_cast<const int*>(a.qp),
      static_cast<const int*>(a.kl), static_cast<const float*>(a.sinks),
      static_cast<__nv_bfloat16*>(a.out), a.T, a.H, a.Hkv, a.Dk, a.Dv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      a.scale, a.softcap, a.swa, a.chunk);
  return cudaGetLastError();
}

}  // namespace

// The signature of ik_flash_attention_decode_q; codec must be 0 (q8).
extern "C" int ik_flash_attention_q8(
    const void* q, const void* k, const void* k_s, const void* v, const void* v_s,
    const void* q_pos0, const void* kv_len, const void* sinks, void* out, int codec, int B,
    int T, int H, int Hkv, int Dk, int Dv, long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sksb, long long skss, long long svsb, long long svss,
    float scale, float softcap, int swa, int chunk, void* stream) {
  const FaQuantArgs a{q, k, k_s, v, v_s, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
               {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sksb, skss, svsb, svss},
               scale, softcap, swa, chunk, static_cast<cudaStream_t>(stream)};
  if (codec != KVQ_Q8) return static_cast<int>(cudaErrorInvalidValue);
  const int dmax = Dk > Dv ? Dk : Dv;
  cudaError_t e;
  if (dmax <= 64)
    e = launch<64, 64>(a);
  else if (dmax <= 128)
    e = launch<128, 64>(a);
  else
    e = launch<256, 32>(a);
  return static_cast<int>(e);
}
