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
// them. Design: one block per (64-query tile, head, batch), four warps of 16
// query rows, 64-key tiles in shared memory (32 for head dims above 128).
// A block loops only over its live key range, from the first key its window
// or chunk allows to min(kv_len, last query position + 1), which is what the
// TPU kernel's tile clamp did with skipped DMAs. No copy/compute overlap
// and no K/V reuse across heads of a GQA group yet.
#include "fa_common.cuh"

namespace {

constexpr int BQ = 64, NWARP = 4;

template <int D, int KT>
__global__ void __launch_bounds__(NWARP * 32)
fa_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ q_pos0, const int* __restrict__ kv_len,
                  const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                  int T, int H, int Hkv, int Dk, int Dv, long long sqb, long long sqt,
                  long long sqh, long long skb, long long sks, long long skh,
                  long long svb, long long svs, long long svh, float scale,
                  float softcap, int swa, int chunk) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = KT + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LDQ]
  __nv_bfloat16* sk = sq + BQ * LDQ;                                 // [KT][LDK]
  __nv_bfloat16* svt = sk + KT * LDK;                                // [D][LDV]

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
  const __nv_bfloat16* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const __nv_bfloat16* vb = v + (size_t)b * svb + (size_t)hk * svh;

  FaWarp<D, KT> st;
  st.init();
  for (int key0 = key_start; key0 < key_end; key0 += KT) {
    __syncthreads();
    fa_load_kv<D, KT, LDK, LDV>(sk, svt, kb, vb, sks, svs, key0, key_end, Dk, Dv,
                                tid, NWARP * 32);
    __syncthreads();
    st.template step<LDQ, LDK, LDV>(sq + warp * 16 * LDQ, sk, svt, key0, qp0, qp1,
                                    mk, scale, softcap, Dk, Dv);
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
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp,
                   const void* kl, const void* sinks, void* out, int B, int T,
                   int H, int Hkv, int Dk, int Dv, const long long* st, float scale,
                   float softcap, int swa, int chunk, cudaStream_t s) {
  static bool smem_set = false;
  constexpr int smem = ((BQ + KT) * (D + 8) + D * (KT + 8)) * 2;
  auto kern = fa_prefill_kernel<D, KT>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  kern<<<grid, NWARP * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kl), static_cast<const float*>(sinks),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, Dk, Dv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, softcap, swa, chunk);
  return cudaGetLastError();
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
    e = launch<64, 64>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                       st, scale, softcap, swa, chunk, s);
  else if (dmax <= 128)
    e = launch<128, 64>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                        st, scale, softcap, swa, chunk, s);
  else
    e = launch<256, 32>(q, k, v, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
                        st, scale, softcap, swa, chunk, s);
  return static_cast<int>(e);
}
