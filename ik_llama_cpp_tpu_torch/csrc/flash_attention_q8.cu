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
// Design: kernel B's frame (fa_prefill.cuh: 64-query tiles of four warps a
// head, 64-key tiles, 32 above D = 128, a walk over the live key range
// only, the longest query tiles launched first, Q's fragments in
// registers, softcap a template parameter, the mask only on tiles some row
// does not see whole), fed from the int8 cache:
// - the raw K and V rows of tile j + 1 and their two scale vectors go by
//   cp.async (16-byte copies where the rows are 16-byte aligned, else 8)
//   into a two-stage ring while tile j is unpacked and computed;
// - after the wait each tile is unpacked once into bf16 tiles kept
//   row-major (rows padded by 16 bytes), 8 codes a thread and one 16-byte
//   shared store each: K as the raw codes (exact in bf16, converted with
//   no conversion instruction), V as bf16(code * v_scale); K's B fragments
//   then come from ldmatrix, V's from ldmatrix.trans, as in B;
// - a block takes two heads of one GQA group (eight warps) where the group
//   and the head dims allow it, else one, and unpacks each tile once for
//   all of its heads (prefill_q8_heads in ops/flash_attention.py chooses;
//   PERF.md has the times of blocks of one, two and four heads).
// The TPU kernel's whole-row-axis scale blocks and its 128-row tile rule
// are tiling rules of that chip and are not carried over.
#include "fa_prefill.cuh"
#include "fa_quant.cuh"

namespace {

constexpr int BQ = FA_BQ;

// 8 / 4 bytes global -> shared, asynchronously (cp.async.ca), zero-filled
// past `bytes` (0 reads nothing, but gmem must still be a valid address).
IK_DEV void cp_async8_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem),
               "r"(bytes));
}
IK_DEV void cp_async4_zfill(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem),
               "r"(bytes));
}

template <int D, int KT, int NH>
struct Layout {
  static constexpr int LD = D + 8;                  // padded bf16 row
  static constexpr int NT = NH * FA_HEAD_WARPS * 32;
  static constexpr int RAW = KT * D;                // bytes of one tile's K (or V) codes
  static constexpr int SK = NH * BQ * LD * 2;       // after the heads' query tiles
  static constexpr int SV = SK + KT * LD * 2;       // the bf16 K tile, then V
  static constexpr int RING = SV + KT * LD * 2;     // [2 stages][K, V][KT][D] codes
  static constexpr int SC = RING + 4 * RAW;         // [2 stages][K, V][KT] scales
  static constexpr int BYTES = SC + 4 * KT * 4;
};

// The codes of keys [key0, key0 + KT) of one kv head, CW bytes a copy, into
// a stage's rows (D bytes apart); zero at keys >= end and at dims >= d.
template <int D, int KT, int NT, int CW>
IK_DEV void stage_codes(uint8_t* dst, const uint8_t* base, long long rs, int key0, int end,
                        int d, int tid) {
  constexpr int CH = D / CW;
#pragma unroll
  for (int c = tid; c < KT * CH; c += NT) {
    const int r = c / CH, j = (c % CH) * CW;
    const int n = key0 + r < end ? min(CW, d - j) : 0;
    const uint8_t* src = n > 0 ? base + (size_t)(key0 + r) * rs + j : base;
    if (CW == 16) {
      cp_async16_zfill(dst + r * D + j, src, n > 0 ? n : 0);
    } else {
      cp_async8_zfill(dst + r * D + j, src, n > 0 ? n : 0);
    }
  }
}

// bf16 tile rows from a stage's codes, 8 codes a thread and step: K as the
// codes (V: bf16(code * scale), scales[r] the row's). The code b + 128 put
// in the mantissa of 2^23 gives float(b) after one subtraction, and a
// float that holds an integer of at most 8 bits is exact in its upper half.
template <int D, int KT, int NT, bool IS_V>
IK_DEV void unpack_tile(__nv_bfloat16* tile, const uint8_t* codes, const float* scales,
                        int tid) {
  constexpr int LD = D + 8, CH = D / 8;
#pragma unroll
  for (int c = tid; c < KT * CH; c += NT) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(codes + r * D + d0);
    const float vs = IS_V ? scales[r] : 0.f;
    uint32_t o[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t u = (h ? w.y : w.x) ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.0f;
      if (IS_V) {
        o[2 * h] = pack_bf16x2(__fmul_rn(f[0], vs), __fmul_rn(f[1], vs));
        o[2 * h + 1] = pack_bf16x2(__fmul_rn(f[2], vs), __fmul_rn(f[3], vs));
      } else {
        o[2 * h] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
        o[2 * h + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
      }
    }
    *reinterpret_cast<uint4*>(tile + r * LD + d0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Block: (NH heads of one kv head's group, batch, 64-query tile); warp w
// runs rows 16 (w % 4) .. of head w / 4. vec16: codes by 16-byte copies.
template <int D, int KT, bool CAP, int NH>
__global__ void __launch_bounds__(NH * FA_HEAD_WARPS * 32)
fa_q8_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
             const float* __restrict__ k_s, const uint8_t* __restrict__ v,
             const float* __restrict__ v_s, const int* __restrict__ q_pos0,
             const int* __restrict__ kv_len, const float* __restrict__ sinks,
             __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int Dk, int Dv,
             long long sqb, long long sqt, long long sqh, long long skb, long long sks,
             long long skh, long long svb, long long svs, long long svh,
             long long sksb, long long skss, long long svsb, long long svss,
             float scale, float softcap, int swa, int chunk, int vec16) {
  using L = Layout<D, KT, NH>;
  constexpr int LD = L::LD, NT = L::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);          // [NH][BQ][LD]
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::SK);   // [KT][LD]
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem_raw + L::SV);   // [KT][LD]
  uint8_t* ring = smem_raw + L::RING;
  float* rsc = reinterpret_cast<float*>(smem_raw + L::SC);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int hh = warp / FA_HEAD_WARPS, wrow = (warp % FA_HEAD_WARPS) * 16;
  const int slices = H / Hkv / NH;
  const int hk = blockIdx.x / slices;
  const int h0 = hk * (H / Hkv) + (blockIdx.x % slices) * NH;
  const int b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest key ranges first
  const int nrows = min(BQ, T - row0);
  const int qpos = q_pos0[b];
  const FaMask mk{kv_len[b], swa, chunk};

  const FaKeyRange kr = fa_key_range<KT>(qpos + row0, nrows, mk);
  const uint8_t* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const uint8_t* vb = v + (size_t)b * svb + (size_t)hk * svh;
  const float* ksb = k_s + (size_t)b * sksb + hk;
  const float* vsb = v_s + (size_t)b * svsb + hk;
  auto stage = [&](int st, int key0) {
    uint8_t* dk = ring + st * 2 * L::RAW;
    if (vec16) {
      stage_codes<D, KT, NT, 16>(dk, kb, sks, key0, kr.end, Dk, tid);
      stage_codes<D, KT, NT, 16>(dk + L::RAW, vb, svs, key0, kr.end, Dv, tid);
    } else {
      stage_codes<D, KT, NT, 8>(dk, kb, sks, key0, kr.end, Dk, tid);
      stage_codes<D, KT, NT, 8>(dk + L::RAW, vb, svs, key0, kr.end, Dv, tid);
    }
    if (tid < 2 * KT) {                  // K scales, then V scales
      const int r = tid % KT, key = key0 + r;
      const bool ok = key < kr.end;
      const float* src = tid < KT ? ksb + (ok ? (size_t)key * skss : 0)
                                  : vsb + (ok ? (size_t)key * svss : 0);
      cp_async4_zfill(rsc + st * 2 * KT + tid, src, ok ? 4 : 0);
    }
  };

  // Q is zero past Dk, K and V past Dk / Dv: the products run over all D
#pragma unroll
  for (int i = 0; i < NH; ++i)
    fa_load_rows<D, BQ, LD, NT>(sq + i * BQ * LD, q + (size_t)b * sqb + (size_t)(h0 + i) * sqh,
                                sqt, row0, T, Dk, tid);
  cp_async_commit();
  if (kr.ntiles > 0) stage(0, kr.start);
  cp_async_commit();

  FaPrefillWarp<D, KT, CAP> w;
  w.init(sq + (hh * BQ + wrow) * LD, qpos + row0 + wrow, nrows - wrow, mk);
  cp_async_wait<0>();          // the query tiles and the first codes
  __syncthreads();
  w.load_q();

  for (int j = 0; j < kr.ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<0>();      // tile j's codes are in shared memory ...
      __syncthreads();         // ... for every thread, and tile j - 1 is read
    }
    const int key0 = kr.start + j * KT;
    if (j + 1 < kr.ntiles) {   // into the stage tile j - 1 left
      stage((j + 1) & 1, key0 + KT);
      cp_async_commit();
    }
    const uint8_t* codes = ring + (j & 1) * 2 * L::RAW;
    const float* sc = rsc + (j & 1) * 2 * KT;
    unpack_tile<D, KT, NT, false>(sk, codes, nullptr, tid);
    unpack_tile<D, KT, NT, true>(sv, codes + L::RAW, sc + KT, tid);
    __syncthreads();           // the bf16 tiles are whole
    w.template round<true>(sk, sv, sc, key0, mk, scale, softcap);
  }
  w.store(out, sinks, b, T, H, h0 + hh, row0, wrow, nrows, Dv);
}

template <int D, int KT, bool CAP, int NH>
cudaError_t launch(const FaQuantArgs& a, int vec16) {
  static bool smem_set = false;
  constexpr int smem = Layout<D, KT, NH>::BYTES;
  auto kern = fa_q8_kernel<D, KT, CAP, NH>;
  cudaError_t e = set_smem(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int tiles = (a.T + BQ - 1) / BQ;
  if (a.B > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.H / NH, a.B, tiles);
  const long long* st = a.st;
  kern<<<grid, Layout<D, KT, NH>::NT, smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const float*>(a.k_s), static_cast<const uint8_t*>(a.v),
      static_cast<const float*>(a.v_s), static_cast<const int*>(a.qp),
      static_cast<const int*>(a.kl), static_cast<const float*>(a.sinks),
      static_cast<__nv_bfloat16*>(a.out), a.T, a.H, a.Hkv, a.Dk, a.Dv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      a.scale, a.softcap, a.swa, a.chunk, vec16);
  return cudaGetLastError();
}

template <int D, int KT, int NH>
cudaError_t by_cap(const FaQuantArgs& a, int vec16) {
  return a.softcap > 0.f ? launch<D, KT, true, NH>(a, vec16) : launch<D, KT, false, NH>(a, vec16);
}

template <int NH>
cudaError_t by_dim(const FaQuantArgs& a, int vec16) {
  const int dmax = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (dmax <= 64) return by_cap<64, 64, NH>(a, vec16);
  return by_cap<128, 64, NH>(a, vec16);
}

}  // namespace

// The signature of ik_flash_attention_decode_q with heads in place of the
// split arguments; codec must be 0 (q8). heads: query heads a block (1 or
// 2; a divisor of H / Hkv; 1 above head dim 128).
extern "C" int ik_flash_attention_q8(
    const void* q, const void* k, const void* k_s, const void* v, const void* v_s,
    const void* q_pos0, const void* kv_len, const void* sinks, void* out, int heads, int codec,
    int B, int T, int H, int Hkv, int Dk, int Dv, long long sqb, long long sqt, long long sqh,
    long long skb, long long sks, long long skh, long long svb, long long svs,
    long long svh, long long sksb, long long skss, long long svsb, long long svss,
    float scale, float softcap, int swa, int chunk, void* stream) {
  const FaQuantArgs a{q, k, k_s, v, v_s, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
               {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sksb, skss, svsb, svss},
               scale, softcap, swa, chunk, static_cast<cudaStream_t>(stream)};
  const int dmax = Dk > Dv ? Dk : Dv;
  if (codec != KVQ_Q8 || (heads != 1 && heads != 2) || (H / Hkv) % heads ||
      (heads > 1 && dmax > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies where every row of both caches starts 16-byte aligned
  const unsigned long long al =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(k) |
                                      reinterpret_cast<uintptr_t>(v)) |
      static_cast<unsigned long long>(skb | sks | skh | svb | svs | svh);
  const int vec16 = (al & 15) == 0;
  cudaError_t e;
  if (heads == 2)
    e = by_dim<2>(a, vec16);
  else if (dmax <= 128)
    e = by_dim<1>(a, vec16);
  else
    e = by_cap<256, 32, 1>(a, vec16);
  return static_cast<int>(e);
}
