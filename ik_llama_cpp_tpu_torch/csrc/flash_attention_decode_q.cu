// Decode / short-chunk flash attention (T <= 16) over the quantized
// (B, S, Hkv, W) cache slab of one layer, for the four KV codecs of
// ops/kv_quant.py (q8, q4, q6, nl4): split-K flash decoding.
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
// code * v_scale are both rounded to bf16 before the PV product; expf.
//
// Bound on the H100 by the stored bytes of the live rows (codes and
// scales: a half to an eighth of the bf16 cache's), a few operations a
// byte. Design: kernel C's split-K frame (fa_decode.cuh: a GQA group's
// query rows share each tile, the group's live keys are split over the
// blocks of ops/flash_attention.decode_split_plan, the last block to
// finish merges the splits in split order; one launch, no host sync), so
// that a batch-1 call fills the card instead of running B * Hkv blocks.
// What differs from C is the tile: each warp copies a tile's raw stored
// rows and scales by cp.async into a staging area, 8 bytes a copy, and
// unpacks them after the wait (fa_quant.cuh: kvq_codes8) into one bf16
// tile, K as raw codes, then V as bf16(code * scale), both row-major (V's
// B fragments by ldmatrix.trans). K and V are staggered as in C: the next
// tile's K codes are in flight while this tile's scores are taken and its
// V is unpacked and multiplied, the next V codes while the next K is
// unpacked and scored. Where the live keys fit one round of the block's
// warps, or the plan gives one split, block 0 alone runs the partition and
// merge of the kernel's first port: the same bits as before the split.
#include "fa_decode.cuh"
#include "fa_quant.cuh"

namespace {

constexpr int KT = FA_DEC_KT;

// Bytes of one stored row of head dim d in a codec.
template <int CODEC>
IK_DEV int kvq_width(int d) {
  return CODEC == KVQ_Q8 ? d : CODEC == KVQ_Q6 ? d / 4 * 3 : d / 2;
}

// A warp's area: the bf16 tile (K, then V), the staged raw rows of K and
// V (WS bytes a row), their scales, and the K scales of the tile in use.
template <int CODEC, int D>
struct QTile {
  static constexpr int LD = D + 8;
  static constexpr int WS = CODEC == KVQ_Q8 ? D : CODEC == KVQ_Q6 ? D / 4 * 3 : D / 2;
  static constexpr int TILE = 0;                          // bf16 [KT][LD]
  static constexpr int SK = TILE + KT * LD * 2;           // raw K rows [KT][WS]
  static constexpr int SV = SK + KT * WS;                 // raw V rows [KT][WS]
  static constexpr int SKS = SV + KT * WS;                // K scales [KT]
  static constexpr int SVS = SKS + KT * 4;                // V scales [KT]
  static constexpr int KSC = SVS + KT * 4;                // K scales of the tile in use
  static constexpr int BYTES_KV = (KSC + KT * 4 + 15) / 16 * 16;
  static constexpr int BYTES_CMB = (32 + 16 * D) * 4;
  static constexpr int BYTES = BYTES_KV > BYTES_CMB ? BYTES_KV : BYTES_CMB;
};

// 8 / 4 bytes global -> shared, asynchronously (cp.async.ca: L1 and L2).
IK_DEV void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem));
}
IK_DEV void cp_async4s(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(smem))), "l"(gmem));
}

// The stored rows of keys [key0, key0 + KT) below key_end, w bytes each,
// and their scales, into a warp's staging rows (WS bytes apart).
template <int WS>
IK_DEV void stage_rows(unsigned char* dst, float* dscale, const uint8_t* base,
                       const float* scale, long long rs, long long ss, int key0,
                       int key_end, int w, int lane) {
  constexpr int CW = WS / 8;
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const int c = lane + 32 * i, r = c / CW, j = (c % CW) * 8;
    if (key0 + r < key_end && j < w)
      cp_async8(dst + r * WS + j, base + (size_t)(key0 + r) * rs + j);
  }
  if (key0 + lane < key_end) cp_async4s(dscale + lane, scale + (size_t)(key0 + lane) * ss);
}

// Staged rows -> the bf16 tile: K as raw codes (V: bf16(code * scale));
// zero at keys past key_end and at dims past d.
template <int CODEC, int D, bool IS_V>
IK_DEV void unpack_tile(__nv_bfloat16* tile, const unsigned char* rows, const float* scales,
                        int key0, int key_end, int d, const float* lut, int lane) {
  using L = QTile<CODEC, D>;
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < KT * CH / 32; ++i) {
    const int c = lane + 32 * i, r = c / CH, d0 = (c % CH) * 8;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = 0.f;
    if (key0 + r < key_end && d0 < d) {
      kvq_codes8<CODEC>(rows + r * L::WS, d0, d, lut, f);
      if (IS_V) {
        const float vs = scales[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], vs);
      }
    }
    uint4 u;
    u.x = pack_bf16x2(f[0], f[1]);
    u.y = pack_bf16x2(f[2], f[3]);
    u.z = pack_bf16x2(f[4], f[5]);
    u.w = pack_bf16x2(f[6], f[7]);
    *reinterpret_cast<uint4*>(tile + r * L::LD + d0) = u;
  }
}

template <int CODEC, int D, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_decode_q_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
                   const float* __restrict__ k_s, const uint8_t* __restrict__ v,
                   const float* __restrict__ v_s, const int* __restrict__ q_pos0,
                   const int* __restrict__ kv_len, const float* __restrict__ sinks,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ counters, int T, int H, int Hkv, int Dk, int Dv,
                   int MTB, long long sqb, long long sqt, long long sqh, long long skb,
                   long long sks, long long skh, long long svb, long long svs,
                   long long svh, long long sksb, long long skss, long long svsb,
                   long long svss, float scale, float softcap, int swa, int chunk) {
  using L = QTile<CODEC, D>;
  constexpr int LDQ = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float lut[16];
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
  const int hi = blk.hi, key_end = blk.key_end;

  if (tid < 16) lut[tid] = KVQ_NL4_LEVELS[tid];
  fa_dec_load_q<D, NW>(sq, q, blk, Dk, sqb, sqt, sqh);
  __syncthreads();

  const int mt = warp / ksplit, ks = warp % ksplit;
  const int r0 = row_base + mt * 16 + g, r1 = r0 + 8;
  const int qp0 = qpos + r0 % T, qp1 = qpos + r1 % T;
  const uint8_t* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const uint8_t* vb = v + (size_t)b * svb + (size_t)hk * svh;
  const float* ksb = k_s + (size_t)b * sksb + hk;
  const float* vsb = v_s + (size_t)b * svsb + hk;
  const int wk = kvq_width<CODEC>(Dk), wv = kvq_width<CODEC>(Dv);
  unsigned char* area = warp_area + warp * L::BYTES;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(area + L::TILE);
  unsigned char* stk = area + L::SK;
  unsigned char* stv = area + L::SV;
  float* stks = reinterpret_cast<float*>(area + L::SKS);
  float* stvs = reinterpret_cast<float*>(area + L::SVS);
  float* ksc = reinterpret_cast<float*>(area + L::KSC);

  FaWarp<D, KT> st;
  st.init();
  int key0 = blk.lo + ks * KT;
  if (row_base + mt * 16 < R && key0 < hi) {
    stage_rows<L::WS>(stk, stks, kb, ksb, sks, skss, key0, key_end, wk, lane);
    cp_async_commit();
    stage_rows<L::WS>(stv, stvs, vb, vsb, svs, svss, key0, key_end, wv, lane);
    cp_async_commit();
    for (;;) {
      cp_async_wait<1>();                 // this tile's K rows
      __syncwarp();                       // ... from every lane; the tile is free
      unpack_tile<CODEC, D, false>(tile, stk, stks, key0, key_end, Dk, lut, lane);
      ksc[lane] = key0 + lane < key_end ? stks[lane] : 0.f;
      __syncwarp();
      const int nxt = key0 + round;
      const bool more = nxt < hi;
      if (more) {                         // the next K rows, in flight from here
        stage_rows<L::WS>(stk, stks, kb, ksb, sks, skss, nxt, key_end, wk, lane);
        cp_async_commit();
      }
      float s[KT / 8][4];
      st.template softmax<LDQ, L::LD>(s, sq + mt * 16 * LDQ, tile, key0, qp0, qp1, mk, scale,
                                      softcap, Dk, ksc);
      if (more) {
        cp_async_wait<1>();               // this tile's V rows; the next K in flight
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();                       // every lane is done with K
      unpack_tile<CODEC, D, true>(tile, stv, stvs, key0, key_end, Dv, lut, lane);
      __syncwarp();
      if (more) {
        stage_rows<L::WS>(stv, stvs, vb, vsb, svs, svss, nxt, key_end, wv, lane);
        cp_async_commit();
      }
      st.template pv_rows<L::LD>(s, tile, Dv);
      if (!more) break;
      key0 = nxt;
    }
  }
  fa_dec_finish<D, NW>(st, smem_raw, warp_area, L::BYTES, blk, sinks, out, part, counters,
                       Dv);
}

template <int CODEC, int D, int NW>
cudaError_t launch(const FaQuantArgs& a, void* part, void* counters, int splits) {
  using L = QTile<CODEC, D>;
  constexpr int LDQ = D + 8;
  const int R = (a.H / a.Hkv) * a.T, MT = (R + 15) / 16;
  const int MTB = fa_dec_mtb(R, NW);
  const int smem = MTB * 16 * LDQ * 2 + NW * L::BYTES;
  static bool smem_set = false;
  auto kern = fa_decode_q_kernel<CODEC, D, NW>;
  constexpr int smem_max = NW * 16 * LDQ * 2 + NW * L::BYTES;
  cudaError_t e = set_smem(kern, smem_max, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hkv, (MT + MTB - 1) / MTB, splits);
  const long long* st = a.st;
  kern<<<grid, NW * 32, smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const float*>(a.k_s), static_cast<const uint8_t*>(a.v),
      static_cast<const float*>(a.v_s), static_cast<const int*>(a.qp),
      static_cast<const int*>(a.kl), static_cast<const float*>(a.sinks),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(part),
      static_cast<int*>(counters), a.T, a.H, a.Hkv, a.Dk, a.Dv, MTB, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], a.scale,
      a.softcap, a.swa, a.chunk);
  return cudaGetLastError();
}

template <int CODEC>
cudaError_t launch_codec(const FaQuantArgs& a, void* part, void* counters, int splits) {
  const int dmax = a.Dk > a.Dv ? a.Dk : a.Dv;
  if (dmax <= 64) return launch<CODEC, 64, 8>(a, part, counters, splits);
  if (dmax <= 128) return launch<CODEC, 128, 8>(a, part, counters, splits);
  return launch<CODEC, 256, 4>(a, part, counters, splits);
}

}  // namespace

// codec: 0 q8, 1 q4, 2 q6, 3 nl4; strides as FaQuantArgs says (fa_quant.cuh).
// splits, part, counters: as ik_flash_attention_decode takes them
// (ops/flash_attention.decode_split_plan).
extern "C" int ik_flash_attention_decode_q(
    const void* q, const void* k, const void* k_s, const void* v, const void* v_s,
    const void* q_pos0, const void* kv_len, const void* sinks, void* out, void* part,
    void* counters, int splits, int codec, int B, int T, int H, int Hkv, int Dk, int Dv,
    long long sqb, long long sqt, long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sksb, long long skss,
    long long svsb, long long svss, float scale, float softcap, int swa, int chunk,
    void* stream) {
  if (splits < 1 || splits > 32 || (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const FaQuantArgs a{q, k, k_s, v, v_s, q_pos0, kv_len, sinks, out, B, T, H, Hkv, Dk, Dv,
               {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sksb, skss, svsb, svss},
               scale, softcap, swa, chunk, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (codec) {
    case KVQ_Q8: e = launch_codec<KVQ_Q8>(a, part, counters, splits); break;
    case KVQ_Q4: e = launch_codec<KVQ_Q4>(a, part, counters, splits); break;
    case KVQ_Q6: e = launch_codec<KVQ_Q6>(a, part, counters, splits); break;
    case KVQ_NL4: e = launch_codec<KVQ_NL4>(a, part, counters, splits); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
