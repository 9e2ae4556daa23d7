// The split-K frame of the two decode attention kernels (T <= 16): kernel C
// over the bf16 slab (flash_attention_decode.cu) and kernel 5 over a
// quantized slab (flash_attention_decode_q.cu). Only their tile loaders
// differ; this file holds what is common:
// - the grid: blockIdx.x a (batch, kv head), blockIdx.y a row tile of the
//   GQA group's query rows (row = head_in_group * T + token, as the TPU
//   kernels pack them), blockIdx.z one of `splits` blocks over the group's
//   live keys (ops/flash_attention.decode_split_plan);
// - each block's key range, derived on the device from kv_len / q_pos0:
//   chunks of a whole number of 32-key tiles, at least one round of the
//   block's warps; where the live keys fit one round, or there is one
//   split, block 0 alone takes the whole range (`whole`);
// - the query rows in shared memory;
// - the end: the block merges its warps' (max, sum, output) in warp order;
//   whole: with the sinks, into the output; else into its float32 slot of
//   the scratch, and the last block of the group to finish (an atomicAdd
//   counter after a __threadfence, which it resets to zero) merges the
//   splits in split order, with the sinks. One launch a call, no host
//   sync, and a call repeats bit for bit.
#pragma once

#include "fa_common.cuh"

constexpr int FA_DEC_KT = 32;     // keys of a warp's tile

// One block's place in the grid and its keys.
struct FaDecBlock {
  int b, hk, rep, T, H, R, RB, row_base, ksplit;
  int gi;                         // the group's scratch and counter
  int split, splits;
  int key_end, lo, hi, used;      // this block's keys [lo, hi); `used` blocks work
  bool whole;                     // one block takes the group's whole range
};

// The block's group and key range; false where the block has no keys to take.
IK_DEV bool fa_dec_block(FaDecBlock& k, int qpos, const FaMask& mk, int T, int H, int Hkv,
                         int MTB, int NW) {
  k.b = blockIdx.x / Hkv;
  k.hk = blockIdx.x % Hkv;
  k.rep = H / Hkv;
  k.T = T;
  k.H = H;
  k.R = k.rep * T;
  k.RB = MTB * 16;
  k.row_base = blockIdx.y * k.RB;
  k.ksplit = NW / MTB;
  k.splits = gridDim.z;
  k.split = blockIdx.z;
  k.gi = blockIdx.x * gridDim.y + blockIdx.y;
  const int round = k.ksplit * FA_DEC_KT;
  k.key_end = min(mk.kv_len, qpos + T);
  const int key_start = fa_first_key(qpos, mk);
  const int live = max(k.key_end - key_start, 0);
  k.whole = k.splits == 1 || live <= round;
  k.lo = key_start;
  k.hi = k.key_end;
  k.used = 1;
  if (k.whole) return k.split == 0;
  const int per = max(((live + k.splits - 1) / k.splits + FA_DEC_KT - 1) / FA_DEC_KT * FA_DEC_KT,
                      round);
  k.used = (live + per - 1) / per;
  if (k.split >= k.used) return false;
  k.lo = key_start + k.split * per;
  k.hi = min(k.lo + per, k.key_end);
  return true;
}

// The group's query rows into sq ([RB][D + 8]), zero past R and past Dk.
template <int D, int NW>
IK_DEV void fa_dec_load_q(__nv_bfloat16* sq, const __nv_bfloat16* __restrict__ q,
                          const FaDecBlock& k, int Dk, long long sqb, long long sqt,
                          long long sqh) {
  constexpr int CH = D / 8, LDQ = D + 8;
  for (int c = threadIdx.x; c < k.RB * CH; c += NW * 32) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const int gr = k.row_base + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gr < k.R && d0 < Dk) {
      const int tt = gr % k.T, h = k.hk * k.rep + gr / k.T;
      val = *reinterpret_cast<const uint4*>(q + (size_t)k.b * sqb + (size_t)tt * sqt +
                                            (size_t)h * sqh + d0);
    }
    *reinterpret_cast<uint4*>(sq + r * LDQ + d0) = val;
  }
}

// The end of a block, after every warp's loop: smem_raw is the query tile
// (free by then), warp_area the warps' areas of WARP_BYTES each (at least
// (32 + 16 D) floats; free by then too).
template <int D, int NW>
IK_DEV void fa_dec_finish(FaWarp<D, FA_DEC_KT>& st, unsigned char* smem_raw,
                          unsigned char* warp_area, int warp_bytes, const FaDecBlock& k,
                          const float* __restrict__ sinks, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ part, int* __restrict__ counters, int Dv) {
  __shared__ int last_block;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  st.finish();
  __syncthreads();   // every warp is done with its K/V tiles: reuse them

  // per warp: m[16], l[16], o[16][D] (float)
  {
    const int t = lane & 3;
    float* cm = reinterpret_cast<float*>(warp_area + warp * warp_bytes);
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
  const int ksplit = k.ksplit, RB = k.RB;
  auto warp_part = [&](int mtl, int w) {
    return reinterpret_cast<const float*>(warp_area + (mtl * ksplit + w) * warp_bytes);
  };
  // per row, once (the query tile is free): the max over the warps (with
  // the sink where this block gives the output), each warp's factor
  // exp(m_w - max) and the sum l, in warp order; [RB][ksplit + 2]
  float* rowv = reinterpret_cast<float*>(smem_raw);
  const int RV = ksplit + 2;
  for (int r = tid; r < RB; r += NW * 32) {
    const int mtl = r / 16, row = r % 16, gr = k.row_base + r;
    if (gr >= k.R) continue;
    float mm = FA_NEG;
    for (int w = 0; w < ksplit; ++w) mm = fmaxf(mm, warp_part(mtl, w)[row]);
    const bool sink_here = k.whole && sinks != nullptr;
    float sink = 0.f;
    if (sink_here) {
      sink = sinks[k.hk * k.rep + gr / k.T];
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
  float* pb = part + ((size_t)k.gi * k.splits + k.split) * psz;
  for (int idx = tid; idx < RB * Dv; idx += NW * 32) {
    const int r = idx / Dv, d = idx % Dv, mtl = r / 16, row = r % 16;
    const int gr = k.row_base + r;
    if (gr >= k.R) continue;
    float o = 0.f;
    for (int w = 0; w < ksplit; ++w) o += warp_part(mtl, w)[32 + row * D + d] * rowv[r * RV + w];
    if (k.whole) {
      const int tt = gr % k.T, h = k.hk * k.rep + gr / k.T;
      const float l = rowv[r * RV + ksplit + 1];
      out[(((size_t)k.b * k.T + tt) * k.H + h) * Dv + d] =
          __float2bfloat16_rn(o / (l > 0.f ? l : 1.f));
    } else {
      pb[r * Dv + d] = o;
      if (d == 0) {
        pb[RB * Dv + r] = rowv[r * RV + ksplit];
        pb[RB * Dv + RB + r] = rowv[r * RV + ksplit + 1];
      }
    }
  }
  if (k.whole) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&counters[k.gi], 1);
    last_block = prev == k.used - 1;
    if (last_block) counters[k.gi] = 0;    // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block merges the splits in split order, with the sinks: per
  // row the max, each split's factor and the sum; then each output
  const float* p0 = part + (size_t)k.gi * k.splits * psz;
  const int used = k.used, SV = used + 2;  // [RB][used + 2], used <= 32
  for (int r = tid; r < RB; r += NW * 32) {
    const int gr = k.row_base + r;
    if (gr >= k.R) continue;
    float mm = FA_NEG;
    for (int j = 0; j < used; ++j) mm = fmaxf(mm, __ldcg(p0 + j * psz + RB * Dv + r));
    float sink = 0.f;
    if (sinks != nullptr) {
      sink = sinks[k.hk * k.rep + gr / k.T];
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
    const int gr = k.row_base + r;
    if (gr >= k.R) continue;
    const int tt = gr % k.T, h = k.hk * k.rep + gr / k.T;
    float o = 0.f;
    for (int j = 0; j < used; ++j) o += __ldcg(p0 + j * psz + r * Dv + d) * rowv[r * SV + j];
    const float l = rowv[r * SV + used];
    out[(((size_t)k.b * k.T + tt) * k.H + h) * Dv + d] =
        __float2bfloat16_rn(o / (l > 0.f ? l : 1.f));
  }
}

// Rows of the block's query tile (MTB m-tiles of 16) for R = GQA group x T
// rows and NW warps: the smallest power of two that covers R, at most NW.
inline int fa_dec_mtb(int R, int NW) {
  const int MT = (R + 15) / 16;
  int MTB = 1;
  while (MTB < MT && MTB < NW) MTB *= 2;
  return MTB;
}
