// Shared pieces of the MoE kernels: the expert activation and float
// arithmetic that nvcc may not contract into fused multiply-adds, so that
// the kernels round exactly where the plain PyTorch versions do, and the
// block shape and row staging of the down kernels 8 and 13.
#pragma once

#include "common.cuh"

constexpr int MOE_SG = 256;      // supergroup depth of the int8 expert codes
constexpr int MOE_SMEM_MAX = 232448;   // dynamic shared memory a block may use on sm_90

constexpr int DOWN_THREADS = 256;   // threads of a down-kernel block (8 and 13)
constexpr int DOWN_BATCH = 6;       // 16-byte chunks a lane of a down kernel loads in a batch

enum MoeAct { ACT_SILU = 0, ACT_GELU = 1, ACT_SWIGLU_OAI = 2 };

IK_DEV float fmul(float a, float b) { return __fmul_rn(a, b); }
IK_DEV float fadd(float a, float b) { return __fadd_rn(a, b); }

// acc + part * (sa * sb): the supergroup correction, rounded step by step.
IK_DEV float sg_corr(float acc, int part, float sa, float sb) {
  return fadd(acc, fmul(static_cast<float>(part), fmul(sa, sb)));
}

IK_DEV float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// A group scale of planar codes as the kernels use it: rounded to bf16,
// whether it is stored as float32 or as bf16.
IK_DEV float load_scale(const float* p) { return bf16_round(__ldg(p)); }
IK_DEV float load_scale(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Copies n 16-byte chunks from global to shared memory with the
// DOWN_THREADS threads of a block, four loads a thread in flight at once.
IK_DEV void stage16(void* dst, const void* src, int n, int tid) {
  const int4* s = static_cast<const int4*>(src);
  int4* d = static_cast<int4*>(dst);
  for (int b = tid; b < n; b += 4 * DOWN_THREADS) {
    int4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (b + i * DOWN_THREADS < n) v[i] = __ldg(s + b + i * DOWN_THREADS);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (b + i * DOWN_THREADS < n) d[b + i * DOWN_THREADS] = v[i];
  }
}

IK_DEV float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// act(g) * u as the JAX package's _act: silu (clamped when limit > 0),
// gpt-oss swiglu (alpha 1.702, limit 7) or tanh-approximated gelu.
IK_DEV float moe_act(float g, float u, int act, float limit) {
  if (act == ACT_SWIGLU_OAI) {
    const float gc = fminf(g, 7.0f);
    const float uc = fminf(fmaxf(u, -7.0f), 7.0f);
    return fmul(fmul(gc, sigmoid_f(fmul(1.702f, gc))), fadd(uc, 1.0f));
  }
  if (act == ACT_SILU) {
    const float s = fmul(g, sigmoid_f(g));
    if (limit > 0.0f) return fmul(fminf(s, limit), fminf(fmaxf(u, -limit), limit));
    return fmul(s, u);
  }
  const float inner = fmul(0.7978845608028654f,
                           fadd(g, fmul(0.044715f, fmul(fmul(g, g), g))));
  return fmul(fmul(fmul(0.5f, g), fadd(1.0f, tanhf(inner))), u);
}
