// Shared pieces of the MoE kernels: the expert activation and float
// arithmetic that nvcc may not contract into fused multiply-adds, so that
// the kernels round exactly where the plain PyTorch versions do.
#pragma once

#include "common.cuh"

constexpr int MOE_SG = 256;      // supergroup depth of the int8 expert codes
constexpr int MOE_SMEM_MAX = 232448;   // dynamic shared memory a block may use on sm_90

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
