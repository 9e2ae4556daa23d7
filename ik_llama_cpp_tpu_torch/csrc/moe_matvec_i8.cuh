// The int8 matvec pieces shared by the MoE decode kernels 7, 8 (csrc/
// moe_decode_i8.cu) and 11 (csrc/moe_decode_fused_i8.cu): a 16-byte load
// of K-contiguous codes and the exact int32 dot of two 16-byte chunks by
// __dp4a.
#pragma once

#include "moe_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

IK_DEV int dot16(const int4& a, const int4& b) {
  int s = __dp4a(a.x, b.x, 0);
  s = __dp4a(a.y, b.y, s);
  s = __dp4a(a.z, b.z, s);
  return __dp4a(a.w, b.w, s);
}

IK_DEV int4 ldg16(const int8_t* p) { return __ldg(reinterpret_cast<const int4*>(p)); }

}  // namespace
