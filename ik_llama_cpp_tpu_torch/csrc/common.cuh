// Shared helpers of the port's hand-written Hopper kernels: tensor-core
// mma.sync wrappers, cp.async, and the C error-string entry point that
// ops/_cuda.py reads. Compiled into each kernel library on its own.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define IK_DEV __device__ __forceinline__

extern "C" const char* ik_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 16-byte asynchronous copy global -> shared (sm_80+).
IK_DEV void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// The same copy reading `bytes` (0 or 16) of gmem and zero-filling the rest;
// with 0 nothing is read, but gmem must still be a valid address.
IK_DEV void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}
IK_DEV void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Four 8x8 b16 matrices from shared memory: lane l gives the 16-byte row
// l % 8 of matrix l / 8; r[i] holds matrix i, lane (g, t) its row g,
// columns 2t, 2t+1. The .trans form gives lane (g, t) rows 2t, 2t+1 of
// column g instead.
IK_DEV void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
IK_DEV void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
template <int N>
IK_DEV void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, int32 accumulate.
// Fragments (g = lane/4, t = lane%4): a0 = A[g][4t..4t+3], a1 = A[g+8][4t..],
// a2 = A[g][16+4t..], a3 = A[g+8][16+4t..]; b0 = B[4t..4t+3][g],
// b1 = B[16+4t..][g]; d0,d1 = D[g][2t,2t+1], d2,d3 = D[g+8][2t,2t+1].
IK_DEV void mma_s8_16832(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, float accumulate.
// Fragments: a0 = A[g][2t,2t+1], a1 = A[g+8][2t..], a2 = A[g][8+2t..],
// a3 = A[g+8][8+2t..]; b0 = B[2t,2t+1][g], b1 = B[8+2t..][g];
// d as for the int8 form. The lower half of each 32-bit register holds the
// lower column (row of B).
IK_DEV void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

IK_DEV uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

IK_DEV uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sets the dynamic shared memory limit of a kernel once per process.
template <typename K>
inline cudaError_t set_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}
