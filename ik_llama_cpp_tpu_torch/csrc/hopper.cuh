// Hopper primitives of the port's tiled kernels (kernel A's
// qmatmul_i8_wgmma_kernel, kernel D's qmatmul_wgmma_kernel and kernel 15's
// qmatmul4_wgmma_kernel): mbarriers, TMA loads and the host-side tensor-map
// encoder, warpgroup MMA fences and waits, the 128-byte swizzle descriptor,
// setmaxnreg. Compiled into each kernel library on its own.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

IK_DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
IK_DEV void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
// Waits for the completion of the barrier's phase of this parity.
IK_DEV void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
IK_DEV void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
IK_DEV void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
// An arrive on b once every cp.async this thread issued before it has landed.
IK_DEV void mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(b)) : "memory");
}
IK_DEV void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
// The (c0 = inner, c1 = row) box of a 2-D tensor map into shared memory;
// the bytes land on barrier b.
IK_DEV void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* b, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(b)),
        "r"(c0), "r"(c1)
      : "memory");
}
template <int R>
IK_DEV void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R)); }
template <int R>
IK_DEV void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R)); }

IK_DEV void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
IK_DEV void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
IK_DEV void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// Pins the accumulator registers in program order around the async MMAs.
template <int N>
IK_DEV void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
IK_DEV void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of a K-major operand in 128-byte swizzled rows
// (what TMA's SWIZZLE_128B writes): 8-row groups 1024 bytes apart, no
// leading offset; +2 (32 bytes) steps one 32-byte k slice along the row.
IK_DEV uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A row-major (rows, inner) matrix of `dt` elements, rows `row_bytes`
// apart (a multiple of 16), as boxes of box_inner x box_rows; what lies
// past the matrix reads as zeros.
cudaError_t tensor_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt,
                          uint64_t inner, uint64_t rows, uint64_t row_bytes, uint32_t box_inner,
                          uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn;
  cudaError_t e = encoder(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
