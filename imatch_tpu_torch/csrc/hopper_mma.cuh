// Helpers shared by the tensor-core kernels (K1 bf16 at Q >= 2, K2 bf16,
// K5):
// PTX wrappers for mma.sync, ldmatrix and cp.async on sm_90a, and the
// once-per-device opt-in to dynamic shared memory.
//
// Fragment layouts of mma.m16n8k16 (bf16 in, fp32 out), for lane l with
// g = l / 4 and t = l % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//   A (16 x 16, row-major): a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t, 2t+1],
//                           a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"):      b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8, fp32):       c[0], c[1] = C[g][2t, 2t+1], c[2], c[3] = C[g+8][2t, 2t+1]
// Each 32-bit register holds two bf16, the lower column (or row, for B) in
// the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace hopper {

// D += A * B, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest-even bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same, each matrix transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two transposed matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// A 16-byte asynchronous copy to shared memory; with `pred` false nothing
// is read and the 16 bytes are filled with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kMaxDevices = 64;

// Opts `kernel` into `bytes` of dynamic shared memory on the current device
// (a launch above 48 KB of static plus dynamic shared memory needs it),
// calling cudaFuncSetAttribute only when that is more than it has already
// granted there: the call costs host time, and the small towers' calls are
// bound by the host's launch rate. `granted` is one static array per
// kernel instance (zero-initialised).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<int> (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && granted[dev].load(std::memory_order_relaxed) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached) {
    int cur = granted[dev].load(std::memory_order_relaxed);
    while (cur < bytes && !granted[dev].compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

}  // namespace hopper
