// PTX helpers shared by the Hopper kernels (schedule_exec.cu,
// flash_attention.cu, mamba_scan.cu): mbarriers with a bounded wait, the
// async-proxy fence, and the run-time lookup of cuTensorMapEncodeTiled.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ---- mbarriers and bulk copies (PTX) ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of the given parity has completed.  A wait that
// outlasts kWaitCycles (about 17 s) faults the launch instead of hanging
// the card.  The loop, clock and trap are one PTX block: a __trap() in
// C++ joins every caller's paths at one exit, and ptxas then holds a
// warp-specialised kernel to the register count it starts with,
// whatever setmaxnreg grants its warpgroups.
constexpr long long kWaitCycles = 1LL << 35;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u64 t0, t1;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "mov.u64 t1, %%clock64;\n\t"
      "sub.u64 t1, t1, t0;\n\t"
      "setp.lt.u64 p, t1, %2;\n\t"
      "@p bra WAIT;\n\t"
      "trap;\n"
      "DONE:\n\t}"
      :: "r"(bar), "r"(parity), "l"(kWaitCycles) : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to
// later bulk copies (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- host side --------------------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already runs on
// (looked up at run time, so the library links against the runtime only).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_LAZY);
    if (h) fn = reinterpret_cast<EncodeTiled>(
        dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace
