// Row rmsnorm kernels, with and without the fused allreduce epilogue.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, _reduce_kernel (via
// rmsnorm_reduce_2d) and _kernel (via rmsnorm_2d), the Pallas TPU
// kernels.  One kernel serves both: with P partials it sums them in f32
// (the terminal reduce round of mpix_allreduce_rmsnorm), with P = 1 it
// is the plain fused rmsnorm.
//
// What it computes, per row of d values:
//   x[c]  = sum_p parts[p, row, c]                 (f32, in p order)
//   inv   = rsqrt(mean_c x[c]^2 + eps)
//   out[row, c] = (x[c] * inv) * w[c]              w = scale, or 1 + scale
// stored once in the parts' dtype.
//
// Bound: bytes, (P + 1) * R * d * elem (each partial read once, the
// output written once; the scale is d values, read in its own dtype and
// widened to f32 in registers).  The design keeps the
// reduced row out of device memory: one CTA owns a row, sums the P
// partials into an f32 row in shared memory, reduces the square sum
// across the block (warp shuffles, then shared memory) and normalises
// from shared memory, so device memory sees P reads and one write.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename TS>
__global__ void rmsnorm_rows_kernel(const T* __restrict__ parts,
                                    const TS* __restrict__ scale,
                                    T* __restrict__ out, int P, int64_t R,
                                    int d, float eps, int gemma) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [d] reduced row, f32
  float* warp_sums = smem + d;         // [32]
  const int64_t row = blockIdx.x;
  const int64_t stride_p = R * (int64_t)d;
  const T* src = parts + row * d;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = to_f32(src[c]);
    for (int p = 1; p < P; ++p) acc += to_f32(src[p * stride_p + c]);
    xs[c] = acc;
    ss += acc * acc;
  }
  // block reduction of the square sum: shuffles, then one warp
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_down_sync(0xffffffffu, ss, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    ss = lane < nwarps ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_down_sync(0xffffffffu, ss, off);
    if (lane == 0) warp_sums[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / (float)d + eps);

  T* dst = out + row * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float w = to_f32(scale[c]);
    if (gemma) w = 1.f + w;
    dst[c] = from_f32<T>((xs[c] * inv) * w);
  }
}

// Shared memory one CTA may use on sm_90 (227 KB); the wrapper rejects
// rows wider than it holds.
constexpr int kSmemMax = 232448;

// Opt the kernel in to kSmemMax of dynamic shared memory, once per
// device and instantiation, outside the per-launch path.
template <typename T, typename TS>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(rmsnorm_rows_kernel<T, TS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, typename TS>
int launch(const void* parts, const void* scale, void* out, int P,
           int64_t R, int d, float eps, int gemma, int threads,
           cudaStream_t stream) {
  const size_t smem = ((size_t)d + 32) * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T, TS>();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_rows_kernel<T, TS><<<(unsigned)R, threads, smem, stream>>>(
      static_cast<const T*>(parts), static_cast<const TS*>(scale),
      static_cast<T*>(out), P, R, d, eps, gemma);
  return (int)cudaGetLastError();
}

template <typename T>
int with_scale(int sdtype, const void* parts, const void* scale, void* out,
               int P, int64_t R, int d, float eps, int gemma, int threads,
               cudaStream_t st) {
  switch (sdtype) {
    case 0: return launch<T, float>(parts, scale, out, P, R, d, eps, gemma,
                                    threads, st);
    case 1: return launch<T, __nv_bfloat16>(parts, scale, out, P, R, d, eps,
                                            gemma, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int sdtype, const void* parts, const void* scale,
             void* out, int P, int64_t R, int d, float eps, int gemma,
             int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return with_scale<float>(sdtype, parts, scale, out, P, R, d, eps,
                                     gemma, threads, st);
    case 1: return with_scale<__nv_bfloat16>(sdtype, parts, scale, out, P, R,
                                             d, eps, gemma, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (parts [P, R, d] and out [R, d]) and sdtype (scale [d]):
// 0 = float32, 1 = bfloat16.  The scale is widened to f32 in the kernel,
// as the reference reads it in f32 whatever its dtype.
extern "C" int repro_rmsnorm_reduce(int dtype, int sdtype, const void* parts,
                                    const void* scale, void* out, int P,
                                    int64_t R, int d, float eps, int gemma,
                                    int threads, void* stream) {
  return dispatch(dtype, sdtype, parts, scale, out, P, R, d, eps, gemma,
                  threads, stream);
}

// The plain fused rmsnorm: the same kernel with one partial.
extern "C" int repro_rmsnorm(int dtype, int sdtype, const void* x,
                             const void* scale, void* out, int64_t R, int d,
                             float eps, int gemma, int threads,
                             void* stream) {
  return dispatch(dtype, sdtype, x, scale, out, 1, R, d, eps, gemma, threads,
                  stream);
}
