// Row rmsnorm kernels, with and without the fused allreduce epilogue.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, _reduce_kernel (via
// rmsnorm_reduce_2d) and _kernel (via rmsnorm_2d), the Pallas TPU
// kernels.  One source serves both: with P partials it sums them in f32
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
// widened to f32 in registers).  Two bodies, chosen by the wrapper
// (kernels/rmsnorm/kernel.py, rmsnorm_body) and re-checked here:
//
// The vector body (rmsnorm_vec_kernel), for rows that are whole 16-byte
// vectors (8 bf16 or 4 f32) with input and output on 16-byte boundaries,
// streams at the memory's rate.  A CTA of `threads` threads holds a row
// in registers, VPT vectors a thread (a compile-time count, vector
// i * threads + tid, so neighbouring threads load neighbouring 16
// bytes), and never stages it in shared memory.  The grid is the
// instantiation's occupancy times the SM count; each CTA loops over rows
// blockIdx.x, + gridDim.x, ..., and widens its slice of the scale (and
// adds 1 for gemma) into registers once.  With P = 1 the next row's
// vectors are loaded while the current row is normalised; with P > 1
// the partials of a vector are loaded kPGroup at a time, all in flight
// before the first add, and added in p order.  The square sum is
// reduced with warp shuffles and one small shared array per row parity
// (one barrier a row).
//
// The scalar body (rmsnorm_rows_kernel) takes every other row: widths
// that are no whole vector, pointers off 16 bytes, rows wider than
// kMaxVpt * kMaxThreads vectors.  One CTA per row sums the partials into
// an f32 row in shared memory and normalises from there.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxVpt = 4;        // vectors a thread holds (vector body)
constexpr int kMaxThreads = 512;  // its CTA size, so 128 registers a thread
constexpr int kPGroup = 8;        // partials of a vector in flight

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

// A 16-byte vector of T, widened to f32 and narrowed back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  __device__ static __forceinline__ void widen(const uint4& q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  __device__ static __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  // element 2q is the low half of word q (little-endian)
  __device__ static __forceinline__ void widen(const uint4& q, float* f) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static __forceinline__ uint4 narrow(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};

// Sum of v over the block, the same value in every thread: shuffles,
// then one slot a warp in `red`, read back by every thread in warp order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int k = 0; k < nwarps; ++k) s += red[k];
  return s;
}

template <typename T, typename TS, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_vec_kernel(const T* __restrict__ parts, const TS* __restrict__ scale,
                   T* __restrict__ out, int P, int64_t R, int d, float eps,
                   int gemma) {
  using V = Vec<T>;
  constexpr int E = V::E;
  __shared__ float red[2][32];     // square-sum warp slots, by row parity
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int nvec = d / E;
  const uint4* src = reinterpret_cast<const uint4*>(parts);
  uint4* dst = reinterpret_cast<uint4*>(out);
  const int64_t stride_p = R * (int64_t)nvec;      // vectors between partials

  int col[VPT];                    // this thread's vectors, -1 past the row
  float w[VPT][E];                 // its slice of the (1 +) scale, f32
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = i * nthr + tid;
    col[i] = v < nvec ? v : -1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float s = v < nvec ? to_f32(scale[(int64_t)v * E + e]) : 0.f;
      w[i][e] = gemma ? 1.f + s : s;
    }
  }

  int64_t row = blockIdx.x;
  int parity = 0;
  if (P == 1) {
    uint4 cur[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      cur[i] = col[i] >= 0 && row < R ? __ldg(src + row * nvec + col[i])
                                      : make_uint4(0, 0, 0, 0);
    for (; row < R; row += gridDim.x) {
      const int64_t next = row + gridDim.x;
      uint4 nxt[VPT];              // in flight while this row is normalised
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        nxt[i] = col[i] >= 0 && next < R
                     ? __ldg(src + next * nvec + col[i])
                     : make_uint4(0, 0, 0, 0);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        float f[E];
        V::widen(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
      }
      const float inv = rsqrtf(block_sum(ss, red[parity]) / (float)d + eps);
      parity ^= 1;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (col[i] < 0) continue;
        float f[E];
        V::widen(cur[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = (f[e] * inv) * w[i][e];
        dst[row * nvec + col[i]] = V::narrow(f);
        cur[i] = nxt[i];
      }
    }
    return;
  }
  for (; row < R; row += gridDim.x) {
    float acc[VPT][E];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
      if (col[i] < 0) continue;
      const uint4* at = src + row * nvec + col[i];
      for (int p0 = 0; p0 < P; p0 += kPGroup) {
        uint4 q[kPGroup];
#pragma unroll
        for (int g = 0; g < kPGroup; ++g)
          if (p0 + g < P) q[g] = __ldg(at + (p0 + g) * stride_p);
#pragma unroll
        for (int g = 0; g < kPGroup; ++g) {
          if (p0 + g >= P) break;
          float f[E];
          V::widen(q[g], f);
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[i][e] = p0 + g == 0 ? f[e] : acc[i][e] + f[e];
        }
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(acc[i][e], acc[i][e], ss);
    const float inv = rsqrtf(block_sum(ss, red[parity]) / (float)d + eps);
    parity ^= 1;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (col[i] < 0) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = (acc[i][e] * inv) * w[i][e];
      dst[row * nvec + col[i]] = V::narrow(acc[i]);
    }
  }
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
// rows wider than the scalar body holds.
constexpr int kSmemMax = 232448;

// Opt the scalar body in to kSmemMax of dynamic shared memory, once per
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

// CTAs of the vector body resident on the card at `threads` a CTA: the
// instantiation's occupancy times the SM count, asked once per device,
// instantiation and block size.
template <typename T, typename TS, int VPT>
cudaError_t resident_ctas(int threads, int64_t* out) {
  static int64_t known[64][kMaxThreads / 32 + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int64_t* slot = dev < 64 ? &known[dev][threads / 32] : nullptr;
  if (slot && *slot) {
    *out = *slot;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rmsnorm_vec_kernel<T, TS, VPT>, threads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  if (slot) *slot = *out;
  return cudaSuccess;
}

template <typename T, typename TS, int VPT>
int launch_vec(const void* parts, const void* scale, void* out, int P,
               int64_t R, int d, float eps, int gemma, int threads,
               cudaStream_t stream) {
  int64_t ctas = 0;
  cudaError_t err = resident_ctas<T, TS, VPT>(threads, &ctas);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(R < ctas ? R : ctas);
  rmsnorm_vec_kernel<T, TS, VPT><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(parts), static_cast<const TS*>(scale),
      static_cast<T*>(out), P, R, d, eps, gemma);
  return (int)cudaGetLastError();
}

template <typename T, typename TS>
int launch(const void* parts, const void* scale, void* out, int P,
           int64_t R, int d, float eps, int gemma, int vpt, int threads,
           cudaStream_t stream) {
  if (vpt == 0) {                      // the scalar body
    const size_t smem = ((size_t)d + 32) * sizeof(float);
    if (smem > (size_t)kSmemMax || threads < 32 || threads > kMaxThreads)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem<T, TS>();
    if (err != cudaSuccess) return (int)err;
    rmsnorm_rows_kernel<T, TS><<<(unsigned)R, threads, smem, stream>>>(
        static_cast<const T*>(parts), static_cast<const TS*>(scale),
        static_cast<T*>(out), P, R, d, eps, gemma);
    return (int)cudaGetLastError();
  }
  // the vector body: the wrapper's choice, re-checked
  constexpr int E = Vec<T>::E;
  const int nvec = d / E;
  if (vpt < 1 || vpt > kMaxVpt || threads % 32 || threads < 32 ||
      threads > kMaxThreads || d % E || (int64_t)vpt * threads < nvec ||
      (reinterpret_cast<uintptr_t>(parts) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  switch (vpt) {
    case 1: return launch_vec<T, TS, 1>(parts, scale, out, P, R, d, eps,
                                        gemma, threads, stream);
    case 2: return launch_vec<T, TS, 2>(parts, scale, out, P, R, d, eps,
                                        gemma, threads, stream);
    case 3: return launch_vec<T, TS, 3>(parts, scale, out, P, R, d, eps,
                                        gemma, threads, stream);
    default: return launch_vec<T, TS, 4>(parts, scale, out, P, R, d, eps,
                                         gemma, threads, stream);
  }
}

template <typename T>
int with_scale(int sdtype, const void* parts, const void* scale, void* out,
               int P, int64_t R, int d, float eps, int gemma, int vpt,
               int threads, cudaStream_t st) {
  switch (sdtype) {
    case 0: return launch<T, float>(parts, scale, out, P, R, d, eps, gemma,
                                    vpt, threads, st);
    case 1: return launch<T, __nv_bfloat16>(parts, scale, out, P, R, d, eps,
                                            gemma, vpt, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int sdtype, const void* parts, const void* scale,
             void* out, int P, int64_t R, int d, float eps, int gemma,
             int vpt, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return with_scale<float>(sdtype, parts, scale, out, P, R, d, eps,
                                     gemma, vpt, threads, st);
    case 1: return with_scale<__nv_bfloat16>(sdtype, parts, scale, out, P, R,
                                             d, eps, gemma, vpt, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (parts [P, R, d] and out [R, d]) and sdtype (scale [d]):
// 0 = float32, 1 = bfloat16.  The scale is widened to f32 in the kernel,
// as the reference reads it in f32 whatever its dtype.  vpt is the
// vector body's vectors a thread (1-4), or 0 for the scalar body;
// threads is the CTA size.  A vector body the row cannot take (width,
// alignment, vpt * threads short of the row) returns
// cudaErrorInvalidValue.
extern "C" int repro_rmsnorm_reduce(int dtype, int sdtype, const void* parts,
                                    const void* scale, void* out, int P,
                                    int64_t R, int d, float eps, int gemma,
                                    int vpt, int threads, void* stream) {
  return dispatch(dtype, sdtype, parts, scale, out, P, R, d, eps, gemma, vpt,
                  threads, stream);
}

// The plain fused rmsnorm: the same kernels with one partial.
extern "C" int repro_rmsnorm(int dtype, int sdtype, const void* x,
                             const void* scale, void* out, int64_t R, int d,
                             float eps, int gemma, int vpt, int threads,
                             void* stream) {
  return dispatch(dtype, sdtype, x, scale, out, 1, R, d, eps, gemma, vpt,
                  threads, stream);
}
