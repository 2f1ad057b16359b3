// Whole-schedule transport kernel: one launch runs every compiled round
// of a CommSchedule on the global slot buffer [n, s, L] (L = the slot's
// flattened payload, C*F elements).
//
// Replaces: src/repro/core/pallas_lowering.py, PallasExec._kernel (the
// Pallas TPU kernel that bakes the routing program as static indices).
//
// What it computes (per column c of the payload, independently):
//   work[r, i] = in[r, pre[r, i]]                       (stage + pre fold)
//   for each round:
//     phase 1: stage[e, j] = g[e, j] >= 0 ? work[src[e], g[e, j]] : 0
//     phase 2: for e, then j:  if t[e, j] >= 0
//                work[dst[e], t[e, j]] = reduce ? work[..] + stage[e, j]
//                                               : stage[e, j]
//   out[r, i] = work[r, post[r, i]]                     (drain + post)
// Rows never mix, so each CTA owns a tile of `tile` columns across all
// n*s slots and runs every round for it: no grid-wide barrier.
//
// Bitwise contract with SimTransport.run_reference: reduce adds land one
// (edge, position) at a time in that order, and bfloat16 adds in f32
// and rounds back after every add (__float2bfloat16_rn), as ml_dtypes and
// the Pallas kernel do.  Masked gathers stage +0 and are still added to
// live targets (x + 0 turns -0.0 into +0.0).  A rank that is not a
// destination keeps its row.
//
// Bound: bytes.  The work is 2 x the global buffer (each element read
// once and written once); the routing itself is shared-memory traffic.
// The design keeps every intermediate round out of device memory: the
// tile stays in shared memory from stage-in to drain, so device memory
// sees one read and one write whatever the round count.
//
// Tables are int32 device arrays packed once per CompiledExec:
//   meta [R, 5] = (m, k, reduce, edge_off, pos_off)
//   esrc/edst [sum m], g/t [sum m*k], pre/post [n*s] (or null).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Acc {
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T zero() { return T(0); }
};
template <> struct Acc<__nv_bfloat16> {
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
};

template <typename T>
__global__ void schedule_exec_kernel(
    const T* __restrict__ in, T* __restrict__ out,
    const int* __restrict__ pre, const int* __restrict__ post,
    const int* __restrict__ meta, const int* __restrict__ esrc,
    const int* __restrict__ edst, const int* __restrict__ g,
    const int* __restrict__ t, int rounds, int ns, int s, int64_t L,
    int64_t chunk_len, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* work = reinterpret_cast<T*>(smem_raw);         // [ns, tile]
  T* stage = work + (int64_t)ns * tile;             // [max m*k, tile]

  const int64_t c_in_chunk = (int64_t)blockIdx.x * tile;
  const int64_t col0 = (int64_t)blockIdx.y * chunk_len + c_in_chunk;
  const int64_t left = chunk_len - c_in_chunk;
  const int width = left < tile ? (int)left : tile;

  // stage in, applying the pre fold
  for (int idx = threadIdx.x; idx < ns * tile; idx += blockDim.x) {
    const int row = idx / tile, c = idx - row * tile;
    if (c < width) {
      const int r = row / s;
      const int srow = pre ? r * s + pre[row] : row;
      work[idx] = in[(int64_t)srow * L + col0 + c];
    }
  }
  __syncthreads();

  for (int q = 0; q < rounds; ++q) {
    const int m = meta[q * 5 + 0], k = meta[q * 5 + 1];
    const int reduce = meta[q * 5 + 2];
    const int eo = meta[q * 5 + 3], po = meta[q * 5 + 4];
    // phase 1: every edge's payload from the pre-round state
    for (int idx = threadIdx.x; idx < m * k * tile; idx += blockDim.x) {
      const int ej = idx / tile, c = idx - ej * tile;
      const int gi = g[po + ej];
      stage[idx] = gi >= 0
          ? work[(esrc[eo + ej / k] * s + gi) * tile + c]
          : Acc<T>::zero();
    }
    __syncthreads();
    // phase 2: land in (edge, position) order; each thread owns columns
    for (int c = threadIdx.x; c < tile; c += blockDim.x) {
      for (int e = 0; e < m; ++e) {
        const int base = edst[eo + e] * s;
        for (int j = 0; j < k; ++j) {
          const int ti = t[po + e * k + j];
          if (ti < 0) continue;                      // dropped slot
          const T v = stage[(e * k + j) * tile + c];
          T* p = &work[(base + ti) * tile + c];
          *p = reduce ? Acc<T>::add(*p, v) : v;
        }
      }
    }
    __syncthreads();
  }

  // drain through the post permutation
  for (int idx = threadIdx.x; idx < ns * tile; idx += blockDim.x) {
    const int row = idx / tile, c = idx - row * tile;
    if (c < width) {
      const int r = row / s;
      const int wrow = post ? r * s + post[row] : row;
      out[(int64_t)row * L + col0 + c] = work[wrow * tile + c];
    }
  }
}

// Shared memory one CTA may use on sm_90 (227 KB); the wrapper sizes
// the tile to stay under it.
constexpr int kSmemMax = 232448;

// Opt the kernel in to kSmemMax of dynamic shared memory, once per
// device and type, outside the per-launch path.
template <typename T>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(schedule_exec_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* in, void* out, const int* pre, const int* post,
           const int* meta, const int* esrc, const int* edst, const int* g,
           const int* t, int rounds, int n, int s, int64_t L, int chunks,
           int tile, int stage_rows, int threads, cudaStream_t stream) {
  const int ns = n * s;
  const size_t smem = (size_t)(ns + stage_rows) * tile * sizeof(T);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return (int)err;
  const int64_t chunk_len = L / chunks;
  dim3 grid((unsigned)((chunk_len + tile - 1) / tile), (unsigned)chunks);
  schedule_exec_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), pre, post, meta,
      esrc, edst, g, t, rounds, ns, s, L, chunk_len, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int repro_schedule_exec(
    int dtype, const void* in, void* out, const int* pre, const int* post,
    const int* meta, const int* esrc, const int* edst, const int* g,
    const int* t, int rounds, int n, int s, int64_t L, int chunks, int tile,
    int stage_rows, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(in, out, pre, post, meta, esrc, edst, g, t,
                                 rounds, n, s, L, chunks, tile, stage_rows,
                                 threads, st);
    case 1: return launch<__nv_bfloat16>(in, out, pre, post, meta, esrc,
                                         edst, g, t, rounds, n, s, L, chunks,
                                         tile, stage_rows, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
