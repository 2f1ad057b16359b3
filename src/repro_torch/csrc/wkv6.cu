// The RWKV-6 ("Finch") wkv recurrence.
//
// Replaces: src/repro/kernels/wkv6/kernel.py, _kernel (via wkv6_bhtn),
// the Pallas TPU kernel.
//
// What it computes, for each batch row b and head h, from S = 0:
//   y_t[m]  = sum_n r_t[n] * (S[n, m] + u[n] * k_t[n] * v_t[m])
//   S[n, m] = w_t[n] * S[n, m] + k_t[n] * v_t[m]
// in f32.  r, k, v (one dtype) and w ([B, T, H, N], read through their
// strides, the last dim contiguous) and u ([H, N], contiguous) are each
// read in their own dtype, f32 or bf16; y is written once, in f32, as
// [B, T, H, N].
//
// Bound at the rwkv6-3b prefill (B 1, T 8192, H 40, N 64, bf16 r/k/v, f32
// w): bytes, 14 B per (token, channel) = 293.6 MB, 0.088 ms at 3.35 TB/s;
// the operations (4 N^2 per token and head, 5.4 GFLOP) take 0.080 ms at
// 67 TFLOP/s f32.  Neither holds this kernel: the T steps of a column are
// serial, so its time is T times the latency of one step.
//
// Design.  Column m of S evolves on its own, so the state never leaves
// registers: SPLIT threads share a column, each holding R = N / SPLIT of
// its rows (rows j, j + SPLIT, ...), and they add their partial y_t[m]
// with warp shuffles.  A CTA of 64 threads owns COLS = 64 / SPLIT columns
// of one (b, h); a head's columns spread over N / COLS CTAs, so that
// B = 1 still puts work on most SMs (each CTA reads its head's r, k, w
// itself).  r_t, k_t and w_t are shared by every column of the head: the
// CTA stages CHUNK steps of them at a time in shared memory, widened to
// f32 and packed {r, k, w} per row, beside its own columns of v.  The
// next chunk's loads are issued into registers (raw, unconverted) before
// the current chunk is computed, so their latency hides behind it.  The
// TPU kernel's block_t tiling is not carried over: any T >= 1 runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // per CTA
constexpr int kChunk = 8;      // steps staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Wkv6Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* u;
  float* y;
  int64_t sr[3], sk[3], sv[3], sw[3];  // strides over (b, t, h), elements
  int T, H;
  int cu;                              // u's dtype code: 0 f32, 1 bf16
};

template <int N>
struct Tiling {
  static constexpr int SPLIT = N >= 64 ? N / 16 : 64 / N;  // per column
  static constexpr int R = N / SPLIT;                      // rows a thread
  static constexpr int COLS = kThreads / SPLIT;            // per CTA
  static constexpr int PER = kChunk * N / kThreads;        // r/k/w loads
  static constexpr int VPER = kChunk * COLS / kThreads;    // v loads
  static_assert(R * SPLIT == N && COLS * SPLIT == kThreads, "tiling");
  static_assert(PER >= 1 && VPER >= 1 && 32 % SPLIT == 0, "tiling");
};

template <int N, typename TX, typename TW>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(const Wkv6Args a) {
  using Tl = Tiling<N>;
  constexpr int R = Tl::R, SPLIT = Tl::SPLIT, COLS = Tl::COLS;
  __shared__ float4 rkw[kChunk][N];    // {r, k, w, -} per step and row
  __shared__ float vs[kChunk][COLS];   // the CTA's columns of v

  const int tid = threadIdx.x;
  const int c = tid / SPLIT, j = tid % SPLIT;
  const int col0 = blockIdx.x * COLS;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const TX* rp = static_cast<const TX*>(a.r) + b * a.sr[0] + h * a.sr[2];
  const TX* kp = static_cast<const TX*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const TX* vp = static_cast<const TX*>(a.v) + b * a.sv[0] + h * a.sv[2]
                 + col0;
  const TW* wp = static_cast<const TW*>(a.w) + b * a.sw[0] + h * a.sw[2];
  const int64_t y_step = (int64_t)a.H * N;
  float* yp = a.y + (b * a.T * a.H + h) * N + col0 + c;

  // the next chunk, as loaded (converted when it is staged)
  TX pr[Tl::PER], pk[Tl::PER], pv[Tl::VPER];
  TW pw[Tl::PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < Tl::PER; ++i) {
      const int e = tid + i * kThreads, n = e % N;
      const int64_t t = t0 + e / N;
      if (t < a.T) {
        pr[i] = rp[t * a.sr[1] + n];
        pk[i] = kp[t * a.sk[1] + n];
        pw[i] = wp[t * a.sw[1] + n];
      }
    }
#pragma unroll
    for (int i = 0; i < Tl::VPER; ++i) {
      const int e = tid + i * kThreads;
      const int64_t t = t0 + e / COLS;
      if (t < a.T) pv[i] = vp[t * a.sv[1] + e % COLS];
    }
  };

  float S[R], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    S[i] = 0.f;
    const int64_t iu = h * N + i * SPLIT + j;
    u[i] = a.cu ? __bfloat162float(
                      static_cast<const __nv_bfloat16*>(a.u)[iu])
                : static_cast<const float*>(a.u)[iu];
  }

  fetch(0);
  for (int t0 = 0; t0 < a.T; t0 += kChunk) {
    const int len = min(kChunk, a.T - t0);
    __syncthreads();                           // the last chunk is read
#pragma unroll
    for (int i = 0; i < Tl::PER; ++i) {
      const int e = tid + i * kThreads;
      if (e / N < len)
        rkw[e / N][e % N] = make_float4(to_f32(pr[i]), to_f32(pk[i]),
                                        to_f32(pw[i]), 0.f);
    }
#pragma unroll
    for (int i = 0; i < Tl::VPER; ++i) {
      const int e = tid + i * kThreads;
      if (e / COLS < len) vs[e / COLS][e % COLS] = to_f32(pv[i]);
    }
    __syncthreads();
    if (t0 + kChunk < a.T) fetch(t0 + kChunk);  // in flight meanwhile
    for (int tt = 0; tt < len; ++tt) {
      const float vm = vs[tt][c];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 e = rkw[tt][i * SPLIT + j];
        const float kv = e.y * vm;
        acc = fmaf(e.x, fmaf(u[i], kv, S[i]), acc);
        S[i] = fmaf(e.z, S[i], kv);
      }
#pragma unroll
      for (int off = SPLIT / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (j == 0) yp[(int64_t)(t0 + tt) * y_step] = acc;
    }
  }
}

template <int N, typename TX, typename TW>
int launch(const Wkv6Args& a, int B, cudaStream_t stream) {
  dim3 grid(N / Tiling<N>::COLS, a.H, B);
  wkv6_kernel<N, TX, TW><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int by_head_size(const Wkv6Args& a, int B, int N, cudaStream_t st) {
  switch (N) {
    case 8: return launch<8, TX, TW>(a, B, st);
    case 16: return launch<16, TX, TW>(a, B, st);
    case 32: return launch<32, TX, TW>(a, B, st);
    case 64: return launch<64, TX, TW>(a, B, st);
    case 128: return launch<128, TX, TW>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w: [B, T, H, N] with the given (b, t, h) strides and a
// contiguous last dim; u: [H, N] contiguous; y: [B, T, H, N] f32,
// contiguous.  Dtype codes 0 = float32, 1 = bfloat16: one for r/k/v, one
// for w, one for u.  N is 8, 16, 32, 64 or 128.  Returns a cudaError_t
// (0 on success).
extern "C" int repro_wkv6(int cx, int cw, int cu, const void* r,
                          const void* k, const void* v, const void* w,
                          const void* u, float* y, int64_t r_sb,
                          int64_t r_st, int64_t r_sh, int64_t k_sb,
                          int64_t k_st, int64_t k_sh, int64_t v_sb,
                          int64_t v_st, int64_t v_sh, int64_t w_sb,
                          int64_t w_st, int64_t w_sh, int B, int T, int H,
                          int N, void* stream) {
  if ((cx | cw | cu) & ~1) return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Wkv6Args a{r, k, v, w, u, y,
             {r_sb, r_st, r_sh}, {k_sb, k_st, k_sh},
             {v_sb, v_st, v_sh}, {w_sb, w_st, w_sh},
             T, H, cu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cx == 0 && cw == 0) return by_head_size<float, float>(a, B, N, st);
  if (cx == 0) return by_head_size<float, __nv_bfloat16>(a, B, N, st);
  if (cw == 0) return by_head_size<__nv_bfloat16, float>(a, B, N, st);
  return by_head_size<__nv_bfloat16, __nv_bfloat16>(a, B, N, st);
}
