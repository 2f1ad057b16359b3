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
// 67 TFLOP/s f32.  A single pass cannot reach either: the T steps of a
// column are serial, and one step's latency times T = 8192 set the
// single-pass kernel's time, 2.1307 ms (about 0.26 us a step; NVIDIA H100
// 80GB HBM3, 700.00 W).
//
// Design: a chunk-parallel scan that keeps the exact rank-1 recurrence
// inside each chunk.  T is cut into NC chunks of C steps (C chosen by
// the wrapper, kernels/wkv6/kernel.py wkv6_chunk) and one call runs up to
// three kernels:
//   1. wkv6_state_kernel, for every (b, h, chunk c < NC - 1, column
//      group): the recurrence from a zero state over the chunk's steps,
//      no y, taken from the last step back as rank-1 updates of k_t
//      times the decay of the later steps (one fused multiply-add a
//      state entry and step); writes the chunk's local state S_loc(c)
//      [N, N] and its decay product D(c)[n] = prod_t w_t[n];
//   2. wkv6_carry_kernel, parallel over (b, h, n, m), in chunk order:
//      S_in(1) = S_loc(0), S_in(c + 1) = D(c)[n] * S_in(c) + S_loc(c),
//      written over S_loc(c) in place (NC > 2 only);
//   3. wkv6_out_kernel, for every chunk: from S_in(c) (zero for c = 0)
//      the chunk's steps again, writing y.
// The serial chain falls from T steps to about 2C + T/C.  No division
// anywhere: every factor is a decay <= 1, so fast-decay channels
// underflow to 0 and never overflow (the matmul "intra-chunk attention"
// form divides by cumulative decays and overflows).  The results differ
// from the serial recurrence only by rounding the decay products.  T <= C
// runs phase 3 alone.  The scratch (S_loc / S_in, (NC - 1) B H N^2 f32,
// and D, (NC - 1) B H N f32) is allocated by the wrapper.
//
// The step tiling of phases 1 and 3: column m of S evolves on its own,
// so the state never leaves registers.  SPLIT threads share a group of
// CPT columns (4 at N = 64 and 128), each holding R = N / SPLIT rows of
// them, and add their partial y_t with warp shuffles; a CTA of 64
// threads owns COLS columns of one (b, h, chunk) (all 64 at N = 64).
// r_t, k_t, w_t and the bonus term's r_t u k_t are shared by every column
// of the head: the CTA stages kStage steps of them at a time in shared
// memory, widened to f32, one array each (phase 1 stages k_t P_t only),
// beside its columns of v, and a thread reads its rows four at a time
// and its columns' v at once (16-byte loads), so one load feeds 4 rows x
// CPT columns.  Phase 3 computes y_t[m] = sum_n r_t[n] S[n, m] + v_t[m]
// sum_n r_t[n] u[n] k_t[n]: three operations a state entry and step.
// The next stage's loads are issued into registers (raw, unconverted)
// before the current one is computed, so their latency hides behind it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 64;   // a CTA of phases 1 and 3
constexpr int kStage = 8;      // steps staged at a time
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8; // chunks whose loads the carry issues at once

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
  float* s;                            // [B, H, NC - 1, N, N] chunk states
  float* dec;                          // [B, H, NC - 1, N] decay products
  int64_t sr[3], sk[3], sv[3], sw[3];  // strides over (b, t, h), elements
  int T, H, C, NC;                     // C steps a chunk, NC chunks
  int cu;                              // u's dtype code: 0 f32, 1 bf16
};

// The step tiling of a head size: SPLIT threads share a column group of
// CPT columns, each holding R = N / SPLIT of its rows in groups of RV
// consecutive rows (row group q of thread j: rows (q SPLIT + j) RV ...,
// so the SPLIT threads' RV-wide shared-memory loads are neighbours).
template <int N> struct Shape;
template <> struct Shape<8> { static constexpr int SPLIT = 8, CPT = 1; };
template <> struct Shape<16> { static constexpr int SPLIT = 4, CPT = 1; };
template <> struct Shape<32> { static constexpr int SPLIT = 2, CPT = 1; };
template <> struct Shape<64> { static constexpr int SPLIT = 4, CPT = 4; };
template <> struct Shape<128> { static constexpr int SPLIT = 8, CPT = 4; };

template <int N>
struct Tiling {
  static constexpr int SPLIT = Shape<N>::SPLIT, CPT = Shape<N>::CPT;
  static constexpr int R = N / SPLIT;                      // rows a thread
  static constexpr int RV = R < 4 ? 1 : 4;                 // rows a load
  static constexpr int COLS = kThreads / SPLIT * CPT;      // per CTA
  static constexpr int GROUPS = N / COLS;                  // CTAs a head
  static constexpr int VPER = kStage * COLS / kThreads;    // v loads
  static_assert(R * SPLIT == N && COLS * GROUPS == N, "tiling");
  static_assert(R % RV == 0 && (CPT == 1 || CPT == 4), "tiling");
  static_assert(VPER >= 1 && 32 % SPLIT == 0, "tiling");
};

// W (1 or 4) consecutive floats, as one load.
template <int W> struct Lds;
template <> struct Lds<1> {
  __device__ static __forceinline__ void get(const float* p, float* o) {
    o[0] = *p;
  }
};
template <> struct Lds<4> {
  __device__ static __forceinline__ void get(const float* p, float* o) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x;
    o[1] = q.y;
    o[2] = q.z;
    o[3] = q.w;
  }
};

// W floats (1, or a multiple of 4) to 16-byte aligned memory.
template <int W>
__device__ __forceinline__ void put(float* p, const float* v) {
  if constexpr (W == 1) {
    p[0] = v[0];
  } else {
#pragma unroll
    for (int q = 0; q < W; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// Phases 1 (STATE) and 3 of one (b, h, chunk, column group).
//
// Phase 3 walks the chunk's steps forward from S_in(chunk) and writes
// y_t[m] = sum_n r_t[n] S[n, m] + v_t[m] sum_n r_t[n] u[n] k_t[n] (the
// bonus term's row sum staged once a step and row), then
// S = w_t S + k_t v_t^T: three operations a state entry and step.
//
// Phase 1 walks the chunk backward from a zero state and accumulates
// S_loc = sum_t (k_t * P_t) v_t^T, P_t[n] the product of w[n] over the
// chunk's steps after t (taken from the last step back), which is the
// recurrence from zero written as one fused multiply-add a state entry
// and step; the staging threads carry P from step to step, and its
// value after the chunk's first step is D(chunk).  Every factor is a
// decay <= 1: no division, nothing overflows.
template <int N, typename TX, typename TW, bool STATE>
__device__ __forceinline__ void chunk_steps(const Wkv6Args& a) {
  using Tl = Tiling<N>;
  constexpr int R = Tl::R, SPLIT = Tl::SPLIT, CPT = Tl::CPT, RV = Tl::RV;
  constexpr int COLS = Tl::COLS;
  constexpr int NU = (N + kThreads - 1) / kThreads;  // rows a thread stages
  constexpr int S3 = STATE ? 1 : kStage;             // phase 3's arrays
  // per step and row: phase 3 stages r, k, w and r u k; phase 1 stages
  // k P only
  __shared__ __align__(16) float sr[S3][N];
  __shared__ __align__(16) float sru[S3][N];
  __shared__ __align__(16) float sw[S3][N];
  __shared__ __align__(16) float sk[kStage][N];
  __shared__ __align__(16) float sv[kStage][COLS];   // the CTA's columns

  const int tid = threadIdx.x;
  const int cg = tid / SPLIT, j = tid % SPLIT;
  const int chunk = blockIdx.x / Tl::GROUPS;
  const int col0 = (blockIdx.x % Tl::GROUPS) * COLS;
  const int mycol = col0 + cg * CPT;                 // first of CPT columns
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int t_begin = chunk * a.C;
  const int t_end = min(a.T, t_begin + a.C);
  const TX* rp = static_cast<const TX*>(a.r) + b * a.sr[0] + h * a.sr[2];
  const TX* kp = static_cast<const TX*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const TX* vp = static_cast<const TX*>(a.v) + b * a.sv[0] + h * a.sv[2]
                 + col0;
  const TW* wp = static_cast<const TW*>(a.w) + b * a.sw[0] + h * a.sw[2];
  const int64_t y_step = (int64_t)a.H * N;
  float* yp = a.y + (b * a.T * a.H + h) * N + mycol;
  // this (b, h)'s chunk states; S_loc(chunk) is written at slot chunk,
  // and S_in(chunk) is read from slot chunk - 1
  const int64_t bh = b * a.H + h;
  float* sp = a.s + bh * (a.NC - 1) * (N * N) + mycol;

  // the next stage's loads, raw (converted when staged): rows
  // tid + q kThreads of every step, and the CTA's columns of v
  TX pr[NU][kStage], pk[NU][kStage], pv[Tl::VPER];
  TW pw[NU][kStage];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < NU; ++q) {
      const int n = tid + q * kThreads;
#pragma unroll
      for (int tt = 0; tt < kStage; ++tt) {
        const int64_t t = t0 + tt;
        if (n < N && t < t_end) {
          if (!STATE) pr[q][tt] = rp[t * a.sr[1] + n];
          pk[q][tt] = kp[t * a.sk[1] + n];
          pw[q][tt] = wp[t * a.sw[1] + n];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Tl::VPER; ++i) {
      const int e = tid + i * kThreads;
      const int64_t t = t0 + e / COLS;
      if (t < t_end) pv[i] = vp[t * a.sv[1] + e % COLS];
    }
  };

  // u (phase 3) or the running decay product P (phase 1) of those rows
  float us[NU], P[NU];
#pragma unroll
  for (int q = 0; q < NU; ++q) {
    const int64_t iu = h * N + (tid + q * kThreads) % N;
    P[q] = 1.f;
    us[q] = STATE ? 0.f
            : a.cu ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.u)[iu])
                   : static_cast<const float*>(a.u)[iu];
  }

  auto row_of = [&](int i) { return ((i / RV) * SPLIT + j) * RV + i % RV; };
  float S[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!STATE && chunk > 0) {            // S_in(chunk), global memory
      Lds<CPT>::get(sp + (int64_t)(chunk - 1) * N * N + row_of(i) * N, S[i]);
    } else {
#pragma unroll
      for (int q = 0; q < CPT; ++q) S[i][q] = 0.f;
    }
  }

  // stages of kStage steps: phase 3 forward, phase 1 from the last back
  const int stages = (t_end - t_begin + kStage - 1) / kStage;
  int st = STATE ? stages - 1 : 0;
  fetch(t_begin + st * kStage);
  for (int left = stages; left > 0; --left, st += STATE ? -1 : 1) {
    const int t0 = t_begin + st * kStage;
    const int len = min(kStage, t_end - t0);
    __syncthreads();                           // the last stage is read
#pragma unroll
    for (int q = 0; q < NU; ++q) {
      const int n = tid + q * kThreads;
      if (n >= N) continue;
      if constexpr (STATE) {
#pragma unroll
        for (int tt = kStage - 1; tt >= 0; --tt) {
          if (tt < len) {
            sk[tt][n] = to_f32(pk[q][tt]) * P[q];
            P[q] *= to_f32(pw[q][tt]);
          }
        }
      } else {
#pragma unroll
        for (int tt = 0; tt < kStage; ++tt) {
          if (tt < len) {
            const float kf = to_f32(pk[q][tt]), rf = to_f32(pr[q][tt]);
            sk[tt][n] = kf;
            sw[tt][n] = to_f32(pw[q][tt]);
            sr[tt][n] = rf;
            sru[tt][n] = rf * us[q] * kf;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Tl::VPER; ++i) {
      const int e = tid + i * kThreads;
      if (e / COLS < len) sv[e / COLS][e % COLS] = to_f32(pv[i]);
    }
    __syncthreads();
    if (left > 1) fetch(t0 + (STATE ? -kStage : kStage));  // in flight
    if constexpr (STATE) {
      for (int tt = len - 1; tt >= 0; --tt) {
        float vv[CPT];
        Lds<CPT>::get(&sv[tt][cg * CPT], vv);
#pragma unroll
        for (int g = 0; g < R / RV; ++g) {
          float kk[RV];
          Lds<RV>::get(&sk[tt][(g * SPLIT + j) * RV], kk);
#pragma unroll
          for (int e = 0; e < RV; ++e)
#pragma unroll
            for (int q = 0; q < CPT; ++q)
              S[g * RV + e][q] = fmaf(kk[e], vv[q], S[g * RV + e][q]);
        }
      }
    } else {
      for (int tt = 0; tt < len; ++tt) {
        float vv[CPT];
        Lds<CPT>::get(&sv[tt][cg * CPT], vv);
        float acc[CPT], ruk = 0.f;
#pragma unroll
        for (int q = 0; q < CPT; ++q) acc[q] = 0.f;
#pragma unroll
        for (int g = 0; g < R / RV; ++g) {
          const int at = (g * SPLIT + j) * RV;
          float kk[RV], ww[RV], rr[RV], ru[RV];
          Lds<RV>::get(&sk[tt][at], kk);
          Lds<RV>::get(&sw[tt][at], ww);
          Lds<RV>::get(&sr[tt][at], rr);
          Lds<RV>::get(&sru[tt][at], ru);
#pragma unroll
          for (int e = 0; e < RV; ++e) {
            const int i = g * RV + e;
            ruk += ru[e];
#pragma unroll
            for (int q = 0; q < CPT; ++q) {
              const float kv = kk[e] * vv[q];
              acc[q] = fmaf(rr[e], S[i][q], acc[q]);
              S[i][q] = fmaf(ww[e], S[i][q], kv);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          acc[q] = fmaf(vv[q], ruk, acc[q]);
#pragma unroll
          for (int off = SPLIT / 2; off > 0; off >>= 1)
            acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
        }
        if (j == 0) put<CPT>(yp + (int64_t)(t0 + tt) * y_step, acc);
      }
    }
  }
  if constexpr (STATE) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      put<CPT>(sp + (int64_t)chunk * N * N + row_of(i) * N, S[i]);
    if (blockIdx.x % Tl::GROUPS == 0) {      // one CTA of the head
#pragma unroll
      for (int q = 0; q < NU; ++q) {
        const int n = tid + q * kThreads;
        if (n < N) a.dec[(bh * (a.NC - 1) + chunk) * N + n] = P[q];
      }
    }
  }
}

template <int N, typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv6_state_kernel(const Wkv6Args a) {
  chunk_steps<N, TX, TW, true>(a);
}

template <int N, typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv6_out_kernel(const Wkv6Args a) {
  chunk_steps<N, TX, TW, false>(a);
}

// Phase 2: one thread per (b, h, n, m), the NC - 1 chunk states in
// order, kCarryBatch chunks' loads issued before their adds.
__global__ void __launch_bounds__(kCarryThreads)
wkv6_carry_kernel(float* __restrict__ s, const float* __restrict__ dec,
                  int64_t items, int N, int states) {
  const int64_t e = blockIdx.x * (int64_t)kCarryThreads + threadIdx.x;
  if (e >= items) return;
  const int64_t nn = (int64_t)N * N;
  const int64_t bh = e / nn, nm = e % nn;
  float* p = s + bh * states * nn + nm;
  const float* dp = dec + bh * states * N + nm / N;
  float acc = p[0];                            // S_in(1) = S_loc(0)
  for (int c0 = 1; c0 < states; c0 += kCarryBatch) {
    float loc[kCarryBatch], d[kCarryBatch];
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (c0 + q < states) {
        loc[q] = p[(c0 + q) * nn];
        d[q] = dp[(int64_t)(c0 + q) * N];
      }
    }
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (c0 + q < states) {
        acc = fmaf(d[q], acc, loc[q]);
        p[(c0 + q) * nn] = acc;
      }
    }
  }
}

template <int N, typename TX, typename TW>
int launch(const Wkv6Args& a, int B, cudaStream_t stream) {
  constexpr int G = Tiling<N>::GROUPS;
  if (a.NC > 1) {
    wkv6_state_kernel<N, TX, TW>
        <<<dim3((unsigned)(a.NC - 1) * G, a.H, B), kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (a.NC > 2) {
      const int64_t items = (int64_t)B * a.H * N * N;
      wkv6_carry_kernel<<<(unsigned)((items + kCarryThreads - 1) /
                                     kCarryThreads),
                          kCarryThreads, 0, stream>>>(a.s, a.dec, items, N,
                                                      a.NC - 1);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  wkv6_out_kernel<N, TX, TW>
      <<<dim3((unsigned)a.NC * G, a.H, B), kThreads, 0, stream>>>(a);
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
// contiguous; s: [B, H, NC - 1, N, N] f32 and dec: [B, H, NC - 1, N] f32
// scratch, NC = ceil(T / C) (unused, and may be null, when NC = 1).
// Dtype codes 0 = float32, 1 = bfloat16: one for r/k/v, one for w, one
// for u.  N is 8, 16, 32, 64 or 128.  Returns a cudaError_t (0 on
// success).
extern "C" int repro_wkv6(int cx, int cw, int cu, const void* r,
                          const void* k, const void* v, const void* w,
                          const void* u, float* y, float* s, float* dec,
                          int64_t r_sb, int64_t r_st, int64_t r_sh,
                          int64_t k_sb, int64_t k_st, int64_t k_sh,
                          int64_t v_sb, int64_t v_st, int64_t v_sh,
                          int64_t w_sb, int64_t w_st, int64_t w_sh, int B,
                          int T, int H, int N, int C, void* stream) {
  if ((cx | cw | cu) & ~1) return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1 || H < 1 || H > 65535 || B > 65535 || C < 1)
    return (int)cudaErrorInvalidValue;
  const int NC = (T + C - 1) / C;
  if (NC > 1 && (s == nullptr || dec == nullptr))
    return (int)cudaErrorInvalidValue;
  Wkv6Args a{r, k, v, w, u, y, s, dec,
             {r_sb, r_st, r_sh}, {k_sb, k_st, k_sh},
             {v_sb, v_st, v_sh}, {w_sb, w_st, w_sh},
             T, H, C, NC, cu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cx == 0 && cw == 0) return by_head_size<float, float>(a, B, N, st);
  if (cx == 0) return by_head_size<float, __nv_bfloat16>(a, B, N, st);
  if (cw == 0) return by_head_size<__nv_bfloat16, float>(a, B, N, st);
  return by_head_size<__nv_bfloat16, __nv_bfloat16>(a, B, N, st);
}
