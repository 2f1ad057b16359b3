// The Mamba-1 selective scan.
//
// Replaces: src/repro/kernels/mamba_scan/kernel.py, _kernel (via
// selective_scan_bdt), the Pallas TPU kernel.
//
// What it computes, for each batch row b and channel d, from h = 0:
//   h[s] = exp(dt_t[d] * A[d, s]) * h[s] + dt_t[d] * x_t[d] * B_t[s]
//   y_t[d] = sum_s h[s] * C_t[s] + D[d] * x_t[d]
// in f32.  xc and dt ([B, T, Di]) and B and C ([B, T, S], in xc's
// dtype) are read through their (b, t) strides, the last dim contiguous,
// xc and dt each in its own dtype, f32 or bf16; A ([Di, S]) and D ([Di])
// are f32 and contiguous; y is written once, in f32, as [B, T, Di].
//
// Bound at one jamba-1.5-large layer's prefill (B 1, T 8192, Di 16384,
// S 16, bf16 xc/dt/B/C, f32 y): bytes, about 1.07 GB, 0.32 ms at 3.35
// TB/s; f32 operations, 2.15e9 (t, d, s) updates of about 6 each, 0.19
// ms at 67 TFLOP/s; the exps, 2.15e9 on the special-function units (16
// per clock per SM), about 0.5 ms at 132 SMs and the card's top SM clock.
// So the exps bound it, and beside them the T steps of a channel are
// serial.
//
// Design.  L threads (lanes) own one channel d of one batch row and keep
// its S states in registers, S / L each, so nothing of the [Di, S] state
// or the per-step temporaries leaves the SM; each lane sums its states'
// part of y_t and the L parts are added with warp shuffles.  The wrapper
// picks L (1, 2 or 4) so that B * Di * L is about 65536 threads: at B 1
// and Di 16384 one lane per channel gives 4 warps per SM, too few to hide
// the latency of a step, and L = 4 gives about 16; at B 4 one lane per
// channel was the fastest.  A CTA of 128 threads owns 128 / L
// consecutive channels of one row.  B_t and C_t are shared by every
// channel of the row: the CTA stages kChunk steps of them at a time in
// shared memory, widened to f32.  The next chunk's xc, dt,
// B and C are loaded into registers (raw, unconverted) before the
// current chunk is computed, so their latency hides behind it.  The exps
// go through exp2f on dt * (A log2 e): they do not depend on h, so they
// run ahead of the serial FMA chain, and a full chunk's steps are
// unrolled with no exit between them so that the compiler can overlap
// one step's exps with the last step's chain.  The TPU kernel's block_t
// tiling is not carried over: any T >= 1 runs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per CTA
constexpr int kChunk = 16;     // steps staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct ScanArgs {
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* A;
  const float* D;
  float* y;
  int64_t sx[2], sd[2], sb[2], sc[2];  // strides over (b, t), elements
  int T, Di;
};

template <int S, int L, typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const ScanArgs a) {
  constexpr int SL = S / L;                      // states per lane
  constexpr int CH = kThreads / L;               // channels per CTA
  constexpr int PER = (kChunk * S + kThreads - 1) / kThreads;  // B/C loads
  static_assert(SL * L == S && CH * L == kThreads && 32 % L == 0, "lanes");
  __shared__ float bs[kChunk][S];
  __shared__ float cs[kChunk][S];

  const int tid = threadIdx.x;
  const int j = tid % L;                         // lane within the channel
  const int d = blockIdx.x * CH + tid / L;
  const bool live = d < a.Di;
  const int64_t row = blockIdx.y;
  const TX* xp = static_cast<const TX*>(a.x) + row * a.sx[0] + d;
  const TD* dp = static_cast<const TD*>(a.dt) + row * a.sd[0] + d;
  const TX* bp = static_cast<const TX*>(a.b) + row * a.sb[0];
  const TX* cp = static_cast<const TX*>(a.c) + row * a.sc[0];
  float* yp = a.y + row * a.T * (int64_t)a.Di + d;

  // the next chunk, as loaded (converted when it becomes the current one)
  TX px[kChunk];
  TD pd[kChunk];
  TX pb[PER], pc[PER];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int64_t t = t0 + i;
      if (live && t < a.T) {
        px[i] = xp[t * a.sx[1]];
        pd[i] = dp[t * a.sd[1]];
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * kThreads;
      const int64_t t = t0 + e / S;
      if (e < kChunk * S && t < a.T) {
        pb[i] = bp[t * a.sb[1] + e % S];
        pc[i] = cp[t * a.sc[1] + e % S];
      }
    }
  };

  constexpr float kLog2e = 1.4426950408889634f;
  float h[SL], A2[SL];
  float Dd = 0.f;
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    h[s] = 0.f;
    A2[s] = live ? a.A[(int64_t)d * S + j * SL + s] * kLog2e : 0.f;
  }
  if (live) Dd = a.D[d];

  // one step: this lane's SL states, then the lanes' partial y summed
  auto step = [&](int t, float xv, float dv, const float* bt,
                  const float* ct) {
    const float dx = dv * xv;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const float dA = exp2f(dv * A2[s]);
      h[s] = fmaf(dA, h[s], dx * bt[j * SL + s]);
      if (s & 1) acc1 = fmaf(h[s], ct[j * SL + s], acc1);
      else acc0 = fmaf(h[s], ct[j * SL + s], acc0);
    }
    float acc = acc0 + acc1;
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && j == 0) yp[(int64_t)t * a.Di] = acc + Dd * xv;
  };

  fetch(0);
  for (int t0 = 0; t0 < a.T; t0 += kChunk) {
    const int len = min(kChunk, a.T - t0);
    __syncthreads();                           // the last chunk is read
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * kThreads;
      if (e < kChunk * S && e / S < len) {
        bs[e / S][e % S] = to_f32(pb[i]);
        cs[e / S][e % S] = to_f32(pc[i]);
      }
    }
    float x[kChunk], dtv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      x[i] = to_f32(px[i]);
      dtv[i] = to_f32(pd[i]);
    }
    __syncthreads();
    if (t0 + kChunk < a.T) fetch(t0 + kChunk);  // in flight meanwhile
    if (len == kChunk) {
      // a full chunk: no exit inside the unrolled steps, so the next
      // steps' exps are scheduled beside this step's FMA chain
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt)
        step(t0 + tt, x[tt], dtv[tt], bs[tt], cs[tt]);
    } else {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        if (tt >= len) break;
        step(t0 + tt, x[tt], dtv[tt], bs[tt], cs[tt]);
      }
    }
  }
}

template <int S, int L, typename TX, typename TD>
int launch(const ScanArgs& a, int B, cudaStream_t stream) {
  constexpr int CH = kThreads / L;
  dim3 grid((a.Di + CH - 1) / CH, B);
  mamba_scan_kernel<S, L, TX, TD><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S, typename TX, typename TD>
int by_lanes(const ScanArgs& a, int B, int lanes, cudaStream_t st) {
  switch (lanes) {
    case 1: return launch<S, 1, TX, TD>(a, B, st);
    case 2: return launch<S, 2, TX, TD>(a, B, st);
    case 4: return launch<S, 4, TX, TD>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX, typename TD>
int by_state(const ScanArgs& a, int B, int S, int lanes, cudaStream_t st) {
  switch (S) {
    case 4: return by_lanes<4, TX, TD>(a, B, lanes, st);
    case 8: return by_lanes<8, TX, TD>(a, B, lanes, st);
    case 16: return by_lanes<16, TX, TD>(a, B, lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX>
int by_dt(const ScanArgs& a, int cd, int B, int S, int lanes,
          cudaStream_t st) {
  return cd ? by_state<TX, __nv_bfloat16>(a, B, S, lanes, st)
            : by_state<TX, float>(a, B, S, lanes, st);
}

}  // namespace

// xc, dt: [B, T, Di]; Bm, Cm: [B, T, S]; each with the given (b, t)
// strides and a contiguous last dim.  A: [Di, S] and D: [Di], f32,
// contiguous; y: [B, T, Di] f32, contiguous.  Dtype codes 0 = float32,
// 1 = bfloat16: one for xc (and B and C), one for dt.  S is 4, 8 or
// 16; lanes (threads per channel) is 1, 2 or 4.  Returns a cudaError_t
// (0 on success).
extern "C" int repro_mamba_scan(int cx, int cd, const void* xc,
                                const void* dt, const void* Bm,
                                const void* Cm, const float* A,
                                const float* D, float* y, int64_t x_sb,
                                int64_t x_st, int64_t d_sb, int64_t d_st,
                                int64_t b_sb, int64_t b_st, int64_t c_sb,
                                int64_t c_st, int B, int T, int Di, int S,
                                int lanes, void* stream) {
  if ((cx | cd) & ~1) return (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || T < 1 || Di < 1)
    return (int)cudaErrorInvalidValue;
  ScanArgs a{xc, dt, Bm, Cm, A, D, y,
             {x_sb, x_st}, {d_sb, d_st}, {b_sb, b_st}, {c_sb, c_st},
             T, Di};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cx ? by_dt<__nv_bfloat16>(a, cd, B, S, lanes, st)
            : by_dt<float>(a, cd, B, S, lanes, st);
}
