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
// per clock per SM, one warp's ex2 every 8 clocks on each of the four
// sub-partitions), about 0.5 ms at 132 SMs and the card's top SM clock.
// So the exps bound it, and only while each update issues no more than
// about 8 instructions: the design keeps the per-update work to the five
// that the recurrence needs.
//
// Design.  A CTA owns CH = 32 * C consecutive channels of one batch row
// and runs W * C consumer warps, one producer warp and one epilogue
// warp.  Consumer warp (g, w) holds, in registers, states [w * SW,
// (w + 1) * SW) (SW = S / W) of channel 32 g + lane: one channel a lane,
// the states split over warps, so every lane of a warp reads the same
// B_t and C_t (shared-memory broadcasts), x_t and dt_t reads run along
// channels, and no shuffle is left in a step.  Per update: FMUL (dt *
// A log2 e), one ex2.approx.ftz.f32 (MUFU.EX2 alone; a result below
// 2^-126 flushes to 0), FMUL (dt x * B_s), FFMA (h), FFMA (y partial).
//
// The producer warp fills a ring of `stages` shared-memory stages, each
// KT steps: xc and dt tiles [KT][CH] as they are stored (TMA boxes of a
// 3-D tensor map where the base and the (b, t) strides are 16-byte
// aligned, the edges zero-filled; else plain loads by the producer's
// lanes), and B and C tiles [KT][S] widened to f32 by its lanes (16-byte
// loads where the rows allow: every CTA of a batch row reads the same B
// and C, and element loads of them held the kernel to the L2's pace).
// Steps past T and channels past Di are zeros (dt 0: the state stands
// still).  A stage's full mbarrier completes on the producer's one
// arrival (after all its lanes' stores) and the tiles' bytes; its empty
// mbarrier on the epilogue's arrival, once y of the tile has left.
//
// y is summed once per tile, by an epilogue warp.  Each consumer warp
// writes its partial y of each (step, channel) of the tile, its states
// added in ascending order (h_0 C_0, then + h_s C_s by FFMA), to one of
// two [W][KT][CH] f32 buffers and arrives on the buffer's ready mbarrier.
// The epilogue warp waits for the W * C arrivals, takes 4 adjacent
// channels a lane and adds, in this order and rounded at each add, the
// partials of w = 0, 1, ..., W - 1, then D * x (an f32 product rounded on
// its own); y leaves as 16-byte stores where Di is a multiple of 4.  It
// then frees the buffer (the consumers wait for that two tiles later) and
// the stage.  So the consumers never stop at a barrier for y.  The CPU
// twin (kernels/mamba_scan/tiles.py) follows the same order.
//
// The wrapper's plan (kernels/mamba_scan/kernel.py, scan_plan) picks W,
// C and KT, and repro_mamba_scan_fit below the stages, from this file's
// layout; the TPU kernel's block_t tiling is not carried over: any T >= 1
// runs.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kSmemMax = 227 * 1024;   // dynamic shared memory a CTA may use
// full[kMaxStages], empty[kMaxStages], ready[2], freed[2]
constexpr int kBarBytes = 256;

// Elements as stored: f32, or bf16 bits (widened by a shift: lo16 for
// the bits in the low half of a word, hi16 for the high half).
template <typename T> struct Raw { using type = float; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };

__device__ __forceinline__ float lo16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi16(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) { return lo16(v); }

// 4 adjacent stored elements (16- or 8-byte aligned) widened to f32.
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const unsigned short* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo16(v.x), hi16(v.x), lo16(v.y), hi16(v.y));
}

// 16 loaded bytes (8 bf16 or 4 f32, the pointer's type says which)
// widened to f32 and stored at out (16-byte aligned).
__device__ __forceinline__ void widen16(uint4 v, unsigned short*, float* out) {
  reinterpret_cast<float4*>(out)[0] =
      make_float4(lo16(v.x), hi16(v.x), lo16(v.y), hi16(v.y));
  reinterpret_cast<float4*>(out)[1] =
      make_float4(lo16(v.z), hi16(v.z), lo16(v.w), hi16(v.w));
}
__device__ __forceinline__ void widen16(uint4 v, float*, float* out) {
  *reinterpret_cast<float4*>(out) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                  __uint_as_float(v.z), __uint_as_float(v.w));
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Declare the bytes a phase's bulk copies will complete, without an
// arrival (the producer's lanes arrive once their own stores are done).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One box of a 3-D tensor map (channels, steps, rows) into shared
// memory; completion counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

struct ScanArgs {
  CUtensorMap mx, md;                  // xc / dt boxes, where tma says so
  const void* x;
  const void* dt;
  const void* b;
  const void* c;
  const float* A;
  const float* D;
  float* y;
  int64_t sx[2], sd[2], sb[2], sc[2];  // strides over (b, t), elements
  int T, Di, stages, tma;              // tma: bit 0 xc, bit 1 dt
  int bc_vec;                          // B, C rows allow 16-byte loads
};

// The shared-memory layout: barriers, the partials buffer, the ring.
template <int S, int W, int C, int KT, typename TX, typename TD>
struct Layout {
  using RX = typename Raw<TX>::type;
  using RD = typename Raw<TD>::type;
  static constexpr int CH = 32 * C;                       // channels
  static constexpr int THREADS = 32 * (W * C + 2);
  static constexpr size_t YBUF = 2ull * W * KT * CH * 4;
  static constexpr size_t XB = (size_t)KT * CH * sizeof(RX);
  static constexpr size_t DB = (size_t)KT * CH * sizeof(RD);
  static constexpr size_t BB = (size_t)KT * S * 4;
  static constexpr size_t STAGE = XB + DB + 2 * BB;
  static_assert(XB % 128 == 0 && DB % 128 == 0 && BB % 128 == 0,
                "tiles start 128-byte aligned");
  static constexpr size_t bytes(int stages) {
    return kBarBytes + YBUF + (size_t)stages * STAGE;
  }
};

template <int S, int W, int C, int KT, typename TX, typename TD>
__global__ void __launch_bounds__(Layout<S, W, C, KT, TX, TD>::THREADS)
    mamba_scan_kernel(const __grid_constant__ ScanArgs a) {
  using L = Layout<S, W, C, KT, TX, TD>;
  using RX = typename L::RX;
  using RD = typename L::RD;
  constexpr int SW = S / W;                       // states per thread
  constexpr int CH = L::CH;
  constexpr int G = 16 / SW;                      // steps computed together
  constexpr int RP = 32 / (CH / 4);               // the epilogue's rows a pass
  static_assert(SW * W == S && SW % 4 == 0, "states per thread: 4 or 8");
  static_assert(G >= 1 && KT % (2 * G) == 0, "the tile's groups");
  static_assert(RP >= 1 && KT % RP == 0, "the epilogue's rows");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ybuf = reinterpret_cast<float*>(smem + kBarBytes);
  unsigned char* ring = smem + kBarBytes + L::YBUF;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int stages = a.stages;
  const int T = a.T, Di = a.Di;
  const int d0 = blockIdx.x * CH;
  const int64_t row = blockIdx.y;
  const int nt = (T + KT - 1) / KT;
  auto full = [&](int s) { return smem_addr(&bars[s]); };
  auto empty = [&](int s) { return smem_addr(&bars[kMaxStages + s]); };
  // partials buffer b: written (ready) and read by the epilogue (freed)
  auto ready = [&](int b) { return smem_addr(&bars[2 * kMaxStages + b]); };
  auto freed = [&](int b) { return smem_addr(&bars[2 * kMaxStages + 2 + b]); };
  auto xs_of = [&](int s) {
    return reinterpret_cast<RX*>(ring + (size_t)s * L::STAGE);
  };
  auto ds_of = [&](int s) {
    return reinterpret_cast<RD*>(ring + (size_t)s * L::STAGE + L::XB);
  };
  auto bs_of = [&](int s) {
    return reinterpret_cast<float*>(ring + (size_t)s * L::STAGE + L::XB +
                                    L::DB);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);                      // the producer
      mbar_init(empty(s), 1);                     // the epilogue
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(ready(b), W * C);                 // the consumer warps
      mbar_init(freed(b), 1);                     // the epilogue
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == W * C) {
    // ---- the producer warp ----
    const RX* xp = static_cast<const RX*>(a.x) + row * a.sx[0];
    const RD* dp = static_cast<const RD*>(a.dt) + row * a.sd[0];
    const RX* bp = static_cast<const RX*>(a.b) + row * a.sb[0];
    const RX* cp = static_cast<const RX*>(a.c) + row * a.sc[0];
    const uint32_t tx_bytes = ((a.tma & 1) ? (uint32_t)L::XB : 0u) +
                              ((a.tma & 2) ? (uint32_t)L::DB : 0u);
    // B and C of a tile, widened into the stage: 16-byte loads where the
    // rows allow it (bc_vec), else element loads; all loads first
    auto tile_bc = [&](int t0, float* bs) {
      constexpr int V = 16 / sizeof(RX);          // elements a 16-byte load
      if constexpr (S % V == 0) {
        if (a.bc_vec) {
          constexpr int NV = KT * S / V, PER = (NV + 31) / 32;
          uint4 vb[PER], vc[PER];
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int q = lane + 32 * j;
            const int64_t t = t0 + q / (S / V);
            const int s0 = q % (S / V) * V;
            const bool ok = q < NV && t < T;
            vb[j] = ok ? *reinterpret_cast<const uint4*>(bp + t * a.sb[1] + s0)
                       : make_uint4(0, 0, 0, 0);
            vc[j] = ok ? *reinterpret_cast<const uint4*>(cp + t * a.sc[1] + s0)
                       : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            const int q = lane + 32 * j;
            if (q < NV) {
              widen16(vb[j], static_cast<RX*>(nullptr), bs + q * V);
              widen16(vc[j], static_cast<RX*>(nullptr), bs + KT * S + q * V);
            }
          }
          return;
        }
      }
      constexpr int BPL = (KT * S + 31) / 32;     // B/C values per lane
      float bv[BPL], cv[BPL];
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        const int e = lane + 32 * j;
        const int64_t t = t0 + e / S;
        const bool ok = e < KT * S && t < T;
        bv[j] = ok ? widen(bp[t * a.sb[1] + e % S]) : 0.f;
        cv[j] = ok ? widen(cp[t * a.sc[1] + e % S]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        const int e = lane + 32 * j;
        if (e < KT * S) {
          bs[e] = bv[j];
          bs[KT * S + e] = cv[j];
        }
      }
    };
    // xc or dt without a tensor map: plain loads, 8 a lane in flight,
    // zeros off the edges
    auto plain_tile = [&](auto* dst, const auto* src, int64_t st, int t0) {
      using RT = typename std::remove_reference<decltype(*dst)>::type;
      for (int e0 = 0; e0 < KT * CH; e0 += 32 * 8) {
        RT v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + lane + 32 * u;
          const int64_t t = t0 + e / CH;
          const int d = d0 + e % CH;
          v[u] = (e < KT * CH && t < T && d < Di) ? src[t * st + d] : RT(0);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (e0 + lane + 32 * u < KT * CH) dst[e0 + lane + 32 * u] = v[u];
      }
    };
    int s = 0, k = 0;                             // stage, its fill count
    for (int i = 0; i < nt; ++i) {
      const int t0 = i * KT;
      if (k > 0) mbar_wait(empty(s), (k - 1) & 1);
      if (lane == 0 && tx_bytes) {
        mbar_expect_tx(full(s), tx_bytes);
        if (a.tma & 1)
          tma_load3(smem_addr(xs_of(s)), &a.mx, d0, t0, (int)row, full(s));
        if (a.tma & 2)
          tma_load3(smem_addr(ds_of(s)), &a.md, d0, t0, (int)row, full(s));
      }
      tile_bc(t0, bs_of(s));
      if (!(a.tma & 1)) plain_tile(xs_of(s), xp, a.sx[1], t0);
      if (!(a.tma & 2)) plain_tile(ds_of(s), dp, a.sd[1], t0);
      // one arrival for the warp, after every lane's stores (a fence here
      // would also wait for lane 0's bulk copies)
      __syncwarp();
      if (lane == 0) mbar_arrive(full(s));
      if (++s == stages) { s = 0; ++k; }
    }
    return;
  }

  if (warp == W * C + 1) {
    // ---- the epilogue warp: y of a tile, once its partials are in ----
    // lane: quad q (4 adjacent channels) of rows r, r + RP, ...; each y
    // the W partials added in w order, then D x
    const int q = lane % (CH / 4), r = lane / (CH / 4);
    const int dq = d0 + 4 * q;
    float Dq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) Dq[j] = dq + j < Di ? a.D[dq + j] : 0.f;
    const bool vec_store = (Di % 4) == 0;
    float* yrow = a.y + row * (int64_t)T * Di;
    int s = 0;
    for (int i = 0; i < nt; ++i) {
      const int t0 = i * KT, bb = i & 1;
      mbar_wait(ready(bb), (i >> 1) & 1);
      const float* yb = ybuf + (size_t)bb * W * KT * CH;
      const RX* xs = xs_of(s);
#pragma unroll 4
      for (int t = r; t < KT; t += RP) {
        const int64_t tt = t0 + t;
        if (tt < T) {
          float4 acc = *reinterpret_cast<const float4*>(yb + t * CH + 4 * q);
#pragma unroll
          for (int v = 1; v < W; ++v) {
            const float4 p = *reinterpret_cast<const float4*>(
                yb + ((size_t)v * KT + t) * CH + 4 * q);
            acc.x = __fadd_rn(acc.x, p.x);
            acc.y = __fadd_rn(acc.y, p.y);
            acc.z = __fadd_rn(acc.z, p.z);
            acc.w = __fadd_rn(acc.w, p.w);
          }
          const float4 x4 = widen4(xs + t * CH + 4 * q);
          acc.x = __fadd_rn(acc.x, __fmul_rn(Dq[0], x4.x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(Dq[1], x4.y));
          acc.z = __fadd_rn(acc.z, __fmul_rn(Dq[2], x4.z));
          acc.w = __fadd_rn(acc.w, __fmul_rn(Dq[3], x4.w));
          float* yo = yrow + tt * Di + dq;
          if (vec_store && dq + 3 < Di) {
            *reinterpret_cast<float4*>(yo) = acc;
          } else {
            const float o[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (dq + j < Di) yo[j] = o[j];
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(freed(bb));
        mbar_arrive(empty(s));
      }
      if (++s == stages) s = 0;
    }
    return;
  }

  // ---- the consumer warps ----
  const int g = warp / W, w = warp % W;
  const int ch = 32 * g + lane;                   // this lane's channel
  const int d = d0 + ch;
  constexpr float kLog2e = 1.4426950408889634f;
  float h[SW], A2[SW];
#pragma unroll
  for (int j = 0; j < SW; ++j) {
    h[j] = 0.f;
    A2[j] = d < Di ? a.A[(int64_t)d * S + w * SW + j] * kLog2e : 0.f;
  }
  int s = 0, k = 0;
  for (int i = 0; i < nt; ++i) {
    const int bb = i & 1;
    mbar_wait(full(s), k & 1);
    // partials buffer bb last held tile i - 2: the epilogue has read it
    if (i >= 2) mbar_wait(freed(bb), ((i >> 1) - 1) & 1);
    const RX* xs = xs_of(s) + ch;
    const RD* ds = ds_of(s) + ch;
    const float* bs = bs_of(s) + w * SW;
    const float* cs = bs + KT * S;
    float* ymine = ybuf + ((size_t)bb * W + w) * KT * CH + ch;
    // G steps at a time, software-pipelined by one group: group n + 1's
    // x and dt are read and its exps (independent of h) issued before
    // group n's state updates and partials, so that the special-function
    // units hold queued work while the warp waits on its multiply-adds,
    // and a warp waits on one latency per G steps, not per operation.
    // The loop over pairs of groups is not unrolled: the tile's code
    // stays small enough for the instruction caches
    constexpr int NG = KT / G;
    float dv0[G], xv0[G], e0[G][SW], dv1[G], xv1[G], e1[G][SW];
    auto fetch = [&](int n, float (&dv)[G], float (&xv)[G],
                     float (&e)[G][SW]) {
#pragma unroll
      for (int u = 0; u < G; ++u) {
        dv[u] = widen(ds[(n * G + u) * CH]);
        xv[u] = widen(xs[(n * G + u) * CH]);
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
#pragma unroll
        for (int j = 0; j < SW; ++j) e[u][j] = ex2_ftz(dv[u] * A2[j]);
    };
    auto update = [&](int n, const float (&dv)[G], const float (&xv)[G],
                      const float (&e)[G][SW]) {
      float yp[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const int t = n * G + u;
        float bt[SW], ct[SW];
#pragma unroll
        for (int j = 0; j < SW; j += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(bs + t * S + j);
          const float4 c4 = *reinterpret_cast<const float4*>(cs + t * S + j);
          bt[j] = b4.x; bt[j + 1] = b4.y; bt[j + 2] = b4.z; bt[j + 3] = b4.w;
          ct[j] = c4.x; ct[j + 1] = c4.y; ct[j + 2] = c4.z; ct[j + 3] = c4.w;
        }
        const float dx = dv[u] * xv[u];
#pragma unroll
        for (int j = 0; j < SW; ++j)
          h[j] = fmaf(e[u][j], h[j], dx * bt[j]);
        yp[u] = h[0] * ct[0];
#pragma unroll
        for (int j = 1; j < SW; ++j) yp[u] = fmaf(h[j], ct[j], yp[u]);
      }
#pragma unroll
      for (int u = 0; u < G; ++u) ymine[(n * G + u) * CH] = yp[u];
    };
    fetch(0, dv0, xv0, e0);
#pragma unroll 1
    for (int n = 0; n < NG; n += 2) {
      fetch(n + 1, dv1, xv1, e1);
      update(n, dv0, xv0, e0);
      if (n + 2 < NG) fetch(n + 2, dv0, xv0, e0);
      update(n + 1, dv1, xv1, e1);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ready(bb));
    if (++s == stages) { s = 0; ++k; }
  }
}

// ---- host side --------------------------------------------------------

template <typename T> constexpr CUtensorMapDataType kMapType =
    CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
template <> constexpr CUtensorMapDataType kMapType<__nv_bfloat16> =
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// [B, T, Di] with the given (b, t) element strides as a 3-D tensor map
// (Di, T, B), boxes of (32 C channels, KT steps, 1 row), zeros off the
// edges; the stride of a single row is never used (and may be any).
template <typename T>
int encode_btd(CUtensorMap* map, const void* base, int B, int Tn, int Di,
               int64_t sb, int64_t st, int channels, int steps) {
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)Di, (cuuint64_t)Tn,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {
      (cuuint64_t)(st * sizeof(T)),
      (cuuint64_t)(B > 1 ? sb * sizeof(T) : (uint64_t)Tn * st * sizeof(T))};
  const cuuint32_t box[3] = {(cuuint32_t)channels, (cuuint32_t)steps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, kMapType<T>, 3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int S, int W, int C, int KT, typename TX, typename TD>
int launch(ScanArgs& a, int B, cudaStream_t stream, int* occupancy) {
  using L = Layout<S, W, C, KT, TX, TD>;
  auto kern = mamba_scan_kernel<S, W, C, KT, TX, TD>;
  const size_t smem = L::bytes(a.stages);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // per device, the shared memory this kernel was allowed so far; the
  // carveout set to the most shared memory, so that occupancy is not
  // held to a default split with L1
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (allowed[dev] < smem) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  if (occupancy)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kern, L::THREADS, smem);
  if (a.tma & 1) {
    const int rc = encode_btd<TX>(&a.mx, a.x, B, a.T, a.Di, a.sx[0],
                                  a.sx[1], L::CH, KT);
    if (rc) return rc;
  }
  if (a.tma & 2) {
    const int rc = encode_btd<TD>(&a.md, a.dt, B, a.T, a.Di, a.sd[0],
                                  a.sd[1], L::CH, KT);
    if (rc) return rc;
  }
  dim3 grid((a.Di + L::CH - 1) / L::CH, B);
  kern<<<grid, L::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The plans the wrapper's scan_plan gives: W = S / 4, one or two groups
// of 32 channels, 32 steps a tile.
template <typename TX, typename TD>
int by_plan(ScanArgs& a, int B, int S, int W, int C, int KT,
            cudaStream_t st, int* occupancy = nullptr) {
#define REPRO_SCAN_PLAN(s_, w_, c_, kt_)                                   \
  if (S == s_ && W == w_ && C == c_ && KT == kt_)                          \
    return launch<s_, w_, c_, kt_, TX, TD>(a, B, st, occupancy);
  REPRO_SCAN_PLAN(4, 1, 1, 32)
  REPRO_SCAN_PLAN(4, 1, 2, 32)
  REPRO_SCAN_PLAN(8, 2, 1, 32)
  REPRO_SCAN_PLAN(8, 2, 2, 32)
  REPRO_SCAN_PLAN(16, 4, 1, 32)
  REPRO_SCAN_PLAN(16, 4, 2, 32)
#undef REPRO_SCAN_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xc, dt: [B, T, Di]; Bm, Cm: [B, T, S]; each with the given (b, t)
// strides and a contiguous last dim.  A: [Di, S] and D: [Di], f32,
// contiguous; y: [B, T, Di] f32, contiguous.  Dtype codes 0 = float32,
// 1 = bfloat16: one for xc (and B and C), one for dt.  The plan: W
// state-warps per 32 channels, C groups of 32 channels per CTA, KT
// steps a tile, `stages` tiles in the ring (2..8); `tma` bit 0 / 1 reads
// xc / dt with TMA boxes (the caller has checked the 16-byte alignment
// of the base and strides), else with plain loads.  Returns a
// cudaError_t (0 on success).
extern "C" int repro_mamba_scan(int cx, int cd, const void* xc,
                                const void* dt, const void* Bm,
                                const void* Cm, const float* A,
                                const float* D, float* y, int64_t x_sb,
                                int64_t x_st, int64_t d_sb, int64_t d_st,
                                int64_t b_sb, int64_t b_st, int64_t c_sb,
                                int64_t c_st, int B, int T, int Di, int S,
                                int W, int C, int KT, int stages, int tma,
                                void* stream) {
  if ((cx | cd) & ~1 || tma & ~3) return (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || T < 1 || Di < 1 || stages < 2 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  memset(&a, 0, sizeof(a));
  a.x = xc; a.dt = dt; a.b = Bm; a.c = Cm; a.A = A; a.D = D; a.y = y;
  a.sx[0] = x_sb; a.sx[1] = x_st; a.sd[0] = d_sb; a.sd[1] = d_st;
  a.sb[0] = b_sb; a.sb[1] = b_st; a.sc[0] = c_sb; a.sc[1] = c_st;
  a.T = T; a.Di = Di; a.stages = stages; a.tma = tma;
  const int eb = cx ? 2 : 4;                      // B and C element bytes
  auto rows16 = [&](const void* p, int64_t sb, int64_t st) {
    return (uintptr_t)p % 16 == 0 && (st * eb) % 16 == 0 &&
           (B == 1 || (sb * eb) % 16 == 0) && (S * eb) % 16 == 0;
  };
  a.bc_vec = rows16(Bm, b_sb, b_st) && rows16(Cm, c_sb, c_st);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cx) {
    return cd ? by_plan<__nv_bfloat16, __nv_bfloat16>(a, B, S, W, C, KT, st)
              : by_plan<__nv_bfloat16, float>(a, B, S, W, C, KT, st);
  }
  return cd ? by_plan<float, __nv_bfloat16>(a, B, S, W, C, KT, st)
            : by_plan<float, float>(a, B, S, W, C, KT, st);
}

// The ring for the plan on the current device: in *stages, the most
// stages, of 4, 3 and 2, at which the kernel keeps as many CTAs on an SM
// as it has with 2 (its registers, threads and the layout's shared
// memory decide, through the occupancy calculator), and that count in
// *ctas.  Returns a cudaError_t.  Codes as above.
extern "C" int repro_mamba_scan_fit(int cx, int cd, int S, int W, int C,
                                    int KT, int* stages, int* ctas) {
  if ((cx | cd) & ~1 || !stages || !ctas) return (int)cudaErrorInvalidValue;
  int at[5] = {};
  for (int s = 2; s <= 4; ++s) {
    ScanArgs a;
    memset(&a, 0, sizeof(a));
    a.stages = s;
    int rc;
    if (cx) {
      rc = cd ? by_plan<__nv_bfloat16, __nv_bfloat16>(a, 1, S, W, C, KT,
                                                      nullptr, &at[s])
              : by_plan<__nv_bfloat16, float>(a, 1, S, W, C, KT, nullptr,
                                              &at[s]);
    } else {
      rc = cd ? by_plan<float, __nv_bfloat16>(a, 1, S, W, C, KT, nullptr,
                                              &at[s])
              : by_plan<float, float>(a, 1, S, W, C, KT, nullptr, &at[s]);
    }
    // a ring past the CTA's shared memory is refused: fewer stages fit
    if (rc == (int)cudaErrorInvalidValue && s > 2) break;
    if (rc) return rc;
  }
  *stages = 2;
  for (int s = 4; s > 2; --s)
    if (at[s] > 0 && at[s] >= at[2]) { *stages = s; break; }
  *ctas = at[*stages];
  return at[2] > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}
