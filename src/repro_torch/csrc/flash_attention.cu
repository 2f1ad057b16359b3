// Flash attention forward (online softmax), with an optional q-row
// gather prologue.
//
// Replaces: src/repro/kernels/attention/kernel.py, _kernel (via
// flash_attention_bhsd) and _kernel_gather (its q_rows= path), the
// Pallas TPU kernels.  One template serves both; GATHER adds the
// prologue.
//
// What it computes, per (batch b, query head h, query row t), with
// kv head h / group (GQA), key positions counted from 0 and query row t
// at position i = q_start + t (q_start 0 but for a block of a longer
// query sequence, e.g. a model rank's rows of a sequence cut over ranks):
//   s[t, u] = cap * tanh(((q[t] * scale) . k[u]) / cap)   (no cap: plain)
//   s[t, u] = -1e30 where the mask drops u: causal u <= i, window
//             u > i - window
//   out[t]  = sum_u softmax(s[t])[u] * v[u]               (f32, one store)
// With GATHER, row t attends with q row q_rows[b, t] of the token-order
// q buffer; q_rows outside [0, Sq) (the dispatch's -1) gives an exact
// zero output row.  Masks use the output order t (its position i).
// Keys past Sk weigh 0.  A row with no live key at all (window set and
// i >= Sk + window - 1) weighs every key below Sk equally, as the
// reference does.
//
// Bound: operations for long sequences (4 * D per live (t, u) pair and
// head, on the bf16 tensor cores at 989 TFLOP/s), bytes (q, k, v read
// once, out written once) for short ones.
//
// Two bodies share the masks and the online softmax:
//   - flash_attention_wgmma_kernel (bf16, D a multiple of 8 up to 256,
//     padded to 64/128/256 with zeros; every row start and base 16-byte
//     aligned, every stride of an extent above 1 positive): the Hopper
//     body below.  No shape that these admit goes elsewhere.
//   - flash_attention_kernel (f32, and bf16 the first cannot take: D
//     not a multiple of 8, rows off 16-byte alignment, zero strides):
//     the products on the CUDA cores in f32.  q, k, v tiles in f32 in
//     shared memory (rows padded by one word so column walks hit
//     distinct banks), the [64, 64] score tile there too, 8 rows x D/32
//     output columns per thread, one CTA per (q tile of 64 rows, q
//     head, batch), longest causal tiles first.
// Either body chooses by the same explicit test (wgmma_fits), never by
// a failed launch.
//
// The Hopper body (sm_90a), one CTA per (q head, q tile of 128 rows,
// batch), against what held the first tensor-core body back:
//   1. Loads overlap products.  The CTA is warp-specialised: warpgroup
//      0 is the producer (setmaxnreg down to 40), and one of its
//      threads issues every copy: q once, then k and v tiles through
//      TMA (4-D tensor maps (D, S, heads, B) with the caller's strides,
//      boxes of 64 columns = 128 bytes, 128-byte swizzle; out-of-bounds
//      rows and the padded head dim arrive as zeros) into a ring of NST
//      stages.  Each stage has a full and an empty mbarrier for k and
//      for v apart, so Q K^T of a tile starts before its v lands.
//   2. wgmma, not mma.sync.  Warpgroups 1 and 2 (setmaxnreg up to 232)
//      own 64 query rows each: S = Q K^T is an SS wgmma m64nBKk16 with
//      both operands read from the swizzled tiles through descriptors;
//      O += P V an RS wgmma m64nDPk16 whose A operand is P, rounded to
//      bf16 in registers (the S accumulator's layout is the A
//      fragment's), and whose B is v through the descriptor's transpose
//      bit.  q stays in shared memory for the whole CTA.
//   3. Larger CTAs.  BQ = 128; BK = 128 at D <= 128 and 64 at D = 256;
//      4, 3 and 2 stages at D = 64, 128, 256 (q 64 KB + 2 x (k 32 KB +
//      v 32 KB) at D = 256), within the 227 KB of one SM.  The
//      consumers' 232 registers hold o (DP / 2 f32), the score tile
//      (BK / 2) and the last tile's P (BK / 4) without spilling.
//   4. Masks only on edge tiles.  kv_range() gives each q tile its
//      visited kv tiles and, among them, the interior ones, whose every
//      score is live: those take no compare at all.  Skipped tiles hold
//      only masked scores, whose weight exp(-1e30 - m) is exactly 0
//      once a row has seen a live key; a q tile that holds a row with
//      no live key visits every kv tile.  The tiles run from the last
//      down: the first (the diagonal, or the ragged end) always takes
//      the masks, then one loop each over the edge tiles above the
//      interior ones, the interior ones and the edge tiles below, with
//      the masks (and the softcap) fixed at compile time, so that no
//      wgmma operand is touched on a divergent path.
//   5. L2 reuse.  Grid x is the q head, so neighbouring CTAs share a q
//      tile and, within a GQA group, a kv head; grid y runs the longest
//      causal tiles first.  (Each CTA still reads its kv prefix from
//      L2; a 2-CTA cluster multicasting each tile is the next step if
//      L2 sets the pace.)
//   6. The exps off the critical path.  exp2 on ex2.approx with scale *
//      log2 e folded into one multiply; the softcap as cap tanh(x scale
//      / cap) with tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1), also on
//      ex2.approx.  The two consumer warpgroups take turns on the
//      tensor cores (named barriers 1 and 2), so one's softmax runs
//      under the other's wgmmas; within a warpgroup the P V product of
//      tile j - 1 is issued after tile j's Q K^T and runs under tile
//      j's softmax.
// GATHER: TMA has no row gather, so each consumer warpgroup loads its
// 64 gathered q rows with 16-byte cp.async into the swizzled layout
// (zero-filled for dead rows and the padded head dim), and stores dead
// rows as zeros.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

// the CUDA-core body's tiles
constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr int kSmemMax = 232448;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_rows;           // [B, Sq] int32 (GATHER only)
  void* out;                   // [B, Sq, H, D] contiguous
  int64_t sqb, sqs, sqh;       // element strides of q over b, s, h
  int64_t skb, sks, skh;       // ... of k
  int64_t svb, svs, svh;       // ... of v
  int Sq, Sk, H, group, D;
  float scale, cap;            // cap <= 0: no softcap
  int causal, has_window, window;
  int q_start;                 // position of query row 0
};

size_t smem_bytes(int D) {
  const size_t floats = (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                        (size_t)BK * D + (size_t)BQ * (BK + 1) + 3 * BQ;
  return floats * sizeof(float);
}

template <typename T, int KD, bool GATHER>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;                       // padded row stride
  float* qs = smem;                           // [BQ][ld]  q * scale
  float* ks = qs + BQ * ld;                   // [BK][ld]
  float* vs = ks + BK * ld;                   // [BK][D]
  float* ss = vs + BK * D;                    // [BQ][BK+1] scores, then p
  float* alpha_s = ss + BQ * (BK + 1);        // [BQ]
  float* l_s = alpha_s + BQ;                  // [BQ]
  int* rows_s = reinterpret_cast<int*>(l_s + BQ);   // [BQ]

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.group;
  const int tid = threadIdx.x;
  const T* qg = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kg = static_cast<const T*>(p.k) + b * p.skb + kh * p.skh;
  const T* vg = static_cast<const T*>(p.v) + b * p.svb + kh * p.svh;

  // ---- prologue: the q tile (gathered rows with GATHER), scaled ----
  if (GATHER) {
    for (int r = tid; r < BQ; r += THREADS) {
      const int t = q0 + r;
      int src = t < p.Sq ? p.q_rows[(int64_t)b * p.Sq + t] : -1;
      rows_s[r] = (src >= 0 && src < p.Sq) ? src : -1;
    }
    __syncthreads();
  }
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    const int src = GATHER ? rows_s[r] : (q0 + r < p.Sq ? q0 + r : -1);
    qs[r * ld + c] = src >= 0 ? to_f32(qg[src * p.sqs + c]) * p.scale : 0.f;
  }

  // ---- the kv tiles some row of this q tile can see (by position) ----
  const int i0 = p.q_start + q0;
  const int i_last = p.q_start + min(q0 + BQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Sk;
  const bool dead_row = p.has_window &&
      (p.window < 1 || i_last >= p.Sk + p.window - 1);
  if (!dead_row) {
    if (p.causal) k_hi = min(k_hi, i_last + 1);
    if (p.has_window) k_lo = max(0, i0 - p.window + 1);
  }
  const int j_lo = k_lo / BK, j_hi = (k_hi + BK - 1) / BK;

  const int tx = tid & 15, ty = tid >> 4;     // score tile: 4 rows x 4 cols
  const int sr = tid >> 2, sq = tid & 3;      // softmax: row sr, quarter sq
  const int warp = tid >> 5, lane = tid & 31; // output: 8 rows x KD cols
  float m_run = NEG_INF, l_run = 0.f;
  float acc[8][KD];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < KD; ++c) acc[i][c] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                          // last tile's readers done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      const int u = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (u < p.Sk) {
        kx = to_f32(kg[u * p.sks + c]);
        vx = to_f32(vg[u * p.svs + c]);
      }
      ks[r * ld + c] = kx;
      vs[r * D + c] = vx;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bb[jj] = ks[(tx + 16 * jj) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], bb[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = ty + 16 * i, c = tx + 16 * jj;
        const int t = p.q_start + q0 + r, u = k0 + c;
        float x = s[i][jj];
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        bool live = true;
        if (p.causal) live = live && u <= t;
        if (p.has_window) live = live && u > t - p.window;
        x = live ? x : NEG_INF;
        if (u >= p.Sk) x = -INFINITY;         // ragged edge: weight 0
        ss[r * (BK + 1) + c] = x;
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row
    {
      float* row = ss + sr * (BK + 1);
      float mx = -INFINITY;
      for (int c = sq; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = sq; c < BK; c += 4) {
        const float pc = expf(row[c] - m_new);
        row[c] = pc;
        sum += pc;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      if (sq == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = alpha_s[warp * 8 + i];
#pragma unroll
      for (int c = 0; c < KD; ++c) acc[i][c] *= a;
    }
    for (int u = 0; u < BK; ++u) {
      float vv[KD];
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vs[u * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pu = ss[(warp * 8 + i) * (BK + 1) + u];
#pragma unroll
        for (int c = 0; c < KD; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
      }
    }
  }

  // ---- flush: acc / l (a row that saw no key at all keeps 0) ----
  if (sq == 0) l_s[sr] = l_run;
  __syncthreads();
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i, t = q0 + r;
    if (t >= p.Sq) continue;
    const bool live = !GATHER || rows_s[r] >= 0;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;
    T* orow = og + (((int64_t)b * p.Sq + t) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f32<T>(live ? acc[i][c] / denom : 0.f);
    }
  }
}

// ---- the Hopper body (bf16) ----

constexpr int WQ = 128;                 // query rows per CTA, 64 per consumer
constexpr int WTHREADS = 384;           // producer + 2 consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int DP> struct Tiles {
  static constexpr int BK = DP == 256 ? 64 : 128;           // keys per tile
  static constexpr int NST = DP == 64 ? 4 : DP == 128 ? 3 : 2;   // stages
  static constexpr int CB = DP / 64;                        // 128-B boxes
  static constexpr uint32_t Q_BYTES = WQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;         // one k or v
  static constexpr int NBAR = 1 + 4 * NST;
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's period
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * NST * KV_BYTES
                                 + NBAR * 8;
};

// The kv tiles a q tile [q0, q0 + bq) visits, [j_lo, j_hi), and among
// them the interior ones, [i_lo, i_hi), whose every score is live; its
// rows sit at positions q_start + q0 ...
// tile_classes() in kernels/attention/kernel.py mirrors this line for
// line, and tests/test_torch_attention_tiles.py holds it against a
// brute-force mask.
struct KvRange { int j_lo, j_hi, i_lo, i_hi; };

__device__ __forceinline__ KvRange kv_range(int q0, int bq, int bk, int Sq,
                                            int Sk, int causal,
                                            int has_window, int window,
                                            int q_start) {
  const int q_last = q_start + min(q0 + bq, Sq) - 1;
  q0 += q_start;
  int k_lo = 0, k_hi = Sk;
  const bool dead_row = has_window &&
      (window < 1 || q_last >= Sk + window - 1);
  if (!dead_row) {
    if (causal) k_hi = min(k_hi, q_last + 1);
    if (has_window) k_lo = max(0, q0 - window + 1);
  }
  KvRange r;
  r.j_lo = k_lo / bk;
  r.j_hi = (k_hi + bk - 1) / bk;
  r.i_lo = r.j_lo;
  r.i_hi = min(r.j_hi, Sk / bk);
  if (causal) r.i_hi = min(r.i_hi, (q0 + 1) / bk);
  if (has_window) {
    const int lo = q_last - window + 1;
    if (lo > 0) r.i_lo = min(max(r.i_lo, (lo + bk - 1) / bk), r.j_hi);
  }
  if (r.i_hi < r.i_lo) r.i_hi = r.i_lo;
  return r;
}

struct Maps {
  CUtensorMap q, k, v;
};

// One box of a 4-D tensor map (D, S, heads, B) into shared memory;
// completion counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, zero-filled past ``bytes`` (0 or 16)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;"
               ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Registers a wgmma reads or writes asynchronously: pinned here, after
// the wait, so the compiler neither reads them early nor reuses them.
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// wgmma m64nNk16, bf16 in, f32 accumulate (PTX ISA).  _ss: A and B from
// shared memory, both K-major; _rs: A from registers, B transposed
// (N-major).  acc = 0 overwrites d.  Accumulator layout, per warp w of
// the warpgroup and lane = 4 g + c: d[4 j + e] holds row 16 w + g + 8
// (e >> 1), column 8 j + 2 c + (e & 1); the A fragment of a 16-column
// step is the same layout.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b, 1);
  else wgmma_rs_n256(d, a, b, 1);
}

struct Softmax {
  float scale_l2;             // scale * log2 e (no softcap)
  float k_tanh;               // 2 log2 e * scale / cap
  float cap_l2;               // cap * log2 e
  int Sk, causal, has_window, window;
  int q_start;                // position of output row 0
};

// One score tile of this thread (rows row0 and row0 + 8, columns k0 +
// 8 j + 2 c + {0, 1}) to weights in the log2 domain, in place: softcap,
// masks (EDGE tiles only), the running max m and sum l, and alpha, the
// factor that rescales the earlier tiles' output.
template <int BK, bool EDGE, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Softmax& sm, int row0,
                                             int k0, int c4) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float y;
    if (CAP)      // cap tanh(x scale / cap) log2 e
      y = fmaf(-2.f * sm.cap_l2, rcp(ex2(s[i] * sm.k_tanh) + 1.f),
               sm.cap_l2);
    else
      y = s[i] * sm.scale_l2;
    if (EDGE) {
      const int t = sm.q_start + row0 + 8 * ((i >> 1) & 1);
      const int u = k0 + 8 * (i >> 2) + 2 * c4 + (i & 1);
      const bool live = (!sm.causal || u <= t) &&
                        (!sm.has_window || u > t - sm.window);
      y = u >= sm.Sk ? -INFINITY : live ? y : NEG_INF;
    }
    s[i] = y;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], y);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];              // this lane's columns only
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
}

// Named barriers: 1 and 2 are the consumers' turns on the tensor cores,
// 3 and 4 each consumer's own (the GATHER prologue).
constexpr int kTurn = 1, kOwnQ = 3;

// Shared-memory addresses of a CTA's tiles and mbarriers.
template <int DP> struct Smem {
  uint32_t q, k, v, bars;
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const {
    return bars + 8 * (1 + Tiles<DP>::NST + s);
  }
  __device__ uint32_t k_empty(int s) const {
    return bars + 8 * (1 + 2 * Tiles<DP>::NST + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return bars + 8 * (1 + 3 * Tiles<DP>::NST + s);
  }
};

// A register value the compiler must take as new here: keeps address
// arithmetic inside the loop instead of hoisting one register per
// descriptor.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// One consumer warpgroup's state over the kv tiles: the output
// accumulator o, the score tile, the last tile's P (the A operand of
// its P V product, issued with the next tile's Q K^T), the running max
// and sum of its two rows, and where that last tile's v sits.
template <int DP, bool CAP> struct Consumer {
  static constexpr int BK = Tiles<DP>::BK, NST = Tiles<DP>::NST;
  // high word of every descriptor: stride 1024 B per 8 rows, 128-B swizzle
  static constexpr uint64_t kDescHi = ((uint64_t)(1024 >> 4) << 32) |
                                      (1ull << 62);
  float o[DP / 2], s[BK / 2];
  uint32_t pf[BK / 16][4];
  float m[2], l[2];
  int it, ps;                  // tiles done; the last tile's stage
  uint32_t pph;                // ... and its phase parity
  const Smem<DP> sm;
  const Softmax smx;
  int w, n, row0, c4, lane;

  __device__ Consumer(const Smem<DP>& sm_, const Softmax& smx_, int w_,
                      int n_, int row0_, int c4_, int lane_)
      : it(0), ps(0), pph(0), sm(sm_), smx(smx_), w(w_), n(n_),
        row0(row0_), c4(c4_), lane(lane_) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  // S = Q K^T of stage st: q and k K-major, 16 columns (32 B) a step
  __device__ __forceinline__ void issue_qk(int st) {
    const uint32_t qa = opaque(((sm.q + 64 * w * 128) >> 4) | (1u << 16));
    const uint32_t ka = opaque(((sm.k + st * Tiles<DP>::KV_BYTES) >> 4) |
                               (1u << 16));
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t step = (kk & 3) * 32 / 16;
      wgmma_ss<BK>(s, kDescHi | (qa + (kk >> 2) * (WQ * 128 / 16) + step),
                   kDescHi | (ka + (kk >> 2) * (BK * 128 / 16) + step),
                   kk > 0);
    }
  }

  // O += P V of stage st: v N-major, BK * 128 B per 64 columns, 16 keys
  // (2048 B) a step
  __device__ __forceinline__ void issue_pv(int st) {
    const uint32_t va = opaque(((sm.v + st * Tiles<DP>::KV_BYTES) >> 4) |
                               ((uint32_t)(BK * 128 >> 4) << 16));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(o, pf[kk], kDescHi | (va + kk * 2048 / 16));
  }

  __device__ __forceinline__ void release(uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }

  // P of the score tile, rounded to bf16 as the A fragments of P V
  __device__ __forceinline__ void pack_p() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pf[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }

  // The first tile: its Q K^T alone (no P V is pending), masks always.
  __device__ __forceinline__ void first(int j) {
    mbar_wait(sm.k_full(0), 0);
    bar_sync(kTurn + w, 256);                      // my turn
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    if (w == 0 || n > 1) bar_arrive(kTurn + 1 - w, 256);
    wgmma_wait<0>();
    fence_regs(s);
    release(sm.k_empty(0));
    float alpha[2];
    softmax_tile<BK, true, CAP>(s, m, l, alpha, smx, row0, j * BK, c4);
    pack_p();
    it = 1;
  }

  // A later tile: its Q K^T and the last tile's P V in one turn, then
  // its softmax while that P V runs.
  template <bool EDGE> __device__ __forceinline__ void next(int j) {
    const int st = it % NST;
    const uint32_t ph = (it / NST) & 1;
    mbar_wait(sm.k_full(st), ph);
    mbar_wait(sm.v_full(ps), pph);
    bar_sync(kTurn + w, 256);
    wgmma_fence();
    issue_qk(st);
    wgmma_commit();
    issue_pv(ps);
    wgmma_commit();
    // the other warpgroup's turn (warpgroup 1's last would be unmatched)
    if (w == 0 || it + 1 < n) bar_arrive(kTurn + 1 - w, 256);
    wgmma_wait<1>();
    fence_regs(s);
    release(sm.k_empty(st));
    float alpha[2];
    softmax_tile<BK, EDGE, CAP>(s, m, l, alpha, smx, row0, j * BK, c4);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    release(sm.v_empty(ps));
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p();
    ps = st;
    pph = ph;
    ++it;
  }

  // The last tile's P V.
  __device__ __forceinline__ void finish() {
    mbar_wait(sm.v_full(ps), pph);
    wgmma_fence();
    issue_pv(ps);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);
  }
};

template <int DP, bool GATHER, bool CAP>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_attention_wgmma_kernel(const Params p,
                             const __grid_constant__ Maps maps) {
  using Tl = Tiles<DP>;
  constexpr int BK = Tl::BK, NST = Tl::NST, CB = Tl::CB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem<DP> sm;
  sm.q = (smem_addr(smem_raw) + 1023) & ~1023u;   // [CB][WQ rows][128 B]
  sm.k = sm.q + Tl::Q_BYTES;                      // [NST][CB][BK][128 B]
  sm.v = sm.k + NST * Tl::KV_BYTES;
  sm.bars = sm.v + NST * Tl::KV_BYTES;

  const int nq = (p.Sq + WQ - 1) / WQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (nq - 1 - (int)blockIdx.y) * WQ;   // longest tiles first
  const int kh = h / p.group;
  const KvRange kr = kv_range(q0, WQ, BK, p.Sq, p.Sk, p.causal,
                              p.has_window, p.window, p.q_start);
  const int n = kr.j_hi - kr.j_lo;                  // >= 1 when Sk >= 1
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(sm.q_full(), 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.k_empty(s), 8);                  // the 8 consumer warps
      mbar_init(sm.v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every copy, the kv
    // tiles from the last (the diagonal) down ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 0) {
      if (!GATHER) {
        mbar_arrive_tx(sm.q_full(), Tl::Q_BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sm.q + c * (WQ * 128), &maps.q, 64 * c, q0, h, b,
                      sm.q_full());
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % NST;
        const uint32_t free_par = ((it / NST) & 1) ^ 1;
        const int k0 = (kr.j_hi - 1 - it) * BK;
        mbar_wait(sm.k_empty(s), free_par);
        mbar_arrive_tx(sm.k_full(s), Tl::KV_BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sm.k + s * Tl::KV_BYTES + c * (BK * 128), &maps.k,
                      64 * c, k0, kh, b, sm.k_full(s));
        mbar_wait(sm.v_empty(s), free_par);
        mbar_arrive_tx(sm.v_full(s), Tl::KV_BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sm.v + s * Tl::KV_BYTES + c * (BK * 128), &maps.v,
                      64 * c, k0, kh, b, sm.v_full(s));
      }
    }
  } else {
    // ---- consumer warpgroups w = 0, 1: query rows q0 + 64 w .. +63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w = tid / 128 - 1, ct = tid & 127;
    const int lane = ct & 31;
    const int row0 = q0 + 64 * w + 16 * (ct >> 5) + (lane >> 2);
    if (w == 1) bar_arrive(kTurn, 256);             // warpgroup 0 first

    using bf16 = __nv_bfloat16;
    if (GATHER) {
      const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
      constexpr int CPR = DP / 8;                   // 16-byte chunks a row
      for (int e = ct; e < 64 * CPR; e += 128) {
        const int r = e / CPR, ch = e % CPR, t = q0 + 64 * w + r;
        const int src = t < p.Sq ? p.q_rows[(int64_t)b * p.Sq + t] : -1;
        const bool live = src >= 0 && src < p.Sq && ch * 8 < p.D;
        const uint32_t dst = sm.q + (ch >> 3) * (WQ * 128) +
                             (64 * w + r) * 128 + (((ch & 7) ^ (r & 7)) << 4);
        cp_async16(dst, live ? qg + (int64_t)src * p.sqs + ch * 8 : qg,
                   live ? 16 : 0);
      }
      cp_async_wait_all();
      fence_async_smem();
      bar_sync(kOwnQ + w, 128);
    } else {
      mbar_wait(sm.q_full(), 0);
    }

    const Softmax smx{p.scale * LOG2E, 2.f * LOG2E * p.scale / p.cap,
                      p.cap * LOG2E, p.Sk, p.causal, p.has_window,
                      p.window, p.q_start};
    Consumer<DP, CAP> cs(sm, smx, w, n, row0, lane & 3, lane);
    // kv tiles from the last down: the first (masked always), then the
    // edge tiles above the interior ones, the interior ones, and the
    // edge tiles below them, each loop with its masks fixed
    int j = kr.j_hi - 1;
    cs.first(j--);
    for (; j >= kr.i_hi; --j) cs.template next<true>(j);
    for (; j >= kr.i_lo; --j) cs.template next<false>(j);
    for (; j >= kr.j_lo; --j) cs.template next<true>(j);
    cs.finish();

    // ---- flush: the quad's partial sums, then o / l ----
    bf16* og = static_cast<bf16*>(p.out);
    const int c4 = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = cs.l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int t = row0 + 8 * r;
      if (t >= p.Sq) continue;
      bool live = true;
      if (GATHER) {
        const int src = p.q_rows[(int64_t)b * p.Sq + t];
        live = src >= 0 && src < p.Sq;
      }
      const float inv = live ? 1.f / (lr > 0.f ? lr : 1.f) : 0.f;
      bf16* orow = og + (((int64_t)b * p.Sq + t) * p.H + h) * p.D;
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        const int d = 8 * jj + 2 * c4;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(cs.o[4 * jj + 2 * r] * inv,
                                    cs.o[4 * jj + 2 * r + 1] * inv);
      }
    }
  }
}

// Opt a kernel in to kSmemMax of dynamic shared memory, once per device
// and instantiation (each caller's ``done``), outside the per-launch
// path.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T, int KD, bool GATHER>
int launch(const Params& p, int B, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(flash_attention_kernel<T, KD, GATHER>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_kernel<T, KD, GATHER>
      <<<grid, THREADS, smem_bytes(p.D), stream>>>(p);
  return (int)cudaGetLastError();
}

// [B, S, heads, D] bf16 with the given element strides as a 4-D tensor
// map (D, S, heads, B), boxes of 64 columns x ``rows``, 128-byte swizzle;
// a stride of an extent of 1 is never used (and may be 0).
int encode_bshd(CUtensorMap* map, const void* base, int D, int S, int heads,
                int B, int64_t ss, int64_t sh, int64_t sb, int rows) {
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
  auto bytes = [](int64_t s) { return (cuuint64_t)(s > 0 ? 2 * s : 16); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(ss), bytes(sh), bytes(sb)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP, bool GATHER, bool CAP>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  using Tl = Tiles<DP>;
  static_assert(Tl::SMEM <= (size_t)kSmemMax, "tiles exceed shared memory");
  static bool done[64] = {};
  cudaError_t err = allow_smem(flash_attention_wgmma_kernel<DP, GATHER, CAP>,
                               done);
  if (err != cudaSuccess) return (int)err;
  const int K = p.H / p.group;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  int rc = GATHER ? 0 : encode_bshd(&maps.q, p.q, p.D, p.Sq, p.H, B, p.sqs,
                                    p.sqh, p.sqb, WQ);
  if (!rc) rc = encode_bshd(&maps.k, p.k, p.D, p.Sk, K, B, p.sks, p.skh,
                            p.skb, Tl::BK);
  if (!rc) rc = encode_bshd(&maps.v, p.v, p.D, p.Sk, K, B, p.svs, p.svh,
                            p.svb, Tl::BK);
  if (rc) return rc;
  const dim3 grid(p.H, (p.Sq + WQ - 1) / WQ, B);
  flash_attention_wgmma_kernel<DP, GATHER, CAP>
      <<<grid, WTHREADS, Tl::SMEM, stream>>>(p, maps);
  return (int)cudaGetLastError();
}

// The Hopper body takes bf16 with D a multiple of 8 (whole 16-byte
// vectors) up to 256, every row start 16-byte aligned, and a positive
// stride (below 2^39 elements, the tensor map's limit) for every
// extent above 1; anything else runs on the CUDA-core body.
bool wgmma_fits(const Params& p, int B) {
  const int64_t K = p.H / p.group;
  const int64_t strides[9] = {p.sqb, p.sqs, p.sqh, p.skb, p.sks,
                              p.skh, p.svb, p.svs, p.svh};
  const int64_t extents[9] = {B, p.Sq, p.H, B, p.Sk, K, B, p.Sk, K};
  const void* ptrs[4] = {p.q, p.k, p.v, p.out};
  for (int i = 0; i < 9; ++i) {
    if (strides[i] % 8) return false;
    if (extents[i] > 1 &&
        (strides[i] <= 0 || strides[i] >= ((int64_t)1 << 39)))
      return false;
  }
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return p.D % 8 == 0 && p.D <= 256;
}

template <bool GATHER, bool CAP>
int with_wgmma_width(const Params& p, int B, cudaStream_t st) {
  if (p.D <= 64) return launch_wgmma<64, GATHER, CAP>(p, B, st);
  if (p.D <= 128) return launch_wgmma<128, GATHER, CAP>(p, B, st);
  return launch_wgmma<256, GATHER, CAP>(p, B, st);
}

template <typename T, bool GATHER>
int with_width(const Params& p, int B, cudaStream_t st) {
  const int kd = (p.D + 31) / 32;             // output columns per lane
  if (kd <= 1) return launch<T, 1, GATHER>(p, B, st);
  if (kd <= 2) return launch<T, 2, GATHER>(p, B, st);
  if (kd <= 4) return launch<T, 4, GATHER>(p, B, st);
  if (kd <= 8) return launch<T, 8, GATHER>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   const int* q_rows, void* out, int64_t sqb, int64_t sqs,
                   int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
                   int64_t svb, int64_t svs, int64_t svh, int Sq, int Sk,
                   int H, int K, int D, float scale, float cap, int causal,
                   int has_window, int window, int q_start) {
  return Params{q, k, v, q_rows, out, sqb, sqs, sqh, skb, sks, skh, svb,
                svs, svh, Sq, Sk, H, H / K, D, scale, cap, causal,
                has_window, window, q_start};
}

template <bool GATHER>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const int* q_rows, void* out, int64_t sqb, int64_t sqs,
             int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
             int64_t svb, int64_t svs, int64_t svh, int B, int Sq, int Sk,
             int H, int K, int D, float scale, float cap, int causal,
             int has_window, int window, int q_start, void* stream) {
  if (D < 1 || K < 1 || H % K || smem_bytes(D) > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Params p = make_params(q, k, v, q_rows, out, sqb, sqs, sqh, skb, sks,
                               skh, svb, svs, svh, Sq, Sk, H, K, D, scale,
                               cap, causal, has_window, window, q_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return with_width<float, GATHER>(p, B, st);
    case 1:
      if (!wgmma_fits(p, B)) return with_width<__nv_bfloat16, GATHER>(p, B, st);
      return p.cap > 0.f ? with_wgmma_width<GATHER, true>(p, B, st)
                         : with_wgmma_width<GATHER, false>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  q [B, Sq,
// H, D], k/v [B, Sk, K, D] with the given element strides (the last
// dimension contiguous); out [B, Sq, H, D] contiguous.  cap <= 0 means
// no softcap; has_window = 0 means no window; q row t sits at position
// q_start + t of the keys' sequence (for the masks).
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int B, int Sq,
    int Sk, int H, int K, int D, float scale, float cap, int causal,
    int has_window, int window, int q_start, void* stream) {
  return dispatch<false>(dtype, q, k, v, nullptr, out, sqb, sqs, sqh, skb,
                         sks, skh, svb, svs, svh, B, Sq, Sk, H, K, D, scale,
                         cap, causal, has_window, window, q_start, stream);
}

// The same attention with the q-row gather prologue: q_rows [B, Sq]
// int32, contiguous.
extern "C" int repro_flash_attention_gather(
    int dtype, const void* q, const void* k, const void* v,
    const int* q_rows, void* out, int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, int B, int Sq, int Sk, int H, int K, int D, float scale,
    float cap, int causal, int has_window, int window, int q_start,
    void* stream) {
  return dispatch<true>(dtype, q, k, v, q_rows, out, sqb, sqs, sqh, skb,
                        sks, skh, svb, svs, svh, B, Sq, Sk, H, K, D, scale,
                        cap, causal, has_window, window, q_start, stream);
}

// Which body a call with these arguments runs: 1 the Hopper (wgmma)
// body, 0 a CUDA-core body (the test dispatch() makes).
extern "C" int repro_flash_attention_body(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int B, int Sq,
    int Sk, int H, int K, int D) {
  if (K < 1 || H % K) return 0;
  const Params p = make_params(q, k, v, nullptr, out, sqb, sqs, sqh, skb,
                               sks, skh, svb, svs, svh, Sq, Sk, H, K, D, 1.f,
                               0.f, 0, 0, 0, 0);
  return dtype == 1 && wgmma_fits(p, B) ? 1 : 0;
}
