// Flash attention forward (online softmax), with an optional q-row
// gather prologue.
//
// Replaces: src/repro/kernels/attention/kernel.py, _kernel (via
// flash_attention_bhsd) and _kernel_gather (its q_rows= path), the
// Pallas TPU kernels.  One template serves both; GATHER adds the
// prologue.
//
// What it computes, per (batch b, query head h, query row t), with
// kv head h / group (GQA) and positions counted from 0 in q and in k:
//   s[t, u] = cap * tanh(((q[t] * scale) . k[u]) / cap)   (no cap: plain)
//   s[t, u] = -1e30 where the mask drops u: causal u <= t, window
//             u > t - window
//   out[t]  = sum_u softmax(s[t])[u] * v[u]               (f32, one store)
// With GATHER, row t attends with q row q_rows[b, t] of the token-order
// q buffer; q_rows outside [0, Sq) (the dispatch's -1) gives an exact
// zero output row.  Masks use the output order t.
//
// Bound: operations for long sequences (4 * D per live (t, u) pair and
// head), bytes (q, k, v read once, out written once) for short ones.
// Two bodies share the tiling, the masks and the online softmax:
//   - flash_attention_mma_kernel (bf16, D a multiple of 8 up to 256,
//     16-byte aligned rows): both products on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate).  4 warps, each owns
//     16 query rows; q, k, v tiles are staged as bf16 in shared memory
//     (rows padded by 16 bytes, so ldmatrix is free of bank conflicts);
//     the [16, 64] score tile of a warp stays in registers, and its
//     probabilities are rounded to bf16 to feed the P.V product (the
//     running sum keeps them in f32), so the output differs from the f32
//     plain version by a bf16 rounding of the weights.  No TMA, wgmma
//     or pipelining yet.
//   - flash_attention_kernel (f32, and bf16 shapes the first cannot
//     take): the products on the CUDA cores in f32.
//     q, k, v tiles in f32 in shared memory (rows padded by one word so
//     column walks hit distinct banks), the [64, 64] score tile there
//     too, 8 rows x D/32 output columns per thread.
// Both keep what the TPU kernel keeps out of device memory:
//   - one CTA per (q tile of 64 rows, q head, batch); the grid runs the
//     longest causal tiles first;
//   - q, k and v tiles staged through shared memory, scores never in
//     device memory;
//   - running max and sum per row and an f32 [64, D] accumulator in
//     registers;
//   - the kv loop visits only the tiles the causal and window masks
//     leave live for some row of the q tile.  Skipped tiles hold only
//     masked scores, whose weight exp(-1e30 - m) is exactly 0 once a
//     row has seen a live key.  A row with no live key at all (window
//     set and t >= Sk + window - 1) weighs every masked key equally in
//     the reference; a tile holding such a row visits every kv tile.
//   - keys beyond Sk in the ragged last tile score -inf (weight 0 in
//     every case), so any Sq, Sk work; the wrapper keeps the reference's
//     block-multiple contract.
// D <= 256: at D = 256 the f32 tiles take 214,528 bytes of shared
// memory, the bf16 tiles of the tensor-core body 101,632.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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

  // ---- the kv tiles some row of this q tile can see ----
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Sk;
  const bool dead_row = p.has_window &&
      (p.window < 1 || q_last >= p.Sk + p.window - 1);
  if (!dead_row) {
    if (p.causal) k_hi = min(k_hi, q_last + 1);
    if (p.has_window) k_lo = max(0, q0 - p.window + 1);
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
        const int t = q0 + r, u = k0 + c;
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

// ---- the tensor-core body (bf16) ----

constexpr int MMA_THREADS = 128;              // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of the
// i-th, which lands in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c[16x8] += a[16x16] (row) * b[16x8] (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(BQ + 2 * BK) * (DP + 8) * sizeof(__nv_bfloat16) +
         BQ * sizeof(int);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + c; a score or
// output tile's c[0], c[1] hold row g, columns 2c and 2c + 1, and c[2],
// c[3] row g + 8.  DP is D rounded up to the instantiated width; columns
// D..DP of the staged tiles are zeros.
template <int DP, bool GATHER>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const Params p) {
  constexpr int LDS = DP + 8;                 // padded row, in elements
  constexpr int VPR = DP / 8;                 // 16-byte vectors per row
  constexpr int NO = DP / 8;                  // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LDS;
  __nv_bfloat16* vs = ks + BK * LDS;
  int* rows_s = reinterpret_cast<int*>(vs + BK * LDS);

  const int D = p.D;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + kh * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + kh * p.svh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // ---- prologue: the q tile (gathered rows with GATHER), unscaled ----
  if (GATHER) {
    for (int r = tid; r < BQ; r += MMA_THREADS) {
      const int t = q0 + r;
      int src = t < p.Sq ? p.q_rows[(int64_t)b * p.Sq + t] : -1;
      rows_s[r] = (src >= 0 && src < p.Sq) ? src : -1;
    }
    __syncthreads();
  }
  for (int e = tid; e < BQ * VPR; e += MMA_THREADS) {
    const int r = e / VPR, c = (e % VPR) * 8;
    const int src = GATHER ? rows_s[r] : (q0 + r < p.Sq ? q0 + r : -1);
    *reinterpret_cast<uint4*>(qs + r * LDS + c) =
        (src >= 0 && c < D)
            ? *reinterpret_cast<const uint4*>(qg + src * p.sqs + c)
            : zero;
  }

  // ---- the kv tiles some row of this q tile can see (as above) ----
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Sk;
  const bool dead_row = p.has_window &&
      (p.window < 1 || q_last >= p.Sk + p.window - 1);
  if (!dead_row) {
    if (p.causal) k_hi = min(k_hi, q_last + 1);
    if (p.has_window) k_lo = max(0, q0 - p.window + 1);
  }
  const int j_lo = k_lo / BK, j_hi = (k_hi + BK - 1) / BK;

  const int r_lo = warp * 16 + g;             // this lane's rows: r_lo, +8
  const int t_row[2] = {q0 + r_lo, q0 + r_lo + 8};
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();                          // last tile's readers done
    for (int e = tid; e < BK * VPR; e += MMA_THREADS) {
      const int r = e / VPR, c = (e % VPR) * 8;
      const int u = k0 + r;
      const bool in = u < p.Sk && c < D;
      *reinterpret_cast<uint4*>(ks + r * LDS + c) =
          in ? *reinterpret_cast<const uint4*>(kg + u * p.sks + c) : zero;
      *reinterpret_cast<uint4*>(vs + r * LDS + c) =
          in ? *reinterpret_cast<const uint4*>(vg + u * p.svs + c) : zero;
    }
    __syncthreads();

    // scores: this warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, masks; row max over the quad that shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t_row[e >> 1];
        const int u = k0 + n * 8 + 2 * c4 + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.cap > 0.f) x = p.cap * tanhf(x / p.cap);
        bool live = true;
        if (p.causal) live = live && u <= t;
        if (p.has_window) live = live && u > t - p.window;
        x = live ? x : NEG_INF;
        if (u >= p.Sk) x = -INFINITY;         // ragged edge: weight 0
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - m_new[e >> 1]);
        s[n][e] = pe;
        sum[e >> 1] += pe;                    // this lane's columns only
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + sum[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // o += p @ v: the score tiles 2ks, 2ks+1 are the A operand of key
    // step ks; v through ldmatrix.trans
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kq][0], s[2 * kq][1]),
          pack_bf16(s[2 * kq][2], s[2 * kq][3]),
          pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
          pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + (kq * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LDS +
                               np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], a, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }

  // ---- flush: the quad's partial sums, then acc / l ----
  bf16* og = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = t_row[i];
    if (t >= p.Sq) continue;
    const bool live = !GATHER || rows_s[r_lo + 8 * i] >= 0;
    const float inv = 1.f / (l > 0.f ? l : 1.f);
    bf16* orow = og + (((int64_t)b * p.Sq + t) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * c4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            live ? __floats2bfloat162_rn(o[n][2 * i] * inv,
                                         o[n][2 * i + 1] * inv)
                 : __floats2bfloat162_rn(0.f, 0.f);
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

template <int DP, bool GATHER>
int launch_mma(const Params& p, int B, cudaStream_t stream) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(flash_attention_mma_kernel<DP, GATHER>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_mma_kernel<DP, GATHER>
      <<<grid, MMA_THREADS, mma_smem_bytes<DP>(), stream>>>(p);
  return (int)cudaGetLastError();
}

// The tensor-core body takes bf16 with D a multiple of 8 (whole 16-byte
// vectors) and every row start 16-byte aligned.
bool mma_fits(const Params& p) {
  const int64_t strides[9] = {p.sqb, p.sqs, p.sqh, p.skb, p.sks,
                              p.skh, p.svb, p.svs, p.svh};
  const void* ptrs[4] = {p.q, p.k, p.v, p.out};
  for (int64_t s : strides)
    if (s % 8) return false;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return p.D % 8 == 0 && p.D <= 256;
}

template <bool GATHER>
int with_mma_width(const Params& p, int B, cudaStream_t st) {
  if (p.D <= 64) return launch_mma<64, GATHER>(p, B, st);
  if (p.D <= 128) return launch_mma<128, GATHER>(p, B, st);
  return launch_mma<256, GATHER>(p, B, st);
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

template <bool GATHER>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const int* q_rows, void* out, int64_t sqb, int64_t sqs,
             int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
             int64_t svb, int64_t svs, int64_t svh, int B, int Sq, int Sk,
             int H, int K, int D, float scale, float cap, int causal,
             int has_window, int window, void* stream) {
  if (D < 1 || K < 1 || H % K || smem_bytes(D) > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  Params p{q, k, v, q_rows, out, sqb, sqs, sqh, skb, sks, skh, svb, svs,
           svh, Sq, Sk, H, H / K, D, scale, cap, causal, has_window,
           window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return with_width<float, GATHER>(p, B, st);
    case 1: return mma_fits(p) ? with_mma_width<GATHER>(p, B, st)
                               : with_width<__nv_bfloat16, GATHER>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  q [B, Sq,
// H, D], k/v [B, Sk, K, D] with the given element strides (the last
// dimension contiguous); out [B, Sq, H, D] contiguous.  cap <= 0 means
// no softcap; has_window = 0 means no window.
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int B, int Sq,
    int Sk, int H, int K, int D, float scale, float cap, int causal,
    int has_window, int window, void* stream) {
  return dispatch<false>(dtype, q, k, v, nullptr, out, sqb, sqs, sqh, skb,
                         sks, skh, svb, svs, svh, B, Sq, Sk, H, K, D, scale,
                         cap, causal, has_window, window, stream);
}

// The same attention with the q-row gather prologue: q_rows [B, Sq]
// int32, contiguous.
extern "C" int repro_flash_attention_gather(
    int dtype, const void* q, const void* k, const void* v,
    const int* q_rows, void* out, int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
    int64_t svh, int B, int Sq, int Sk, int H, int K, int D, float scale,
    float cap, int causal, int has_window, int window, void* stream) {
  return dispatch<true>(dtype, q, k, v, q_rows, out, sqb, sqs, sqh, skb,
                        sks, skh, svb, svs, svh, B, Sq, Sk, H, K, D, scale,
                        cap, causal, has_window, window, stream);
}
