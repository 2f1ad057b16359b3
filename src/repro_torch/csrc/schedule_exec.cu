// Whole-schedule transport kernel: one launch runs every compiled round
// of a CommSchedule on the global slot buffer [n, s, L] (L = the slot's
// flattened payload, C*F elements).
//
// Replaces: src/repro/core/pallas_lowering.py, PallasExec._kernel (the
// Pallas TPU kernel that bakes the routing program as static indices).
//
// What it computes (per column of the payload, independently; a "row"
// is one (rank, slot) pair, rank * s + slot):
//   work[i] = in[src_row[i]]            for the rows that are loaded
//   for each round, for each live landing (src, dst) in (edge, position)
//   order:   work[dst] = reduce ? work[dst] + v : v
//            with v = work[src] from the pre-round state, or +0 where the
//            gather is masked (src = -1)
//   out[i] = work[post_row[i]]
// The host tables (core/kernel_lowering.py) fold the pre and post
// permutations into src_row / post_row and list each round's live
// landings as (src, dst) row pairs; dropped landings are not listed.
//
// Bound: bytes.  The design floor is every row that reaches the output
// read once and every row written once: a row whose first access is a
// set landing is never loaded (src_row = -1), and the routing itself is
// shared-memory traffic.
//
// Design (sm_90a):
//   * Persistent CTAs: the grid is at most SMs x resident CTAs, and each
//     CTA walks the (chunk, column tile) items b, b + grid, ...  A tile
//     of TILE columns across all n*s rows stays in shared memory from
//     stage-in to drain, so the rounds never touch device memory.
//   * A ring of nbuf [ns, TILE] buffers.  Warp 0 is the producer: it
//     stages each item in with TMA boxes of a 3-D tensor map (columns,
//     chunk, rows), completion counted in bytes on the buffer's mbarrier,
//     and drains finished items with TMA box stores.  A box covers 2^k
//     consecutive rows whose source rows are consecutive too (the host
//     splits runs of live rows, and of the post order, into such boxes),
//     so pre and post are applied by the choice of rows and the dead
//     rows are skipped, in a few copies per item instead of one per row.
//     The tensor map clips the ragged column edge of a chunk.  A buffer
//     is refilled once its stores have read it
//     (cp.async.bulk.wait_group.read).  Warps 1..8 run the rounds on the
//     buffer that has arrived.  So one item's stage-in, another's rounds
//     and a third's drain overlap, on one SM and across its CTAs.
//   * Rounds move 16 bytes a thread (4 f32 or 8 bf16).  Direct rounds
//     (no landing row is also a gather row of the round) land straight
//     from the buffer; hazard rounds gather into a stage first.  Rounds
//     whose landing rows are distinct (every round of a validated
//     schedule) land every (pair, vector) in parallel; rounds with a
//     repeated landing row keep each target's chain in (edge, position)
//     order.  TILE is a template constant: no division by a runtime
//     tile on the element path.
//   * Rows whose byte length is no multiple of 16 (or a buffer that is
//     not 16-byte aligned) cannot be described to the TMA: they take the
//     ragged path of the same launch, scalar loads and stores, one item
//     at a time, the same rounds.
//
// A schedule too tall for shared memory (thousands of rows: neighbor and
// KV-transfer plans) takes one of the two bodies below, one launch too:
// the gather body when no round reduces (it copies each output row from
// the input row the whole schedule composes it to), else the
// global-memory body (the same rounds, the work rows in device memory).
//
// Bitwise contract with SimTransport.run_reference: landings at a
// repeated target are applied one at a time in (edge, position) order;
// bfloat16 adds are taken in f32 and rounded back after every add
// (__float2bfloat16_rn), as ml_dtypes and the Pallas kernel do.  Masked
// gathers contribute +0 and are still added to live targets (x + 0 turns
// -0.0 into +0.0).  A rank that is not a destination keeps its row.
//
// The int32 table `tab` (packed once per CompiledExec) holds, in order:
//   loads  [NL, 4]  (buffer row, input row, k, 0): box of 2^k rows
//   stores [NS, 4]  (output row, buffer row, k, 0)
//   meta   [R, 4]   (pair offset, pair count, flags, 0): kReduce,
//                   kDirect, kOrdered
//   pairs  [P, 2]   (src row or -1, dst row) per live landing
//   src_row [ns], post_row [ns]   (the ragged path's row maps)
// The kernel copies it into shared memory once per CTA.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;        // + the producer warp
constexpr int kMaxBufs = 4;
constexpr int kBarBytes = 2 * kMaxBufs * 8;      // full[] and done[]
constexpr int kClasses = 9;                      // boxes of 1 .. 256 rows
// Shared memory one CTA may use on sm_90 (227 KB).
constexpr int kSmemMax = 232448;

enum : int { kReduce = 1, kDirect = 2, kOrdered = 4 };

// Tensor maps of the input and the output, one per box height 2^k rows
// (only the heights the schedule's copies use are encoded).
struct Maps {
  CUtensorMap in[kClasses];
  CUtensorMap out[kClasses];
};

// ---- 16-byte vectors --------------------------------------------------

template <typename T> struct Vec;
template <> struct Vec<float> {
  __device__ static uint4 add(uint4 a, uint4 b) {
    uint4 r;
    r.x = __float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x));
    r.y = __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y));
    r.z = __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z));
    r.w = __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w));
    return r;
  }
};
template <> struct Vec<__nv_bfloat16> {
  __device__ static uint32_t add2(uint32_t a, uint32_t b) {
    const __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
    const __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
    __nv_bfloat162 r;
    r.x = __float2bfloat16_rn(__bfloat162float(x.x) + __bfloat162float(y.x));
    r.y = __float2bfloat16_rn(__bfloat162float(x.y) + __bfloat162float(y.y));
    return *reinterpret_cast<uint32_t*>(&r);
  }
  __device__ static uint4 add(uint4 a, uint4 b) {
    return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                      add2(a.w, b.w));
  }
};

// ---- bulk copies (PTX; mbarriers in hopper.cuh) ----------------------

// One box of a 3-D tensor map (columns, chunk, rows) into shared memory;
// completion counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int chunk, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(chunk), "r"(row), "r"(bar)
      : "memory");
}

// One box from shared memory out to the tensor map's tensor (bulk group).
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int chunk,
                                          int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col),
         "r"(chunk), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier over the consumer warps only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

// ---- the rounds, on one [ns, TILE] buffer -----------------------------

// Every round of the schedule on `work` (rows of VPR 16-byte vectors),
// run by the kConsumers threads (ct = 0 .. kConsumers - 1).  Ends with a
// consumer barrier after every round, so the next item may reuse the
// stage.
template <typename T, int VPR>
__device__ void run_rounds(uint4* work, uint4* stage, const int4* meta,
                           const int2* pairs, int rounds, int ct) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int q = 0; q < rounds; ++q) {
    const int4 mq = meta[q];
    const int2* pr = pairs + mq.x;
    const int np = mq.y, flags = mq.z;
    const bool reduce = flags & kReduce;
    const bool staged = !(flags & kDirect);
    if (staged) {                         // hazard: gather into the stage
      for (int idx = ct; idx < np * VPR; idx += kConsumers) {
        const int p = idx / VPR, v = idx - p * VPR;
        const int sr = pr[p].x;
        stage[idx] = sr >= 0 ? work[sr * VPR + v] : zero;
      }
      consumers_sync();
    }
    if (!(flags & kOrdered)) {            // distinct targets: all at once
      for (int idx = ct; idx < np * VPR; idx += kConsumers) {
        const int p = idx / VPR, v = idx - p * VPR;
        const int2 e = pr[p];
        const uint4 val = staged ? stage[idx]
                                 : e.x >= 0 ? work[e.x * VPR + v] : zero;
        uint4* dst = &work[e.y * VPR + v];
        *dst = reduce ? Vec<T>::add(*dst, val) : val;
      }
    } else {                              // repeated targets: in order
      for (int v = ct; v < VPR; v += kConsumers) {
        for (int p = 0; p < np; ++p) {
          const int2 e = pr[p];
          const uint4 val = staged ? stage[p * VPR + v]
                                   : e.x >= 0 ? work[e.x * VPR + v] : zero;
          uint4* dst = &work[e.y * VPR + v];
          *dst = reduce ? Vec<T>::add(*dst, val) : val;
        }
      }
    }
    consumers_sync();
  }
}

// ---- the kernel -------------------------------------------------------

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads)
schedule_exec_kernel(const T* __restrict__ in, T* __restrict__ out,
                     const __grid_constant__ Maps maps,
                     const int* __restrict__ tab, int ntab, int nloads,
                     int nstores, int rounds, int ns, int64_t L,
                     int64_t chunk_len, int items, int nbuf, int stage_rows,
                     int nlive, int aligned) {
  constexpr int ROW_BYTES = TILE * (int)sizeof(T);
  constexpr int VPR = ROW_BYTES / 16;
  static_assert(ROW_BYTES % 128 == 0, "TMA boxes start 128-byte aligned");
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // full, then done
  int* stab = reinterpret_cast<int*>(smem + kBarBytes);
  const int4* loads = reinterpret_cast<const int4*>(stab);
  const int4* stores = loads + nloads;
  const int4* meta = stores + nstores;
  const int2* pairs = reinterpret_cast<const int2*>(meta + rounds);
  const int* src_row = stab + ntab - 2 * ns;
  const int* post_row = stab + ntab - ns;
  unsigned char* stage_ptr = smem + ((kBarBytes + ntab * 4 + 127) & ~127);
  uint4* stage = reinterpret_cast<uint4*>(stage_ptr);
  unsigned char* buf0 = stage_ptr + (size_t)stage_rows * ROW_BYTES;
  const size_t buf_bytes = (size_t)ns * ROW_BYTES;

  const int tid = threadIdx.x;
  for (int i = tid; i < ntab; i += kThreads) stab[i] = tab[i];
  if (tid == 0) {
    for (int b = 0; b < nbuf; ++b) {
      mbar_init(smem_addr(&bars[b]), 1);                      // full
      mbar_init(smem_addr(&bars[kMaxBufs + b]), kConsumers);  // done
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int tiles = (int)((chunk_len + TILE - 1) / TILE);
  const int count = (items - (int)blockIdx.x + (int)gridDim.x - 1)
                    / (int)gridDim.x;
  // item j of this CTA -> its chunk and first column within the chunk
  auto item = [&](int j, int& chunk, int& col) {
    const int it = (int)blockIdx.x + j * (int)gridDim.x;
    chunk = it / tiles;
    col = (it - chunk * tiles) * TILE;
  };

  if (!aligned) {
    // ragged path: scalar copies, one item at a time, consumers only
    if (tid < 32) return;
    const int ct = tid - 32;
    T* work = reinterpret_cast<T*>(buf0);
    for (int j = 0; j < count; ++j) {
      int chunk, col;
      item(j, chunk, col);
      const int64_t col0 = (int64_t)chunk * chunk_len + col;
      const int width = chunk_len - col < TILE ? (int)(chunk_len - col)
                                               : TILE;
      for (int idx = ct; idx < ns * TILE; idx += kConsumers) {
        const int row = idx / TILE, c = idx - row * TILE;
        const int sr = src_row[row];
        if (c < width && sr >= 0) work[idx] = in[(int64_t)sr * L + col0 + c];
      }
      consumers_sync();
      run_rounds<T, VPR>(reinterpret_cast<uint4*>(work), stage, meta, pairs,
                         rounds, ct);
      for (int idx = ct; idx < ns * TILE; idx += kConsumers) {
        const int row = idx / TILE, c = idx - row * TILE;
        if (c < width)
          out[(int64_t)row * L + col0 + c] = work[post_row[row] * TILE + c];
      }
      consumers_sync();
    }
    return;
  }

  if (tid < 32) {
    // producer warp: TMA stage-in and drain
    const int lane = tid;
    auto load = [&](int j) {
      const int b = j % nbuf;
      int chunk, col;
      item(j, chunk, col);
      const uint32_t bar = smem_addr(&bars[b]);
      const uint32_t dst = smem_addr(buf0 + b * buf_bytes);
      // a box counts its full size, columns past the chunk's end included
      if (lane == 0) mbar_arrive_tx(bar, (uint32_t)nlive * ROW_BYTES);
      __syncwarp();
      for (int op = lane; op < nloads; op += 32) {
        const int4 o = loads[op];
        tma_load(dst + o.x * ROW_BYTES, &maps.in[o.z], col, chunk, o.y, bar);
      }
    };
    for (int j = 0; j < count && j < nbuf; ++j) load(j);
    for (int j = 0; j < count; ++j) {
      const int b = j % nbuf;
      mbar_wait(smem_addr(&bars[kMaxBufs + b]), (j / nbuf) & 1);
      int chunk, col;
      item(j, chunk, col);
      const uint32_t src = smem_addr(buf0 + b * buf_bytes);
      for (int op = lane; op < nstores; op += 32) {
        const int4 o = stores[op];
        tma_store(&maps.out[o.z], src + o.y * ROW_BYTES, col, chunk, o.x);
      }
      bulk_commit();
      if (j + nbuf < count) {
        bulk_wait_read();       // this lane's stores have read buffer b
        __syncwarp();
        load(j + nbuf);
      }
    }
    bulk_wait_all();
    return;
  }

  // consumer warps: the rounds of each item that has arrived
  const int ct = tid - 32;
  for (int j = 0; j < count; ++j) {
    const int b = j % nbuf;
    mbar_wait(smem_addr(&bars[b]), (j / nbuf) & 1);
    run_rounds<T, VPR>(reinterpret_cast<uint4*>(buf0 + b * buf_bytes), stage,
                       meta, pairs, rounds, ct);
    fence_async_smem();
    mbar_arrive(smem_addr(&bars[kMaxBufs + b]));
  }
}

// ---- host side --------------------------------------------------------

template <typename T> constexpr CUtensorMapDataType kMapType =
    CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
template <> constexpr CUtensorMapDataType kMapType<__nv_bfloat16> =
    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// The tensor [rows, chunks, chunk_len] as a 3-D map with boxes of
// (TILE columns, 1 chunk, 2^k rows), for every k set in `classes`.
template <typename T, int TILE>
int encode_maps(CUtensorMap* maps, const void* base, int ns, int64_t L,
                int chunks, int classes) {
  EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
  const int64_t chunk_len = L / chunks;
  const cuuint64_t dims[3] = {(cuuint64_t)chunk_len, (cuuint64_t)chunks,
                              (cuuint64_t)ns};
  const cuuint64_t strides[2] = {(cuuint64_t)(chunk_len * sizeof(T)),
                                 (cuuint64_t)(L * sizeof(T))};
  const cuuint32_t unit[3] = {1, 1, 1};
  for (int k = 0; k < kClasses; ++k) {
    if (!(classes >> k & 1)) continue;
    const cuuint32_t box[3] = {(cuuint32_t)TILE, 1, 1u << k};
    const CUresult res = encode(
        &maps[k], kMapType<T>, 3, const_cast<void*>(base), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T, int TILE>
int launch_tile(const void* in, void* out, const int* tab, int ntab,
                int nloads, int nstores, int load_classes, int store_classes,
                int rounds, int ns, int64_t L, int chunks, int nbuf,
                int stage_rows, int nlive, int aligned, size_t smem,
                int* info, cudaStream_t stream) {
  auto kern = schedule_exec_kernel<T, TILE>;
  // opt in to kSmemMax of dynamic shared memory once per device, and
  // cache the occupancy of the last footprint
  static bool opted[64] = {};
  static size_t occ_smem[64] = {};
  static int occ[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  if (occ_smem[dev] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem[dev] = smem;
  }
  const int64_t chunk_len = L / chunks;
  const int64_t items = (chunk_len + TILE - 1) / TILE * chunks;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t cap = (int64_t)sms[dev] * occ[dev];
  const int grid = (int)(items < cap ? items : cap);
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (aligned) {
    int rc = encode_maps<T, TILE>(maps.in, in, ns, L, chunks, load_classes);
    if (!rc)
      rc = encode_maps<T, TILE>(maps.out, out, ns, L, chunks, store_classes);
    if (rc) return rc;
  }
  if (info) {
    info[0] = grid;
    info[1] = occ[dev];
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), maps, tab, ntab,
      nloads, nstores, rounds, ns, L, chunk_len, (int)items, nbuf, stage_rows,
      nlive, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, const int* tab, int ntab, int nloads,
           int nstores, int load_classes, int store_classes, int rounds,
           int ns, int64_t L, int chunks, int tile, int nbuf, int stage_rows,
           int nlive, int* info, cudaStream_t stream) {
  if (nbuf < 1 || nbuf > kMaxBufs || chunks < 1 || L % chunks)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (((size_t)kBarBytes + (size_t)ntab * 4 + 127)
                       & ~(size_t)127)
      + ((size_t)nbuf * ns + stage_rows) * tile * sizeof(T);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // the TMA needs row strides and buffers 16-byte aligned
  const int aligned = (L / chunks * (int64_t)sizeof(T)) % 16 == 0
      && reinterpret_cast<uintptr_t>(in) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (info) info[2] = aligned;
  // rows of 128 B at least, so that every TMA box starts 128-byte aligned
#define TILE_CASE(N)                                                         \
  case N:                                                                    \
    if constexpr (N * sizeof(T) % 128 == 0)                                  \
      return launch_tile<T, N>(in, out, tab, ntab, nloads, nstores,          \
                               load_classes, store_classes, rounds, ns, L,   \
                               chunks, nbuf, stage_rows, nlive, aligned,     \
                               smem, info, stream);                          \
    break;
  switch (tile) {
    TILE_CASE(32) TILE_CASE(64) TILE_CASE(128) TILE_CASE(256)
  }
#undef TILE_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- the global-memory body ------------------------------------------
//
// For schedules whose rows do not fit one CTA's shared memory (a
// neighbor or KV-transfer plan of thousands of rows).  It computes what
// the shared body computes, with the work rows in device memory: a
// scratch [ns, L] (or `out` itself when the post order is the identity),
// the stage a [stage_rows, tile] slice of device memory per CTA, and the
// routing table read in place through the read-only cache.  Rows never
// mix across columns, so each persistent CTA owns whole column tiles and
// runs every round for them with only __syncthreads() between rounds
// (which orders the block's global-memory writes too): no grid-wide
// barrier, one launch.  U is the unit a thread moves: a 16-byte vector
// where rows and buffers are 16-byte aligned, else one element; TU units
// make a tile, 128 bytes of a row.

constexpr int kGlobalThreads = 256;

// Unit<T, U>: the zero and the add of one unit (bf16 adds taken in f32
// and rounded back after every add, as the shared body does).
template <typename T, typename U> struct Unit;
template <> struct Unit<float, float> {
  __device__ static float zero() { return 0.f; }
  __device__ static float add(float a, float b) { return a + b; }
};
template <> struct Unit<__nv_bfloat16, __nv_bfloat16> {
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
  }
};
template <typename T> struct Unit<T, uint4> {
  __device__ static uint4 zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static uint4 add(uint4 a, uint4 b) { return Vec<T>::add(a, b); }
};

template <typename T, typename U, int TU>
__global__ void __launch_bounds__(kGlobalThreads)
schedule_exec_global_kernel(const U* __restrict__ in, U* out, U* work,
                            U* stage_all, const int* __restrict__ tab,
                            int ntab, int nloads, int nstores, int rounds,
                            int ns, int64_t L, int64_t chunk_len, int items,
                            int stage_rows) {
  using V = Unit<T, U>;
  const int4* meta = reinterpret_cast<const int4*>(tab) + nloads + nstores;
  const int2* pairs = reinterpret_cast<const int2*>(meta + rounds);
  const int* src_row = tab + ntab - 2 * ns;
  const int* post_row = tab + ntab - ns;
  U* stage = stage_all + (int64_t)blockIdx.x * stage_rows * TU;
  const bool drain = work != out;
  const int tiles = (int)((chunk_len + TU - 1) / TU);
  const int tid = threadIdx.x;
  const U zero = V::zero();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int chunk = it / tiles;
    const int64_t c = (int64_t)(it - chunk * tiles) * TU;
    const int64_t col0 = (int64_t)chunk * chunk_len + c;
    const int width = chunk_len - c < TU ? (int)(chunk_len - c) : TU;
    // stage-in: the live rows through pre
    for (int idx = tid; idx < ns * TU; idx += kGlobalThreads) {
      const int row = idx / TU, v = idx % TU;
      const int sr = __ldg(src_row + row);
      if (v < width && sr >= 0)
        work[(int64_t)row * L + col0 + v] = in[(int64_t)sr * L + col0 + v];
    }
    __syncthreads();
    for (int q = 0; q < rounds; ++q) {
      const int4 mq = __ldg(meta + q);
      const int2* pr = pairs + mq.x;
      const int np = mq.y, flags = mq.z;
      const bool reduce = flags & kReduce;
      const bool staged = !(flags & kDirect);
      if (staged) {                       // hazard: gather into the stage
        for (int idx = tid; idx < np * TU; idx += kGlobalThreads) {
          const int p = idx / TU, v = idx % TU;
          const int sr = __ldg(&pr[p].x);
          if (v < width)
            stage[idx] = sr >= 0 ? work[(int64_t)sr * L + col0 + v] : zero;
        }
        __syncthreads();
      }
      if (!(flags & kOrdered)) {          // distinct targets: all at once
        for (int idx = tid; idx < np * TU; idx += kGlobalThreads) {
          const int p = idx / TU, v = idx % TU;
          if (v >= width) continue;
          const int2 e = __ldg(pr + p);
          const U val = staged ? stage[idx]
              : e.x >= 0 ? work[(int64_t)e.x * L + col0 + v] : zero;
          U* dst = &work[(int64_t)e.y * L + col0 + v];
          *dst = reduce ? V::add(*dst, val) : val;
        }
      } else {                            // repeated targets: in order
        for (int v = tid; v < width; v += kGlobalThreads) {
          for (int p = 0; p < np; ++p) {
            const int2 e = __ldg(pr + p);
            const U val = staged ? stage[p * TU + v]
                : e.x >= 0 ? work[(int64_t)e.x * L + col0 + v] : zero;
            U* dst = &work[(int64_t)e.y * L + col0 + v];
            *dst = reduce ? V::add(*dst, val) : val;
          }
        }
      }
      __syncthreads();
    }
    if (drain) {                          // out = work through post
      for (int idx = tid; idx < ns * TU; idx += kGlobalThreads) {
        const int row = idx / TU, v = idx % TU;
        if (v < width)
          out[(int64_t)row * L + col0 + v] =
              work[(int64_t)__ldg(post_row + row) * L + col0 + v];
      }
    }
  }
}

template <typename T, typename U, int TU>
int launch_global_as(const void* in, void* out, void* work, void* stage,
                     const int* tab, int ntab, int nloads, int nstores,
                     int rounds, int ns, int64_t L, int chunks, int grid,
                     int stage_rows, cudaStream_t stream) {
  const int64_t chunk_len = L / chunks;
  const int64_t items = (chunk_len + TU - 1) / TU * chunks;
  if (items > INT32_MAX || (int64_t)ns * TU > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  schedule_exec_global_kernel<T, U, TU><<<grid, kGlobalThreads, 0, stream>>>(
      static_cast<const U*>(in), static_cast<U*>(out), static_cast<U*>(work),
      static_cast<U*>(stage), tab, ntab, nloads, nstores, rounds, ns, L,
      chunk_len, (int)items, stage_rows);
  return (int)cudaGetLastError();
}

// L, chunk_len in elements of T; `vec` picks 16-byte units.
template <typename T>
int launch_global(const void* in, void* out, void* work, void* stage,
                  const int* tab, int ntab, int nloads, int nstores,
                  int rounds, int ns, int64_t L, int chunks, int grid,
                  int stage_rows, int vec, cudaStream_t stream) {
  constexpr int kPerVec = 16 / (int)sizeof(T);
  constexpr int kTileElems = 128 / (int)sizeof(T);
  if (vec)
    return launch_global_as<T, uint4, 8>(in, out, work, stage, tab, ntab,
                                         nloads, nstores, rounds, ns,
                                         L / kPerVec, chunks, grid,
                                         stage_rows, stream);
  return launch_global_as<T, T, kTileElems>(in, out, work, stage, tab, ntab,
                                            nloads, nstores, rounds, ns, L,
                                            chunks, grid, stage_rows, stream);
}


// ---- the gather body --------------------------------------------------
//
// Replaces, with the two bodies above: src/repro/core/pallas_lowering.py,
// PallasExec._kernel, for a schedule too tall for shared memory that has
// no reduce round (every neighbor and KV-transfer plan).
//
// What it computes: out[d] = in[src_of[d]] byte for byte, or all-zero
// bytes where src_of[d] = -1.  The host (core/kernel_lowering.py,
// _compose) folds pre, every round and post of a copy-only schedule into
// src_of and hands it over grouped by source (_gather_table), one int32
// table:
//   srcs    [nsrc]        the distinct input rows, ascending
//   offsets [nsrc + 1]    CSR offsets into dsts
//   dsts    [ns - nzero]  the output rows of each source
//   zeros   [nzero]       the output rows that take +0
// It moves bytes, so f32 and bf16 are one path and -0.0 passes through.
//
// Bound: bytes.  Every distinct input row read once and every output row
// written once, (nsrc + ns) x row bytes: no stage, no scratch, no rounds,
// `out` written once.  The round-by-round global body moved as many
// bytes as a copy, but as 128-byte column strips of every row at a row's
// stride from the next, its phases serial within a CTA.
//
// Design (sm_90a):
//   * Items: a segment of kGatherSeg bytes of one source row or, where
//     rows are shorter, a run of consecutive sources whose rows fit one
//     segment, in ascending source order.  A persistent grid of one CTA
//     per SM; blocks of kGatherBlock consecutive items are dealt to the
//     CTAs in turn, so the grid's reads sweep device memory together.
//     On the H100 this setting ran the KV batches fastest of those tried
//     in bring-up (segment bytes, ring depth, CTAs per SM, how the items
//     are dealt), at about a copy's rate; one contiguous range of items
//     a CTA was markedly slower.
//   * One elected thread runs a ring of kGatherBufs segment buffers in
//     shared memory, an mbarrier each: a 1-D bulk load (cp.async.bulk, no
//     tensor map) brings an item in, completion counted in bytes; once it
//     has arrived, one bulk store per destination row of each source
//     leaves from the buffer (one bulk group per item); a buffer is
//     refilled, one item behind, once the stores of its item have read it
//     (wait_group.read 1), so the loads of later items stay in flight
//     while earlier stores drain.  Rows that take +0 are stored from one
//     zeroed buffer.
//   * Rows whose byte length is no multiple of 16, or buffers off 16
//     bytes, cannot go through a bulk copy: they take the ragged path of
//     the same launch, every thread copying 4- or 2-byte units (the widest
//     the rows and buffers allow; f32 and bf16 rows are whole 2-byte
//     units), each source unit read once and written to every destination
//     row.

constexpr int kGatherThreads = 128;
constexpr int kGatherSeg = 32768;         // bytes of a segment
constexpr int kGatherBufs = 4;            // the ring's buffers
constexpr int kGatherCtasPerSm = 1;       // the bulk path's grid
constexpr int kGatherRaggedCtasPerSm = 8;
constexpr int kGatherBlock = 2;           // items a CTA takes in a row
constexpr int kGatherBarBytes = 128;      // the ring's mbarriers, padded
// the ring and the zeroed buffer
constexpr size_t kGatherSmem =
    kGatherBarBytes + (size_t)(kGatherBufs + 1) * kGatherSeg;
static_assert(kGatherSmem <= (size_t)kSmemMax, "the ring exceeds a CTA");
static_assert(kGatherBufs * 8 <= kGatherBarBytes, "the mbarriers");

// How the rows split into items.
struct GatherItems {
  int64_t row_bytes;
  int per_item;       // rows an item holds (1 where a row spans segments)
  int segs;           // segments a row (1 where an item holds many rows)
  int64_t src_items;  // items over the sources; the zero rows' follow
  int64_t items;
};

// One item: rows [k0, k1) of srcs (or of zeros), the segment's byte
// offset in a row and its length.
struct GatherItem {
  int k0, k1;
  int64_t off;
  uint32_t len;
  bool zero;
};

__device__ __forceinline__ GatherItem gather_item(const GatherItems& g,
                                                  int64_t it, int nsrc,
                                                  int nzero) {
  GatherItem r;
  r.zero = it >= g.src_items;
  if (r.zero) it -= g.src_items;
  const int64_t grp = it / g.segs;
  r.k0 = (int)(grp * g.per_item);
  r.k1 = min(r.k0 + g.per_item, r.zero ? nzero : nsrc);
  r.off = (it - grp * g.segs) * kGatherSeg;
  const int64_t rest = g.row_bytes - r.off;
  r.len = (uint32_t)(rest < kGatherSeg ? rest : kGatherSeg);
  return r;
}

// A 1-D bulk copy of `bytes` from device memory into shared memory,
// completion counted in bytes on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// A 1-D bulk copy of `bytes` from shared memory out to device memory (in
// the current bulk group).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src),
                  "r"(bytes)
               : "memory");
}

// Wait until every bulk group but the newest has read its shared memory.
__device__ __forceinline__ void bulk_wait_read_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

// U: the ragged path's unit (uint32_t or uint16_t); the bulk path moves
// bytes and ignores it.
template <typename U>
__global__ void __launch_bounds__(kGatherThreads)
schedule_exec_gather_kernel(const unsigned char* __restrict__ in,
                            unsigned char* __restrict__ out,
                            const int* __restrict__ gtab, int nsrc, int nzero,
                            int ns, const GatherItems g, int bulk) {
  const int* srcs = gtab;
  const int* offs = gtab + nsrc;
  const int* dsts = offs + nsrc + 1;
  const int* zeros = dsts + (ns - nzero);
  const int tid = threadIdx.x;
  // this CTA's items: item_of(j) for j < count, the source items first
  const int64_t G = gridDim.x, B = blockIdx.x, K = kGatherBlock;
  auto item_of = [&](int64_t j) { return ((j / K) * G + B) * K + j % K; };
  auto below = [&](int64_t limit) {     // this CTA's items under `limit`
    const int64_t nb = limit / K, rem = limit - nb * K;
    int64_t c = nb > B ? (nb - B + G - 1) / G * K : 0;
    if (rem && nb % G == B) c += rem;
    return c;
  };
  const int64_t count = below(g.items);
  const int64_t n = below(g.src_items);
  if (count == 0) return;

  if (!bulk) {
    // ragged path: every thread, one unit at a time
    const int64_t row_units = g.row_bytes / (int64_t)sizeof(U);
    const U* uin = reinterpret_cast<const U*>(in);
    U* uout = reinterpret_cast<U*>(out);
    for (int64_t j = 0; j < count; ++j) {
      const GatherItem r = gather_item(g, item_of(j), nsrc, nzero);
      const int upr = (int)(r.len / sizeof(U));
      const int64_t col0 = r.off / (int64_t)sizeof(U);
      const int total = (r.k1 - r.k0) * upr;
      for (int idx = tid; idx < total; idx += kGatherThreads) {
        const int kk = idx / upr;
        const int k = r.k0 + kk;
        const int64_t col = col0 + (idx - kk * upr);
        if (r.zero) {
          uout[(int64_t)__ldg(zeros + k) * row_units + col] = U{};
          continue;
        }
        const U v = uin[(int64_t)__ldg(srcs + k) * row_units + col];
        const int e1 = __ldg(offs + k + 1);
        for (int e = __ldg(offs + k); e < e1; ++e)
          uout[(int64_t)__ldg(dsts + e) * row_units + col] = v;
      }
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char gsmem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(gsmem);
  unsigned char* bufs = gsmem + kGatherBarBytes;
  unsigned char* zbuf = bufs + (size_t)kGatherBufs * kGatherSeg;
  if (nzero) {
    uint4* z = reinterpret_cast<uint4*>(zbuf);
    for (int i = tid; i < kGatherSeg / 16; i += kGatherThreads)
      z[i] = make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }
  if (tid == 0) {
    for (int b = 0; b < kGatherBufs; ++b) mbar_init(smem_addr(&bars[b]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid != 0) return;

  // zero rows: stores from the zeroed buffer
  const uint32_t zaddr = smem_addr(zbuf);
  for (int64_t j = n; j < count; ++j) {
    const GatherItem r = gather_item(g, item_of(j), nsrc, nzero);
    for (int k = r.k0; k < r.k1; ++k)
      bulk_store(out + (int64_t)__ldg(zeros + k) * g.row_bytes + r.off, zaddr,
                 r.len);
  }
  bulk_commit();

  // source items j = 0 .. n-1, buffer j % kGatherBufs
  auto load = [&](int64_t j) {
    const int b = (int)(j % kGatherBufs);
    const GatherItem r = gather_item(g, item_of(j), nsrc, nzero);
    const uint32_t bar = smem_addr(&bars[b]);
    const uint32_t dst = smem_addr(bufs + (size_t)b * kGatherSeg);
    mbar_arrive_tx(bar, (uint32_t)(r.k1 - r.k0) * r.len);
    for (int k = r.k0; k < r.k1; ++k)
      bulk_load(dst + (uint32_t)(k - r.k0) * r.len,
                in + (int64_t)__ldg(srcs + k) * g.row_bytes + r.off, r.len,
                bar);
  };
  for (int64_t j = 0; j < n && j < kGatherBufs; ++j) load(j);
  for (int64_t j = 0; j < n; ++j) {
    const int b = (int)(j % kGatherBufs);
    mbar_wait(smem_addr(&bars[b]), (uint32_t)((j / kGatherBufs) & 1));
    const GatherItem r = gather_item(g, item_of(j), nsrc, nzero);
    const uint32_t src = smem_addr(bufs + (size_t)b * kGatherSeg);
    for (int k = r.k0; k < r.k1; ++k) {
      const int e1 = __ldg(offs + k + 1);
      for (int e = __ldg(offs + k); e < e1; ++e)
        bulk_store(out + (int64_t)__ldg(dsts + e) * g.row_bytes + r.off,
                   src + (uint32_t)(k - r.k0) * r.len, r.len);
    }
    bulk_commit();
    // refill the previous item's buffer once its stores have read it
    if (j >= 1 && j - 1 + kGatherBufs < n) {
      bulk_wait_read_but_one();
      load(j - 1 + kGatherBufs);
    }
  }
  bulk_wait_all();
}

template <typename U>
int launch_gather_as(const void* in, void* out, const int* gtab, int nsrc,
                     int nzero, int ns, const GatherItems& g, int bulk,
                     size_t smem, int* info, cudaStream_t stream) {
  auto kern = schedule_exec_gather_kernel<U>;
  // opt in to kSmemMax of dynamic shared memory once per device, and
  // cache the occupancy of the last footprint
  static bool opted[64] = {};
  static size_t occ_smem[64] = {};
  static int occ[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
    occ_smem[dev] = ~(size_t)0;
    opted[dev] = true;
  }
  if (occ_smem[dev] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], kern,
                                                        kGatherThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ[dev] < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem[dev] = smem;
  }
  const int cap = bulk ? kGatherCtasPerSm : kGatherRaggedCtasPerSm;
  const int per_sm = occ[dev] < cap ? occ[dev] : cap;
  const int64_t slots = (int64_t)sms[dev] * per_sm;
  const int grid = (int)(g.items < slots ? g.items : slots);
  if (info) {
    info[0] = grid;
    info[1] = per_sm;
    info[2] = bulk;
    info[3] = kGatherSeg;
    info[4] = kGatherBufs;
  }
  if (grid < 1) return 0;
  kern<<<grid, kGatherThreads, smem, stream>>>(
      static_cast<const unsigned char*>(in), static_cast<unsigned char*>(out),
      gtab, nsrc, nzero, ns, g, bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  load/store_classes: bit k is set
// when some copy moves a box of 2^k rows.  info (host, optional)
// receives the grid, the resident CTAs per SM and whether the aligned
// TMA path ran.
extern "C" int repro_schedule_exec(
    int dtype, const void* in, void* out, const int* tab, int ntab,
    int nloads, int nstores, int load_classes, int store_classes, int rounds,
    int ns, int64_t L, int chunks, int tile, int nbuf, int stage_rows,
    int nlive, int* info, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(in, out, tab, ntab, nloads, nstores,
                                 load_classes, store_classes, rounds, ns, L,
                                 chunks, tile, nbuf, stage_rows, nlive, info,
                                 st);
    case 1: return launch<__nv_bfloat16>(in, out, tab, ntab, nloads, nstores,
                                         load_classes, store_classes, rounds,
                                         ns, L, chunks, tile, nbuf,
                                         stage_rows, nlive, info, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The global-memory body.  work is out itself when the post order is the
// identity, else a scratch [ns, L]; stage holds grid x stage_rows tiles of
// 128 bytes (16-byte units) or of 128 / sizeof(T) elements.  info (host,
// optional) receives whether the 16-byte path ran.
extern "C" int repro_schedule_exec_global(
    int dtype, const void* in, void* out, void* work, void* stage,
    const int* tab, int ntab, int nloads, int nstores, int rounds, int ns,
    int64_t L, int chunks, int grid, int stage_rows, int* info,
    void* stream) {
  if (chunks < 1 || L % chunks || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem = dtype == 0 ? 4 : 2;
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (L / chunks * elem) % 16 == 0 && al(in) && al(out)
      && al(work) && (stage_rows == 0 || al(stage));
  if (info) info[0] = vec;
  switch (dtype) {
    case 0: return launch_global<float>(in, out, work, stage, tab, ntab,
                                        nloads, nstores, rounds, ns, L,
                                        chunks, grid, stage_rows, vec, st);
    case 1: return launch_global<__nv_bfloat16>(
        in, out, work, stage, tab, ntab, nloads, nstores, rounds, ns, L,
        chunks, grid, stage_rows, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gather body of a copy-only schedule.  gtab is the table above
// (srcs, offsets, dsts, zeros); row_bytes the bytes of one row (the
// slot's payload, a whole number of 2-byte units).  info (host, optional)
// receives the grid, the CTAs per SM, whether the bulk path ran, the
// segment bytes and the ring's buffers.
extern "C" int repro_schedule_exec_gather(
    const void* in, void* out, const int* gtab, int nsrc, int nzero, int ns,
    int64_t row_bytes, int* info, void* stream) {
  if (row_bytes < 1 || nsrc < 0 || nzero < 0 || nzero > ns)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto al = [&](int a) {
    return row_bytes % a == 0 && reinterpret_cast<uintptr_t>(in) % a == 0
        && reinterpret_cast<uintptr_t>(out) % a == 0;
  };
  GatherItems g;
  g.row_bytes = row_bytes;
  if (row_bytes >= kGatherSeg) {
    g.per_item = 1;
    g.segs = (int)((row_bytes + kGatherSeg - 1) / kGatherSeg);
  } else {
    g.per_item = (int)(kGatherSeg / row_bytes);
    g.segs = 1;
  }
  g.src_items = (int64_t)((nsrc + g.per_item - 1) / g.per_item) * g.segs;
  g.items = g.src_items
      + (int64_t)((nzero + g.per_item - 1) / g.per_item) * g.segs;
  if (al(16))
    return launch_gather_as<uint32_t>(
        in, out, gtab, nsrc, nzero, ns, g, 1,
        nzero ? kGatherSmem : kGatherSmem - kGatherSeg, info, st);
  if (al(4))
    return launch_gather_as<uint32_t>(in, out, gtab, nsrc, nzero, ns, g, 0,
                                      0, info, st);
  if (al(2))
    return launch_gather_as<uint16_t>(in, out, gtab, nsrc, nzero, ns, g, 0,
                                      0, info, st);
  return (int)cudaErrorInvalidValue;
}
