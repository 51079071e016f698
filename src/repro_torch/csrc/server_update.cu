// server_update: the fused server round close, for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/server_update/kernel.py
// (Pallas): server_update_flat, over an f32/bf16 delta plane, and
// dequant_update_flat, over a compressed int8/bf16 uplink plane.  In one
// pass over the (C, P) cohort plane it computes, per plane column j,
//
//     d_{c,j} = Δ_{c,j}                 (server_update_launch)
//     d_{c,j} = scale_c · q_{c,j}       (dequant_update_launch)
//     mean_j  = Σ_c wn_c · d_{c,j}                 (c ascending)
//     m'_j    = c_mm·m_j + c_md·(γ·mean_j)          (if WRITE_M)
//     x'_j    = x_j + c_xd·(γ·mean_j)               (if WRITE_X)
//
// with coefs = (c_mm, c_md, c_xd, γ), wn and scale read from DEVICE f32
// arrays, so the per-round c_md = −1/(η_l·K) never changes the launch.
// mean is emitted in f32 and undiscounted.  WRITE_X / WRITE_M are
// template flags that drop both the read and the write of x or m.  One
// template serves both entry points: it is templated on the plane dtype
// (f32 or bf16 deltas; int8 or bf16 compressed q), on SCALED (dequantize
// by the per-row scale) and on the momentum dtype (m and m' share it);
// x carries a runtime dtype flag.
//
// Bound on an H100 SXM: memory-bound, 2 flops per plane element read (3
// when dequantizing).  The least bytes are the plane once, wn (and
// scale), x and m once, and x', m', mean once; at the main path's (C, P) =
// (25, 22026): f32 deltas 2.6 MB, 0.8 µs at 3.35 TB/s; int8 q 0.99 MB,
// 0.3 µs — both below what one launch of this size takes on the card.
//
// Design.  The launch plan (tile, rows, stages, grid, shared bytes) is
// computed in Python, kernels/server_update/kernel.py :: fold_plan, and
// only checked here.
//
// * Persistent column tiles.  A block owns a tile of `tile` columns and
//   walks tiles blockIdx.x, + gridDim.x, ...  At the main plane the plan
//   picks the least tile that makes one wave of tiles on the card's SMs;
//   at a large plane, tiles of 4 KB rows (2 KB for int8), since the
//   bulk-copy engine's cost is per copy.
// * A shared-memory ring fed by the bulk-copy engine.  A tile's rows are
//   cut into groups of `rows`; a (tile, group) item fills one stage of a
//   ring of `stages`, one 1-D cp.async.bulk per row, completing on the
//   stage's `full` mbarrier with the exact byte count announced.  The
//   first `stages` items are staged by the whole block (copies spread over
//   its warps); then two producer warps refill stages as the 8 consumer
//   warps release them (`empty` mbarriers), alternating items.  Each
//   consumer thread folds its columns of a stage's rows in ascending c,
//   carrying each column's sum across groups in a shared f32 tile, so the
//   sum order is the plain version's for any C.  The group's wn and scale
//   values go to a shared table while its rows are in flight.
// * Aligned row windows.  Plane rows lie P·itemsize bytes apart (at the
//   main plane only 8, 4 or 2-byte aligned), so 2-D tensor maps (16-byte
//   strides) are out.  Each row copies the 16-byte aligned window around
//   its segment [j0, j0 + n) into a slot of tile·itemsize + 16 bytes and
//   is read at the segment's offset in the window.  The part of a window
//   outside the plane's own 16-byte aligned interior (the head before a
//   misaligned base, the tail after a misaligned end) is clipped and those
//   plane bytes are loaded element by element: nothing outside the plane
//   is read.  kernel.py :: row_window mirrors row_window below, and
//   tests/test_torch_fold_plan.py replays it byte by byte.
// * Wide traffic outside the plane.  x, m, x', m' and mean move in chunks
//   of 8 columns framed on each output's 16-byte boundaries: 16-byte
//   accesses where a chunk is whole (and its input aligned too), element
//   by element at a ragged head or tail.  The producer prefetches a tile's
//   x and m windows into L2 with its first group (cp.async.bulk.prefetch),
//   so the epilogue reads them at L2 latency.
//
// Shared memory: 128 bytes of mbarriers, two f32 column tiles (by tile
// parity: the running sums, then the mean the epilogue reads), two wn and
// scale tables (by item parity), then stages × rows slots of
// tile·itemsize + 16 bytes.
//
// No atomics and no cross-block pass: each column's sum runs in one thread
// in a fixed order, so the output is bitwise run-to-run deterministic.
// Products and sums use __fmul_rn/__fadd_rn: no FMA contraction, so the
// kernel rounds exactly as the plain PyTorch version (ref.py), which
// computes d = q·scale, then d·wn, then the ascending sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"
#include "tensor_core.cuh"

namespace {

// Mirrored by kernels/server_update/kernel.py (CONSUMERS, MAX_TILE,
// MAX_STAGES, BARRIER_BYTES).
constexpr int kConsumers = 256;  // threads that fold
constexpr int kProducers = 2;    // warps that refill the ring, alternate items
constexpr int kThreads = kConsumers + 32 * kProducers;
constexpr int kMaxCols = 8;      // columns of a tile a consumer folds
constexpr int kMaxTile = kMaxCols * kConsumers;
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;
constexpr int kChunk = 8;

typedef unsigned long long u64;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One plane element from shared memory, as f32.  An int8 q becomes the f32
// 2^23 + 128 + q by bit operations and comes back by one exact
// subtraction: the value of a conversion, on the integer and f32 pipes.
__device__ __forceinline__ float plane_f32(const float* p) { return *p; }
__device__ __forceinline__ float plane_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float plane_f32(const int8_t* p) {
  const uint32_t u = *reinterpret_cast<const uint8_t*>(p);
  return __fsub_rn(__uint_as_float(0x4B000000u | (u ^ 0x80u)), 8388736.0f);
}

// 8 consecutive values at a 16-byte aligned address, as f32, and back.
__device__ __forceinline__ void load8(const float* src, float (&v)[kChunk]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[kChunk]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = tc::unpack_bf16x2(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[kChunk]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[kChunk]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(tc::pack_bf16x2(v[0], v[1]), tc::pack_bf16x2(v[2], v[3]),
                                              tc::pack_bf16x2(v[4], v[5]), tc::pack_bf16x2(v[6], v[7]));
}

// A chunk: the columns k0 .. k0 + 7 of a tile of n columns starting at
// `base` (k0 may be negative in a head chunk).  A whole chunk at a 16-byte
// aligned address moves as 16-byte accesses; otherwise element by element,
// columns outside [0, n) skipped (read as 0).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* base, int k0, int n, float (&v)[kChunk]) {
  if (k0 >= 0 && k0 + kChunk <= n && (reinterpret_cast<u64>(base + k0) & 15) == 0) {
    load8(base + k0, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    const int k = k0 + e;
    v[e] = (k >= 0 && k < n) ? to_f32<T>(base[k]) : 0.f;
  }
}
template <typename T>
__device__ __forceinline__ void store_chunk(T* base, int k0, int n, const float (&v)[kChunk]) {
  if (k0 >= 0 && k0 + kChunk <= n && (reinterpret_cast<u64>(base + k0) & 15) == 0) {
    store8(base + k0, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    const int k = k0 + e;
    if (k >= 0 && k < n) base[k] = from_f32<T>(v[e]);
  }
}

// The chunk frame of an output: chunk q covers columns q·8 − head ...,
// head = the output's misalignment in elements, so every whole chunk of
// the output is 16-byte aligned (tiles start at multiples of 16 columns:
// every tile has the launch's frame).
__device__ __forceinline__ int head_of(const void* out, int itemsize) {
  return static_cast<int>(reinterpret_cast<u64>(out) & 15) / itemsize;
}

// The bulk-copied part [lo, hi) of a row segment's bytes [a, b): the
// 16-byte aligned window [w0, w1) around them, clipped to its array's
// aligned interior [base16, end16).  Empty when hi <= lo.  The segment's
// bytes outside [lo, hi) — fewer than 32 — are loaded one by one.  The
// row's slot holds the byte at address q at offset q − w0.  Mirrored by
// kernel.py :: row_window.
struct Window {
  u64 w0, lo, hi;
};
__device__ __forceinline__ Window row_window(u64 a, u64 b, u64 base16, u64 end16) {
  const u64 w0 = a & ~u64(15);
  const u64 w1 = (b + 15) & ~u64(15);
  return {w0, w0 > base16 ? w0 : base16, w1 < end16 ? w1 : end16};
}

// The plane elements at byte addresses [q0, q1) (fewer than 16 bytes) into
// dst: every load is issued before the first store, so they wait out one
// latency together.
template <typename TD>
__device__ __forceinline__ void copy_elems(unsigned char* dst, u64 q0, u64 q1) {
  typedef typename std::conditional<sizeof(TD) == 4, uint32_t,
          typename std::conditional<sizeof(TD) == 2, uint16_t, uint8_t>::type>::type W;
  constexpr int kMax = 16 / sizeof(TD);
  const int ne = static_cast<int>((q1 - q0) / sizeof(TD));
  const W* src = reinterpret_cast<const W*>(q0);
  W v[kMax];
#pragma unroll
  for (int e = 0; e < kMax; ++e)
    if (e < ne) v[e] = __ldg(src + e);
#pragma unroll
  for (int e = 0; e < kMax; ++e)
    if (e < ne) reinterpret_cast<W*>(dst)[e] = v[e];
}

// The bytes [q0, q1) (fewer than 32) of an array of TD into slot[q − w0].
template <typename TD>
__device__ __forceinline__ void copy_range(unsigned char* slot, u64 w0, u64 q0, u64 q1) {
  for (; q0 < q1; q0 += 16) copy_elems<TD>(slot + (q0 - w0), q0, q1 - q0 < 16 ? q1 : q0 + 16);
}

struct FoldParams {
  float* mean;
  void* new_x;
  void* new_m;
  const void* plane;
  const float* scale;
  const float* wn;
  const void* x;
  const void* m;
  const float* coefs;
  long long P;
  int C;
  int x_bf16;
  // the launch plan (kernel.py :: fold_plan)
  int tile, rows, stages, grid, smem;
  // from the plan, on the host: ceil(P / tile) tiles of ceil(C / rows) groups
  long long tiles;
  int groups;
};

__host__ __device__ __forceinline__ int slot_bytes(int tile, int itemsize) {
  return tile * itemsize + 16;
}

// Two tables (by item parity) of a row group's wn and scale values, f32.
__host__ __device__ __forceinline__ int weights_bytes(int rows) { return 16 * rows; }

// An array's first byte and its 16-byte aligned interior.
struct Span {
  u64 beg, base16, end16;
};
__device__ __forceinline__ Span span_of(const void* p, u64 bytes) {
  const u64 beg = reinterpret_cast<u64>(p);
  return {beg, (beg + 15) & ~u64(15), (beg + bytes) & ~u64(15)};
}

// One (tile, row group) item of a block's walk.
struct Item {
  long long j0;  // the tile's first column
  int n;         // its columns
  int r0, nr;    // the group's plane rows
};
__device__ __forceinline__ Item item_of(const FoldParams& p, long long t, int g) {
  Item it;
  it.j0 = t * p.tile;
  it.n = static_cast<int>(min(static_cast<long long>(p.tile), p.P - it.j0));
  it.r0 = g * p.rows;
  it.nr = min(p.rows, p.C - it.r0);
  return it;
}

// A row segment to stage: bytes [a, b) of the plane, into `slot`.
struct Segment {
  u64 a, b;
  unsigned char* slot;
};

// Stage item `it` into `stage`, completing on `full`, by a team of `team`
// threads, the caller being `rank`: row v by rank v % team, so the
// addresses are computed in parallel and each warp's copies go out in one
// short loop.  Each warp announces its bytes once, before its copies; the
// caller then orders each warp's edge stores (__syncwarp) before that
// warp's arrival: `full` expects one a warp of the block, which a lone
// producer warp makes as one arrival of that count.
template <typename TD>
__device__ __forceinline__ void produce(const FoldParams& p, unsigned char* stage, uint64_t* full,
                                        const Item& it, int rank, int team, const Span& plane) {
  const int slot = slot_bytes(p.tile, sizeof(TD));
  auto segment = [&](int v) -> Segment {
    const u64 a = plane.beg + (static_cast<u64>(it.r0 + v) * p.P + it.j0) * sizeof(TD);
    return {a, a + static_cast<u64>(it.n) * sizeof(TD), stage + v * slot};
  };
  uint32_t bytes = 0;
  for (int v = rank; v < it.nr; v += team) {
    const Segment sg = segment(v);
    const Window w = row_window(sg.a, sg.b, plane.base16, plane.end16);
    if (w.hi > w.lo) bytes += static_cast<uint32_t>(w.hi - w.lo);
  }
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if ((threadIdx.x & 31) == 0 && bytes > 0) bulk::expect_tx(full, bytes);
  __syncwarp();
  for (int v = rank; v < it.nr; v += team) {
    const Segment sg = segment(v);
    const Window w = row_window(sg.a, sg.b, plane.base16, plane.end16);
    if (w.hi > w.lo) {
      bulk::copy_g2s(sg.slot + (w.lo - w.w0), reinterpret_cast<const void*>(w.lo),
                     static_cast<uint32_t>(w.hi - w.lo), full);
      if (sg.a >= w.lo && sg.b <= w.hi) continue;  // no edge: the common case
      copy_range<TD>(sg.slot, w.w0, sg.a, sg.b < w.lo ? sg.b : w.lo);  // head, misaligned base
      copy_range<TD>(sg.slot, w.w0, sg.a > w.hi ? sg.a : w.hi, sg.b);  // tail, misaligned end
    } else {
      copy_range<TD>(sg.slot, w.w0, sg.a, sg.b);
    }
  }
}

// x's or m's window for the columns of a tile, into L2 ahead of the
// epilogue (its misaligned edges, if any, are left to the loads).
__device__ __forceinline__ void prefetch_window(const Span& sp, long long j0, int n, int itemsize) {
  const u64 a = sp.beg + static_cast<u64>(j0) * itemsize;
  const Window w = row_window(a, a + static_cast<u64>(n) * itemsize, sp.base16, sp.end16);
  if (w.hi > w.lo)
    bulk::prefetch_l2(reinterpret_cast<const void*>(w.lo), static_cast<uint32_t>(w.hi - w.lo));
}

// The consumer warps' own barrier (id 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Fold the nr rows of a stage into this thread's NC columns (ct +
// c·kConsumers) of the tile's running sums, rows ascending.  `off` is the
// first row's byte offset in its slot (its address mod 16); each next
// row's is row_step (row bytes mod 16) further.  ws / ss: the rows' wn and
// scale values, staged with them.
template <int NC, typename TD, bool SCALED>
__device__ __forceinline__ void fold_rows(float* sums, const unsigned char* stage, int slot,
                                          int off, int row_step, const float* ws,
                                          const float* ss, int nr, int ct, int n, bool first) {
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int k = ct + c * kConsumers;
    acc[c] = (first || k >= n) ? 0.f : sums[k];
  }
#pragma unroll 4
  for (int cc = 0; cc < nr; ++cc) {
    const TD* row = reinterpret_cast<const TD*>(stage + cc * slot + off);
    off = (off + row_step) & 15;
    const float w = ws[cc];
    const float sc = SCALED ? ss[cc] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = ct + c * kConsumers;
      if (k < n) {
        float d = plane_f32(row + k);
        if (SCALED) d = __fmul_rn(d, sc);
        acc[c] = __fadd_rn(acc[c], __fmul_rn(d, w));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int k = ct + c * kConsumers;
    if (k < n) sums[k] = acc[c];
  }
}

// x's values of a chunk (x has a runtime dtype).
__device__ __forceinline__ void load_x(const FoldParams& p, long long j0, int k0, int n,
                                       float (&in)[kChunk]) {
  if (p.x_bf16)
    load_chunk(static_cast<const __nv_bfloat16*>(p.x) + j0, k0, n, in);
  else
    load_chunk(static_cast<const float*>(p.x) + j0, k0, n, in);
}

// The epilogue of a tile: chunks q = ct, ct + 256 (a tile of 2048 columns
// has up to 257 chunks of 8 columns, each framed on its output's 16-byte
// boundaries) of mean, x' and m'.  x and m come from L2, where the
// producer prefetched them with the tile's first group.
template <typename TM, bool WRITE_X, bool WRITE_M>
__device__ __forceinline__ void epilogue(const FoldParams& p, const float* sums, long long j0,
                                         int n, int ct, int head_mean, int head_x, int head_m,
                                         float gamma, float c_mm, float c_md, float c_xd) {
  for (int q = ct; q * kChunk - kChunk < n; q += kConsumers) {
    float v[kChunk], in[kChunk];
    int k0 = q * kChunk - head_mean;
    if (k0 < n) {
      load_chunk(sums, k0, n, v);
      store_chunk(p.mean + j0, k0, n, v);
    }
    if (WRITE_X && (k0 = q * kChunk - head_x) < n) {
      load_chunk(sums, k0, n, v);
      load_x(p, j0, k0, n, in);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) v[e] = __fadd_rn(in[e], __fmul_rn(c_xd, __fmul_rn(gamma, v[e])));
      if (p.x_bf16)
        store_chunk(static_cast<__nv_bfloat16*>(p.new_x) + j0, k0, n, v);
      else
        store_chunk(static_cast<float*>(p.new_x) + j0, k0, n, v);
    }
    if (WRITE_M && (k0 = q * kChunk - head_m) < n) {
      load_chunk(sums, k0, n, v);
      load_chunk(static_cast<const TM*>(p.m) + j0, k0, n, in);
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        v[e] = __fadd_rn(__fmul_rn(c_mm, in[e]), __fmul_rn(c_md, __fmul_rn(gamma, v[e])));
      store_chunk(static_cast<TM*>(p.new_m) + j0, k0, n, v);
    }
  }
}

template <typename TD, typename TM, bool SCALED, bool WRITE_X, bool WRITE_M>
__global__ void __launch_bounds__(kThreads, 2) fold_kernel(const __grid_constant__ FoldParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* sums2 = reinterpret_cast<float*>(smem + kBarrierBytes);
  float* weights2 = sums2 + 2 * p.tile;  // two (wn, scale) row tables, by item parity
  unsigned char* ring = smem + kBarrierBytes + p.tile * 8 + weights_bytes(p.rows);
  const int slot = slot_bytes(p.tile, sizeof(TD));
  const int sbytes = p.rows * slot;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const long long tiles = p.tiles;
  const int groups = p.groups;
  if (blockIdx.x >= tiles) return;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      bulk::init(&full[s], kThreads / 32);  // one arrival a warp of the block
      bulk::init(&empty[s], kConsumers / 32);
    }
    bulk::fence_init();
  }
  __syncthreads();

  const int x_size = p.x_bf16 ? 2 : 4;
  const Span plane = span_of(p.plane, static_cast<u64>(p.C) * static_cast<u64>(p.P) * sizeof(TD));

  // Every role walks the same items: tiles blockIdx.x, + gridDim.x, ...,
  // each in row groups; item k takes stage k % stages, whose phase parity
  // flips each time the ring wraps.  The first `stages` items are staged
  // by the whole block, row v by warp v % warps (at the main plane each
  // warp issues two or three copies, and arrives for itself: no block
  // barrier); then producer warp k % 2 refills the stage of item k as the
  // consumers release it.
  int first = 0;
  for (long long t = blockIdx.x; t < tiles && first < p.stages; t += gridDim.x)
    for (int g = 0; g < groups && first < p.stages; ++g, ++first)
      produce<TD>(p, ring + first * sbytes, &full[first], item_of(p, t, g),
                  lane * (kThreads / 32) + warp, kThreads, plane);
  __syncwarp();  // the warp's edge stores, before its arrivals
  if (lane == 0)
    for (int s = 0; s < first; ++s) bulk::arrive(&full[s], 1);

  if (warp < kProducers) {
    const Span xs = span_of(p.x, static_cast<u64>(p.P) * x_size);
    const Span ms = span_of(p.m, static_cast<u64>(p.P) * sizeof(TM));
    int s = 0, k = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      for (int g = 0; g < groups; ++g, ++k) {
        if (k % kProducers == warp) {
          const Item it = item_of(p, t, g);
          if (lane == 0 && g == 0) {  // the tile's x and m, on their way to L2
            if (WRITE_X) prefetch_window(xs, it.j0, it.n, x_size);
            if (WRITE_M) prefetch_window(ms, it.j0, it.n, sizeof(TM));
          }
          if (k >= p.stages) {
            bulk::wait(&empty[s], phase ^ 1u);
            bulk::fence_proxy_async();  // the consumers' reads of the stage come first
            produce<TD>(p, ring + s * sbytes, &full[s], it, lane, 32, plane);
            __syncwarp();  // the warp's edge stores, before the arrival
            if (lane == 0) bulk::arrive(&full[s], kThreads / 32);
          }
        }
        if (++s == p.stages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  const int ct = tid - 32 * kProducers;  // consumer thread
  const float c_mm = p.coefs[0];
  const float c_md = p.coefs[1];
  const float c_xd = p.coefs[2];
  const float gamma = p.coefs[3];
  const int head_mean = head_of(p.mean, 4);
  const int head_x = WRITE_X ? head_of(p.new_x, x_size) : 0;
  const int head_m = WRITE_M ? head_of(p.new_m, sizeof(TM)) : 0;
  const int row_step = static_cast<int>((static_cast<u64>(p.P) * sizeof(TD)) & 15);

  int s = 0, parity = 0, item = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
    float* sums = sums2 + parity * p.tile;
    const long long j0 = t * p.tile;
    const int n = static_cast<int>(min(static_cast<long long>(p.tile), p.P - j0));
    const int cols = (n + kConsumers - 1) / kConsumers;
    for (int g = 0; g < groups; ++g, ++item) {
      const Item it = item_of(p, t, g);
      float* ws = weights2 + (item & 1) * 2 * p.rows;  // the group's wn, then scale, values
      for (int r = ct; r < it.nr; r += kConsumers) {
        ws[r] = __ldg(p.wn + it.r0 + r);
        if (SCALED) ws[p.rows + r] = __ldg(p.scale + it.r0 + r);
      }
      bulk::wait(&full[s], phase);
      consumers_sync();  // the weights are in
      const unsigned char* stage = ring + s * sbytes;
      const int off = static_cast<int>((plane.beg + static_cast<u64>(it.r0) * row_step) & 15);
      const float* ss = ws + p.rows;
      const bool fresh = g == 0;
      if (cols <= 1)
        fold_rows<1, TD, SCALED>(sums, stage, slot, off, row_step, ws, ss, it.nr, ct, n, fresh);
      else if (cols <= 2)
        fold_rows<2, TD, SCALED>(sums, stage, slot, off, row_step, ws, ss, it.nr, ct, n, fresh);
      else if (cols <= 4)
        fold_rows<4, TD, SCALED>(sums, stage, slot, off, row_step, ws, ss, it.nr, ct, n, fresh);
      else
        fold_rows<kMaxCols, TD, SCALED>(sums, stage, slot, off, row_step, ws, ss, it.nr, ct, n,
                                        fresh);
      __syncwarp();
      if ((ct & 31) == 0) bulk::arrive(&empty[s]);  // this warp is done with the stage
      if (++s == p.stages) {
        s = 0;
        phase ^= 1u;
      }
    }

    consumers_sync();  // the tile's sums are final: its mean
    epilogue<TM, WRITE_X, WRITE_M>(p, sums, j0, n, ct, head_mean, head_x, head_m, gamma, c_mm,
                                   c_md, c_xd);
  }
}

template <typename TD, typename TM, bool SCALED, bool WX, bool WM>
int launch(const FoldParams& a, int device, cudaStream_t stream) {
  const int e = tc::opt_in_smem<&fold_kernel<TD, TM, SCALED, WX, WM>>(device, a.smem);
  if (e != 0) return e;
  fold_kernel<TD, TM, SCALED, WX, WM><<<a.grid, kThreads, a.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TM, bool SCALED>
int dispatch_writes(int write_x, int write_m, const FoldParams& a, int device, cudaStream_t s) {
  if (write_x && write_m) return launch<TD, TM, SCALED, true, true>(a, device, s);
  if (write_x) return launch<TD, TM, SCALED, true, false>(a, device, s);
  if (write_m) return launch<TD, TM, SCALED, false, true>(a, device, s);
  return launch<TD, TM, SCALED, false, false>(a, device, s);
}

template <typename TD, bool SCALED>
int dispatch_m(int m_bf16, int write_x, int write_m, const FoldParams& a, int device,
               cudaStream_t s) {
  if (m_bf16) return dispatch_writes<TD, __nv_bfloat16, SCALED>(write_x, write_m, a, device, s);
  return dispatch_writes<TD, float, SCALED>(write_x, write_m, a, device, s);
}

// Shared prologue of both entry points: argument and plan check, device,
// the plan's tile and group counts.  Returns a CUDA error code, or -1 when
// the launch should go ahead.  The plan is kernel.py's; it is only checked
// to be one this kernel can run (a tile its consumers cover, shared memory
// for its stages).
int prepare(FoldParams& a, int itemsize, int device) {
  if (a.C <= 0 || a.P < 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.P == 0) return static_cast<int>(cudaGetLastError());
  const long long need = kBarrierBytes + 8LL * a.tile + weights_bytes(a.rows) +
                         static_cast<long long>(a.stages) * a.rows * slot_bytes(a.tile, itemsize);
  if (a.tile < 16 || a.tile > kMaxTile || a.tile % 16 != 0 || a.rows < 1 || a.stages < 1 ||
      a.stages > kMaxStages || a.grid < 1 || a.smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = (a.P + a.tile - 1) / a.tile;
  a.groups = (a.C + a.rows - 1) / a.rows;
  return -1;
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 =
// success).  The plane is contiguous (C, P); x, m, new_x, new_m and mean
// are (P,); pointers of skipped outputs (write_x / write_m = 0) may be
// null.  tile, rows, stages, grid and smem_bytes are the launch plan of
// kernel.py :: fold_plan for this (C, P, itemsize) on this device.

// deltas: f32 (d_bf16 = 0) or bf16 (d_bf16 = 1).
extern "C" int server_update_launch(
    float* mean, void* new_x, void* new_m, const void* deltas, const float* wn,
    const void* x, const void* m, const float* coefs, int C, long long P, int d_bf16,
    int m_bf16, int x_bf16, int write_x, int write_m, int tile, int rows, int stages, int grid,
    int smem_bytes, int device, void* stream) {
  FoldParams a{mean, new_x, new_m, deltas, nullptr, wn, x, m, coefs, P, C, x_bf16,
               tile, rows, stages, grid, smem_bytes, 0, 0};
  const int early = prepare(a, d_bf16 ? 2 : 4, device);
  if (early >= 0) return early;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_bf16) return dispatch_m<__nv_bfloat16, false>(m_bf16, write_x, write_m, a, device, s);
  return dispatch_m<float, false>(m_bf16, write_x, write_m, a, device, s);
}

// q: int8 (q_bf16 = 0) or bf16 (q_bf16 = 1); scale: (C,) f32 per-row
// dequant scale (all ones for a bf16 plane).
extern "C" int dequant_update_launch(
    float* mean, void* new_x, void* new_m, const void* q, const float* scale,
    const float* wn, const void* x, const void* m, const float* coefs, int C, long long P,
    int q_bf16, int m_bf16, int x_bf16, int write_x, int write_m, int tile, int rows,
    int stages, int grid, int smem_bytes, int device, void* stream) {
  FoldParams a{mean, new_x, new_m, q, scale, wn, x, m, coefs, P, C, x_bf16,
               tile, rows, stages, grid, smem_bytes, 0, 0};
  const int early = prepare(a, q_bf16 ? 2 : 1, device);
  if (early >= 0) return early;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) return dispatch_m<__nv_bfloat16, true>(m_bf16, write_x, write_m, a, device, s);
  return dispatch_m<int8_t, true>(m_bf16, write_x, write_m, a, device, s);
}

extern "C" const char* server_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
