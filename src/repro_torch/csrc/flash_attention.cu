// flash_attention: blocked online-softmax attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py ::
// flash_attention_bhsd (Pallas; body _attn_kernel).  Computes, for q
// (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) in the (B, S, H, hd) layout the
// model produces (read by strides: nothing is transposed in device memory),
//
//     out[b, i, h] = Σ_j softmax_j(scale · q[b, i, h] · k[b, j, h / G]) v[b, j, h / G]
//
// with G = H / Hkv (GQA), over the keys j that the masks keep: causal
// (q_offset + i ≥ j), sliding window (q_offset + i − j < window) and the
// ragged Sq / Skv edges.  A row that keeps no key gives 0, as the plain
// version (ref.py, the port of flash_attention_ref) does; the TPU kernel's
// finite −1e30 mask gives such a row the mean of V instead (ROADMAP queue
// C).  m, l and the accumulator are f32; l is floored at 1e-30; the output
// is rounded once into q's dtype (f32 or bf16; q, k, v share it).
//
// Bound on an H100 SXM: at the serving shape (B=4, S=1024, H=32, Hkv=8,
// hd=64, causal) the function reads 25 MB and writes 17 MB (12.5 µs at 3.35
// TB/s) but does 17 GFLOP of products (17 µs at the bf16 tensor-core peak),
// so it is bound by operations.  Both routes share the design against the
// bytes: the grid is (q tile, head, batch), the longest causal rows first;
// each block keeps its 64 q rows on chip and walks the KV tiles of 64 keys
// that its masks leave live (tiles wholly above the causal diagonal or
// outside the window are never loaded — the TPU kernel loaded them and
// skipped only their compute), so K and V are read once per q tile and the
// (Sq, Skv) scores never reach device memory.  Nothing carries across
// blocks: the TPU kernel's sequential KV grid axis is the loop inside the
// block.
//
// The bf16 route (attn_mma_kernel) runs FlashAttention-2's structure on the
// tensor cores (mma.sync m16n8k16, f32 accumulators; tensor_core.cuh has the
// fragment layouts).  4 warps, each owning 16 q rows; the Q tile is staged
// once as bf16 in shared memory and held in registers as A fragments for the
// whole KV loop.  K and V tiles arrive by 16-byte cp.async into a two-stage
// ring of bf16 tiles with padded rows, tile k+1 loading while tile k
// computes.  S = Q·Kᵀ; the masks and the online softmax act on the
// accumulator fragments (row max by quad shuffles, m and l in f32, l summed
// from the unrounded f32 P).  P is f32, so it enters P·V as two bf16
// pieces, P_hi + P_lo, repacked straight from the accumulator layout: one
// piece would move the bf16 output by several ulps, two keep it within the
// one-ulp tolerance (tests/test_torch_kernel_precision.py); q, k, v are bf16
// already and enter as they are.  V is read by ldmatrix.trans.  The output
// goes out through shared memory in 16-byte stores.  Shared memory: 45 KB
// (hd ≤ 64) or 85 KB (hd ≤ 128).  wgmma, TMA and warp specialisation
// (FlashAttention-3) are the next step.
//
// The f32 route (attn_f32_kernel) keeps its products on the f32 CUDA cores
// (TF32 would not hold the f32 tolerance): 256 threads, each owning 4 q rows
// × 4 keys of a score tile and 4 q rows × hd/16 output dims; Q and K stored
// transposed (d-major) and P key-major, so every inner-loop read is one
// float4; 65 KB (hd ≤ 64) or 113 KB (hd ≤ 128) of shared memory.
//
// Sums run in another order than the plain version's softmax and matrix
// products, so the two agree to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBKV = 64;         // keys per KV tile
constexpr int kThreads = 256;    // f32 route: 16 × 16, ty → 4 q rows, tx → 4 keys / output dims
constexpr int kPRow = kBKV + 4;  // f32 route: padded row of the P^T tile (fewer bank conflicts)
constexpr int kMmaThreads = 128; // bf16 route: 4 warps × 16 q rows

struct AttnArgs {
  void* out;
  const void* q;
  const void* k;
  const void* v;
  int B, Sq, Skv, H, Hkv, hd;
  int causal;
  int window;  // ≤ 0: no window
  int q_offset;
  float scale;
  int vec;     // bf16 route: hd % 8 == 0 and every pointer 16-byte aligned
};

constexpr size_t f32_smem_bytes(int hd_pad) {
  return sizeof(float) * (static_cast<size_t>(hd_pad) * kBQ + static_cast<size_t>(hd_pad) * kBKV +
                          static_cast<size_t>(kBKV) * hd_pad + static_cast<size_t>(kBKV) * kPRow);
}

// The f32 route.  HD: hd padded to 64 or 128 (zero-filled in shared memory).
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(AttnArgs a) {
  constexpr int kDG = HD / 64;  // float4 groups of output dims per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [HD][kBQ]     q^T
  float* kt = qt + HD * kBQ;                     // [HD][kBKV]    k^T
  float* vs = kt + HD * kBKV;                    // [kBKV][HD]    v
  float* pt = vs + kBKV * HD;                    // [kBKV][kPRow] p^T

  const int qtile = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = qtile * kBQ;
  const int hd = a.hd;

  const long long q_row = static_cast<long long>(a.H) * hd;     // elements between positions
  const long long kv_row = static_cast<long long>(a.Hkv) * hd;
  const float* qb = static_cast<const float*>(a.q) + static_cast<long long>(b) * a.Sq * q_row +
                static_cast<long long>(h) * hd;
  const float* kb = static_cast<const float*>(a.k) + static_cast<long long>(b) * a.Skv * kv_row +
                static_cast<long long>(hk) * hd;
  const float* vb = static_cast<const float*>(a.v) + static_cast<long long>(b) * a.Skv * kv_row +
                static_cast<long long>(hk) * hd;

  for (int idx = tid; idx < HD * kBQ; idx += kThreads) {
    const int r = idx % kBQ;
    const int d = idx / kBQ;
    const int row = q0 + r;
    qt[d * kBQ + r] = (row < a.Sq && d < hd) ? qb[row * q_row + d] : 0.f;
  }

  // KV range the masks leave live for any row of this tile
  const int last_row = min(q0 + kBQ, a.Sq) - 1;
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, last_row + a.q_offset + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, q0 + a.q_offset - a.window + 1);
  kv_begin = (kv_begin / kBKV) * kBKV;

  float m[4], l[4], acc[4][4 * kDG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kDG; ++e) acc[i][e] = 0.f;
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // the previous tile's K, V and P reads are done
    for (int idx = tid; idx < HD * kBKV; idx += kThreads) {
      const int c = idx % kBKV;
      const int d = idx / kBKV;
      const int key = kv0 + c;
      kt[d * kBKV + c] = (key < a.Skv && d < hd) ? kb[key * kv_row + d] : 0.f;
      const int vc = idx / HD;
      const int vd = idx % HD;
      const int vkey = kv0 + vc;
      vs[vc * HD + vd] = (vkey < a.Skv && vd < hd) ? vb[vkey * kv_row + vd] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qt[d * kBQ + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&kt[d * kBKV + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const int qpos = row + a.q_offset;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + tx * 4 + j;
        bool keep = row < a.Sq && key < a.Skv;
        if (a.causal) keep = keep && qpos >= key;
        if (a.window > 0) keep = keep && qpos - key < a.window;
        s[i][j] = keep ? s[i][j] * a.scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_use);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * kDG; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * kPRow + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();  // a row's P is written and read by the 16 threads of one warp

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&pt[c * kPRow + ty * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < kDG; ++g) {
        const float4 va = *reinterpret_cast<const float4*>(&vs[c * HD + g * 64 + tx * 4]);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g * 4 + e] = fmaf(pv[i], vv[e], acc[i][g * 4 + e]);
      }
    }
  }

  float* ob = static_cast<float*>(a.out) + static_cast<long long>(b) * a.Sq * q_row +
          static_cast<long long>(h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kDG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < hd) ob[row * q_row + d] = acc[i][g * 4 + e] / denom;
      }
  }
}

// The bf16 route.  HD: hd padded to 64 or 128 (zero-filled in shared memory).
template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 5 * kBQ * (HD + 8);  // Q, K[2], V[2]
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads) attn_mma_kernel(AttnArgs a) {
  using tc::ldmatrix_x4;
  using tc::ldmatrix_x4_trans;
  using tc::mma_16816;
  constexpr int kRow = HD + 8;     // padded shared row, in bf16
  constexpr int kKSteps = HD / 16; // k16 steps of Q·Kᵀ
  constexpr int kDTiles = HD / 8;  // n8 tiles of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kBQ][kRow]
  __nv_bfloat16* ks = qs + kBQ * kRow;                           // [2][kBKV][kRow]
  __nv_bfloat16* vs = ks + 2 * kBKV * kRow;                      // [2][kBKV][kRow]

  const int qtile = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qtile * kBQ;
  const int hd = a.hd;
  const bool vec = a.vec != 0;

  const long long q_row = static_cast<long long>(a.H) * hd;  // elements between positions
  const long long kv_row = static_cast<long long>(a.Hkv) * hd;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            static_cast<long long>(b) * a.Sq * q_row + static_cast<long long>(h) * hd;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            static_cast<long long>(b) * a.Skv * kv_row + static_cast<long long>(hk) * hd;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            static_cast<long long>(b) * a.Skv * kv_row + static_cast<long long>(hk) * hd;

  // KV range the masks leave live for any row of this tile
  const int last_row = min(q0 + kBQ, a.Sq) - 1;
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, last_row + a.q_offset + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, q0 + a.q_offset - a.window + 1);
  kv_begin = (kv_begin / kBKV) * kBKV;

  auto load_kv = [&](int kv0, int stage) {
    tc::load_tile<kBKV, HD, kMmaThreads>(ks + stage * kBKV * kRow, kb + kv0 * kv_row, kv_row,
                                         a.Skv - kv0, hd, vec, tid);
    tc::load_tile<kBKV, HD, kMmaThreads>(vs + stage * kBKV * kRow, vb + kv0 * kv_row, kv_row,
                                         a.Skv - kv0, hd, vec, tid);
  };
  tc::load_tile<kBQ, HD, kMmaThreads>(qs, qb + q0 * q_row, q_row, a.Sq - q0, hd, vec, tid);
  tc::cp_async_commit();
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  tc::cp_async_commit();

  // log2 domain: p = 2^(s·scale·log2 e − m), one exp2 per score
  const float scale_log2 = a.scale * 1.4426950408889634f;
  float o[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  uint32_t qf[kKSteps][4];
  const int row_a = q0 + warp * 16 + g;  // this thread's two q rows: row_a, row_a + 8

  int stage = 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV, stage ^= 1) {
    if (kv0 + kBKV < kv_end) {
      load_kv(kv0 + kBKV, stage ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile kv0 (and, the first time, Q) is in shared memory
    if (kv0 == kv_begin) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + stage * kBKV * kRow;
    const __nv_bfloat16* vt = vs + stage * kBKV * kRow;

    // ---- S = Q·Kᵀ: 16 rows × 64 keys per warp, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // key tiles 2np, 2np + 1
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRow + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // ---- masks (only where a tile crosses an edge), scale into the log2 domain
    const bool full = kv0 + kBKV <= a.Skv &&
                      (!a.causal || kv0 + kBKV - 1 <= q0 + a.q_offset) &&
                      (a.window <= 0 || q0 + kBQ - 1 + a.q_offset - kv0 < a.window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;
        if (!full) {
          const int qpos = row_a + (e >> 1) * 8 + a.q_offset;
          const int key = kv0 + n * 8 + 2 * t + (e & 1);
          keep = key < a.Skv;  // rows past Sq are computed from zero q rows and never stored
          if (a.causal) keep = keep && qpos >= key;
          if (a.window > 0) keep = keep && qpos - key < a.window;
        }
        s[n][e] = keep ? s[n][e] * scale_log2 : -INFINITY;
      }

    // ---- online softmax: a row's 64 scores sit in the 4 threads of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: p = 0
      const float corr = exp2f(m[r] - m_use);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - m_use);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_use);
        l[r] += s[n][2 * r] + s[n][2 * r + 1];
      }
    }

    // ---- O += (P_hi + P_lo)·V: the accumulators of key tiles 2kk, 2kk + 1
    // are the A fragment of k16 step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      tc::split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      tc::split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      tc::split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {  // output tiles 2dp, 2dp + 1
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 15)) * kRow + dp * 16 + (lane >> 4) * 8);
        mma_16816(o[2 * dp], ph, vf[0], vf[1]);
        mma_16816(o[2 * dp], pl, vf[0], vf[1]);
        mma_16816(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma_16816(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }
  tc::cp_async_wait<0>();  // an empty KV range never waited on the Q load, which
  __syncthreads();         // every thread issued a part of

  // ---- epilogue: rows summed over the quad, l floored, rounded once to
  // bf16, staged in this warp's own Q rows, then 16-byte stores
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* os = qs + warp * 16 * kRow;  // this warp's Q rows, read by its ldmatrix only
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * r) * kRow + d * 8 + 2 * t) =
          tc::pack_bf16x2(o[d][2 * r] / denom[r], o[d][2 * r + 1] / denom[r]);
  __syncwarp();
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                      static_cast<long long>(b) * a.Sq * q_row + static_cast<long long>(h) * hd;
  constexpr int kChunks = HD / 8;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= a.Sq || c >= hd) continue;
    const __nv_bfloat16* src = os + r * kRow + c;
    __nv_bfloat16* dst = ob + row * q_row + c;
    if (vec && c + 8 <= hd) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < hd; ++e) dst[e] = src[e];
    }
  }
}

template <int HD>
int launch_f32(const AttnArgs& a, int device, cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes(HD);
  const int e = tc::opt_in_smem<&attn_f32_kernel<HD>>(device, bytes);
  if (e != 0) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attn_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma(const AttnArgs& a, int device, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<HD>();
  const int e = tc::opt_in_smem<&attn_mma_kernel<HD>>(device, bytes);
  if (e != 0) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attn_mma_kernel<HD><<<grid, kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).  q, k, v, out
// are contiguous device buffers: q and out (B, Sq, H, hd), k and v
// (B, Skv, Hkv, hd), all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); the
// caller checked shapes (H % Hkv == 0, 1 ≤ hd ≤ 128).  window ≤ 0: none.
extern "C" int flash_attention_launch(
    void* out, const void* q, const void* k, const void* v, int B, int Sq, int Skv, int H,
    int Hkv, int hd, int causal, int window, int q_offset, float scale, int is_bf16,
    int device, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || hd <= 0 || hd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = hd % 8 == 0 && aligned(out) && aligned(q) && aligned(k) && aligned(v);
  const AttnArgs a{out, q, k, v, B, Sq, Skv, H, Hkv, hd, causal, window, q_offset, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return hd <= 64 ? launch_mma<64>(a, device, s) : launch_mma<128>(a, device, s);
  return hd <= 64 ? launch_f32<64>(a, device, s) : launch_f32<128>(a, device, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
