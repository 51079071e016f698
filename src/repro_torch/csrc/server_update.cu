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
// 0.3 µs.  Design against that bound: each thread owns one column per
// grid-stride step and walks the C rows of that column, so a warp reads 32
// consecutive elements of each row (128 bytes of f32, 32 bytes of int8 —
// one sector, coalesced), with the row loads unrolled to keep many in
// flight; the mean stays in a register and x', m', mean are written
// coalesced along P.  The compressed plane is dequantized in registers:
// the f32 (C, P) plane never exists in device memory.  No atomics and no
// cross-block reduction: the sum runs in a fixed ascending order, so the
// output is bitwise run-to-run deterministic (the later in-port contract
// sharded ≡ unsharded needs that).  At P = 22026 and 128 threads a block
// this is 173 blocks, about 1.3 per SM of the card's 132 — the main
// path's fold is too small to fill the card, and is launch-bound.  The
// TPU kernels' padding, lane-padded (C, LANE) scale/wn operands and ≥
// 2-step grid floor (layout and XLA:CPU workarounds) are not carried over.
//
// Products and sums use __fmul_rn/__fadd_rn: no FMA contraction, so the
// kernel rounds exactly as the plain PyTorch version (ref.py), which
// computes d = q·scale, then d·wn, then the ascending sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TD, typename TM, bool SCALED, bool WRITE_X, bool WRITE_M>
__global__ void __launch_bounds__(kThreads)
fold_kernel(float* __restrict__ mean_out, void* __restrict__ new_x,
            TM* __restrict__ new_m, const TD* __restrict__ plane,
            const float* __restrict__ scale, const float* __restrict__ wn,
            const void* __restrict__ x, const TM* __restrict__ m,
            const float* __restrict__ coefs, int C, long long P, int x_bf16) {
  const float c_mm = coefs[0];
  const float c_md = coefs[1];
  const float c_xd = coefs[2];
  const float gamma = coefs[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < P;
       j += stride) {
    const TD* col = plane + j;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      float d = to_f32(col[static_cast<long long>(c) * P]);
      if (SCALED) d = __fmul_rn(d, __ldg(scale + c));
      acc = __fadd_rn(acc, __fmul_rn(d, __ldg(wn + c)));
    }
    const float dmean = __fmul_rn(gamma, acc);
    if (WRITE_X) {
      if (x_bf16) {
        const float xv = __bfloat162float(static_cast<const __nv_bfloat16*>(x)[j]);
        static_cast<__nv_bfloat16*>(new_x)[j] = __float2bfloat16_rn(__fadd_rn(xv, __fmul_rn(c_xd, dmean)));
      } else {
        const float xv = static_cast<const float*>(x)[j];
        static_cast<float*>(new_x)[j] = __fadd_rn(xv, __fmul_rn(c_xd, dmean));
      }
    }
    if (WRITE_M) {
      const float mv = to_f32(m[j]);
      new_m[j] = from_f32<TM>(__fadd_rn(__fmul_rn(c_mm, mv), __fmul_rn(c_md, dmean)));
    }
    mean_out[j] = acc;
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || v <= 0) v = 132;
    cached[device] = v;
  }
  return cached[device];
}

struct FoldArgs {
  float* mean;
  void* new_x;
  void* new_m;
  const void* plane;
  const float* scale;
  const float* wn;
  const void* x;
  const void* m;
  const float* coefs;
  int C;
  long long P;
  int x_bf16;
  int blocks;
  cudaStream_t stream;
};

template <typename TD, typename TM, bool SCALED, bool WX, bool WM>
void launch(const FoldArgs& a) {
  fold_kernel<TD, TM, SCALED, WX, WM><<<a.blocks, kThreads, 0, a.stream>>>(
      a.mean, a.new_x, static_cast<TM*>(a.new_m), static_cast<const TD*>(a.plane), a.scale,
      a.wn, a.x, static_cast<const TM*>(a.m), a.coefs, a.C, a.P, a.x_bf16);
}

template <typename TD, typename TM, bool SCALED>
void dispatch_writes(int write_x, int write_m, const FoldArgs& a) {
  if (write_x && write_m) {
    launch<TD, TM, SCALED, true, true>(a);
  } else if (write_x) {
    launch<TD, TM, SCALED, true, false>(a);
  } else if (write_m) {
    launch<TD, TM, SCALED, false, true>(a);
  } else {
    launch<TD, TM, SCALED, false, false>(a);
  }
}

template <typename TD, bool SCALED>
void dispatch_m(int m_bf16, int write_x, int write_m, const FoldArgs& a) {
  if (m_bf16) {
    dispatch_writes<TD, __nv_bfloat16, SCALED>(write_x, write_m, a);
  } else {
    dispatch_writes<TD, float, SCALED>(write_x, write_m, a);
  }
}

// Shared prologue of both entry points: argument check, device, grid.
// Returns a CUDA error code, or -1 when the launch should go ahead.
int prepare(FoldArgs& a, int device, void* stream) {
  if (a.C <= 0 || a.P < 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.P == 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (a.P + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  a.blocks = static_cast<int>(blocks);
  a.stream = static_cast<cudaStream_t>(stream);
  return -1;
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 =
// success).  The plane is contiguous (C, P); x, m, new_x, new_m and mean
// are (P,); pointers of skipped outputs (write_x / write_m = 0) may be
// null.

// deltas: f32 (d_bf16 = 0) or bf16 (d_bf16 = 1).
extern "C" int server_update_launch(
    float* mean, void* new_x, void* new_m, const void* deltas, const float* wn,
    const void* x, const void* m, const float* coefs, int C, long long P, int d_bf16,
    int m_bf16, int x_bf16, int write_x, int write_m, int device, void* stream) {
  FoldArgs a{mean, new_x, new_m, deltas, nullptr, wn, x, m, coefs, C, P, x_bf16, 0, nullptr};
  const int early = prepare(a, device, stream);
  if (early >= 0) return early;
  if (d_bf16) {
    dispatch_m<__nv_bfloat16, false>(m_bf16, write_x, write_m, a);
  } else {
    dispatch_m<float, false>(m_bf16, write_x, write_m, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: int8 (q_bf16 = 0) or bf16 (q_bf16 = 1); scale: (C,) f32 per-row
// dequant scale (all ones for a bf16 plane).
extern "C" int dequant_update_launch(
    float* mean, void* new_x, void* new_m, const void* q, const float* scale,
    const float* wn, const void* x, const void* m, const float* coefs, int C, long long P,
    int q_bf16, int m_bf16, int x_bf16, int write_x, int write_m, int device, void* stream) {
  FoldArgs a{mean, new_x, new_m, q, scale, wn, x, m, coefs, C, P, x_bf16, 0, nullptr};
  const int early = prepare(a, device, stream);
  if (early >= 0) return early;
  if (q_bf16) {
    dispatch_m<__nv_bfloat16, true>(m_bf16, write_x, write_m, a);
  } else {
    dispatch_m<int8_t, true>(m_bf16, write_x, write_m, a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* server_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
