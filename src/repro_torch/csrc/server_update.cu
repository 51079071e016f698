// server_update: the fused server round close, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/server_update/kernel.py ::
// server_update_flat (Pallas).  In one pass over the (C, P) cohort delta
// plane it computes, per plane column j,
//
//     mean_j = Σ_c wn_c · Δ_{c,j}                 (c ascending)
//     m'_j   = c_mm·m_j + c_md·(γ·mean_j)          (if WRITE_M)
//     x'_j   = x_j + c_xd·(γ·mean_j)               (if WRITE_X)
//
// with coefs = (c_mm, c_md, c_xd, γ) and wn read from DEVICE f32 arrays, so
// the per-round c_md = −1/(η_l·K) never changes the launch.  mean is
// emitted in f32 and undiscounted.  WRITE_X / WRITE_M are template flags
// that drop both the read and the write of x or m.  Templates on the Δ
// dtype (f32, or bf16 under aggregate_dtype) and on the momentum dtype
// (m and m' share it); x carries a runtime dtype flag.
//
// Bound on an H100 SXM: memory-bound, 2 flops per Δ element read.  The
// least bytes are Δ once, wn, x and m once, and x', m', mean once; at the
// main path's (C, P) = (25, 22026), f32: 25·22026·4 + 5·22026·4 B = 2.6 MB,
// 0.8 µs at 3.35 TB/s.  Design against that bound: each thread owns one
// column per grid-stride step and walks the C rows of that column, so a
// warp reads 32 consecutive elements (128 bytes, coalesced) of each row,
// with the row loads unrolled to keep many in flight; the mean stays in a
// register and x', m', mean are written coalesced along P.  No atomics and
// no cross-block reduction: the sum runs in a fixed ascending order, so
// the output is bitwise run-to-run deterministic (the later in-port
// contract sharded ≡ unsharded needs that).  At P = 22026 and 128 threads
// a block this is 173 blocks, about 1.3 per SM of the card's 132 — the
// main path's fold is too small to fill the card, and is launch-bound.
// The TPU kernel's padding and its ≥ 2-step grid floor (an XLA:CPU FMA
// workaround) are not carried over.
//
// Products and sums use __fmul_rn/__fadd_rn: no FMA contraction, so the
// kernel rounds exactly as the plain PyTorch version (ref.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TD, typename TM, bool WRITE_X, bool WRITE_M>
__global__ void __launch_bounds__(kThreads)
server_update_kernel(float* __restrict__ mean_out, void* __restrict__ new_x,
                     TM* __restrict__ new_m, const TD* __restrict__ deltas,
                     const float* __restrict__ wn, const void* __restrict__ x,
                     const TM* __restrict__ m, const float* __restrict__ coefs,
                     int C, long long P, int x_bf16) {
  const float c_mm = coefs[0];
  const float c_md = coefs[1];
  const float c_xd = coefs[2];
  const float gamma = coefs[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < P;
       j += stride) {
    const TD* col = deltas + j;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      acc = __fadd_rn(acc, __fmul_rn(to_f32(col[static_cast<long long>(c) * P]), __ldg(wn + c)));
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

template <typename TD, typename TM, bool WX, bool WM>
void launch(float* mean, void* new_x, void* new_m, const void* deltas, const float* wn,
            const void* x, const void* m, const float* coefs, int C, long long P, int x_bf16,
            int blocks, cudaStream_t s) {
  server_update_kernel<TD, TM, WX, WM><<<blocks, kThreads, 0, s>>>(
      mean, new_x, static_cast<TM*>(new_m), static_cast<const TD*>(deltas), wn, x,
      static_cast<const TM*>(m), coefs, C, P, x_bf16);
}

template <typename TD, typename TM>
void dispatch_writes(int write_x, int write_m, float* mean, void* new_x, void* new_m,
                     const void* deltas, const float* wn, const void* x, const void* m,
                     const float* coefs, int C, long long P, int x_bf16, int blocks,
                     cudaStream_t s) {
  if (write_x && write_m) {
    launch<TD, TM, true, true>(mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, blocks, s);
  } else if (write_x) {
    launch<TD, TM, true, false>(mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, blocks, s);
  } else if (write_m) {
    launch<TD, TM, false, true>(mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, blocks, s);
  } else {
    launch<TD, TM, false, false>(mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, blocks, s);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).  deltas is a
// contiguous (C, P) plane; x, m, new_x, new_m and mean are (P,); pointers
// of skipped outputs (write_x / write_m = 0) may be null.
extern "C" int server_update_launch(
    float* mean, void* new_x, void* new_m, const void* deltas, const float* wn,
    const void* x, const void* m, const float* coefs, int C, long long P, int d_bf16,
    int m_bf16, int x_bf16, int write_x, int write_m, int device, void* stream) {
  if (C <= 0 || P < 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (P == 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (P + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(blocks);
  if (d_bf16) {
    if (m_bf16) {
      dispatch_writes<__nv_bfloat16, __nv_bfloat16>(write_x, write_m, mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, b, s);
    } else {
      dispatch_writes<__nv_bfloat16, float>(write_x, write_m, mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, b, s);
    }
  } else {
    if (m_bf16) {
      dispatch_writes<float, __nv_bfloat16>(write_x, write_m, mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, b, s);
    } else {
      dispatch_writes<float, float>(write_x, write_m, mean, new_x, new_m, deltas, wn, x, m, coefs, C, P, x_bf16, b, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* server_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
