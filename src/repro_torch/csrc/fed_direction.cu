// fed_direction: the generalized federated local step, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fed_direction/kernel.py ::
// fed_direction_flat (Pallas, one launch per client under vmap).  Computes,
// elementwise over a cohort plane of n = C·P elements,
//
//     v   = c_g·g + c_x·x + Σ_j c_j·aux_j        (j < n_aux ≤ 3)
//     out = x − η_l·v
//
// with coefs = (η_l, c_g, c_x, c_0, c_1, c_2) read from a DEVICE f32 array,
// so the per-round η_l decay never changes the launch and the round stays
// capturable in a CUDA graph.  x and out share one dtype (f32 or bf16, a
// template); g and each aux carry their own dtype flag (f32 or bf16).  An
// aux is either per-client (n elements, like x) or broadcast (P elements,
// read at i mod P) — FedCM's Δ_t is the broadcast one.  All arithmetic is
// f32, rounded once into out's dtype.
//
// Bound on an H100 SXM: purely memory-bound, about 0.5 flop per byte.  The
// least bytes are read x, g, each per-client aux once and each broadcast aux
// once, and write out once; at the main path's (C, P) = (25, 22026), f32,
// one broadcast aux: 25·22026·12 + 22026·4 B = 6.7 MB, 2.0 µs at 3.35 TB/s.
// Design against that bound: one pass, no intermediate in device memory;
// each thread moves 8 elements per step with 16-byte loads/stores (two
// float4 for f32, one uint4 of 8 bf16) on the streams that are aligned,
// and a grid-stride loop keeps at most one wave of blocks resident.  The
// broadcast aux is read with scalar loads (its row wraps every P elements,
// so its 8-element groups are not 16-byte aligned); at P = 22026 it stays
// in L2 across the C rows.  The ragged edge is masked by a scalar tail
// loop — nothing is padded (the TPU kernel padded to a block multiple).
//
// Products and sums use __fmul_rn/__fadd_rn/__fsub_rn: no FMA contraction,
// so the kernel rounds exactly as the plain PyTorch version (ref.py), which
// runs the same operations one by one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 256;
constexpr int kMaxAux = 3;

struct Operand {
  const void* ptr;
  int bf16;   // 1: __nv_bfloat16 elements, 0: float
  int bcast;  // 1: (P,) broadcast over the C rows, 0: (C, P) like x
};

__device__ __forceinline__ float load1(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 8 consecutive elements starting at i (i a multiple of 8, base 16-byte aligned)
__device__ __forceinline__ void load8(const void* p, int bf16, long long i, float v[kVec]) {
  if (bf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = q[0];
    const float4 b = q[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ void store1(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store8(float* out, long long i, const float v[kVec]) {
  float4* q = reinterpret_cast<float4*>(out + i);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* out, long long i, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(out + i) = raw;
}

template <typename T>
struct IsBf16 { static constexpr int value = 0; };
template <>
struct IsBf16<__nv_bfloat16> { static constexpr int value = 1; };

template <typename T, int NAUX>
__global__ void __launch_bounds__(kThreads)
fed_direction_kernel(T* __restrict__ out, const T* __restrict__ x, Operand g,
                     Operand a0, Operand a1, Operand a2,
                     const float* __restrict__ coefs, long long n, long long p,
                     int vec_ok) {
  const float eta = coefs[0];
  const float cg = coefs[1];
  const float cx = coefs[2];
  const Operand aux[kMaxAux] = {a0, a1, a2};
  float ca[kMaxAux] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NAUX; ++j) ca[j] = coefs[3 + j];

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nvec = vec_ok ? n / kVec : 0;

  for (long long s = tid; s < nvec; s += stride) {
    const long long i = s * kVec;
    float xv[kVec], gv[kVec], acc[kVec];
    load8(x, IsBf16<T>::value, i, xv);
    load8(g.ptr, g.bf16, i, gv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = __fadd_rn(__fmul_rn(cg, gv[k]), __fmul_rn(cx, xv[k]));
#pragma unroll
    for (int j = 0; j < NAUX; ++j) {
      float av[kVec];
      if (aux[j].bcast) {
        long long r = i % p;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          av[k] = load1(aux[j].ptr, aux[j].bf16, r);
          if (++r == p) r = 0;
        }
      } else {
        load8(aux[j].ptr, aux[j].bf16, i, av);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(ca[j], av[k]));
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = __fsub_rn(xv[k], __fmul_rn(eta, acc[k]));
    store8(out, i, acc);
  }

  // ragged tail (and every element when the streams are not 16-byte aligned)
  for (long long i = nvec * kVec + tid; i < n; i += stride) {
    const float xi = load1(x, IsBf16<T>::value, i);
    float acc = __fadd_rn(__fmul_rn(cg, load1(g.ptr, g.bf16, i)), __fmul_rn(cx, xi));
#pragma unroll
    for (int j = 0; j < NAUX; ++j) {
      const long long ai = aux[j].bcast ? i % p : i;
      acc = __fadd_rn(acc, __fmul_rn(ca[j], load1(aux[j].ptr, aux[j].bf16, ai)));
    }
    store1(out, i, __fsub_rn(xi, __fmul_rn(eta, acc)));
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

template <typename T, int NAUX>
void launch(void* out, const void* x, Operand g, Operand a0, Operand a1, Operand a2,
            const float* coefs, long long n, long long p, int vec_ok, int blocks,
            cudaStream_t stream) {
  fed_direction_kernel<T, NAUX><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(x), g, a0, a1, a2, coefs, n, p, vec_ok);
}

template <typename T>
void dispatch_aux(int n_aux, void* out, const void* x, Operand g, Operand a0, Operand a1,
                  Operand a2, const float* coefs, long long n, long long p, int vec_ok,
                  int blocks, cudaStream_t stream) {
  switch (n_aux) {
    case 0: launch<T, 0>(out, x, g, a0, a1, a2, coefs, n, p, vec_ok, blocks, stream); break;
    case 1: launch<T, 1>(out, x, g, a0, a1, a2, coefs, n, p, vec_ok, blocks, stream); break;
    case 2: launch<T, 2>(out, x, g, a0, a1, a2, coefs, n, p, vec_ok, blocks, stream); break;
    default: launch<T, 3>(out, x, g, a0, a1, a2, coefs, n, p, vec_ok, blocks, stream); break;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).  Pointers are
// device pointers of contiguous buffers; the caller checked shapes, dtypes
// and alignment (vec_ok = 1 only when x, g, out and every per-client aux are
// 16-byte aligned).
extern "C" int fed_direction_launch(
    void* out, const void* x, const void* g, const void* aux0, const void* aux1,
    const void* aux2, const float* coefs, long long n, long long p, int x_bf16,
    int g_bf16, int n_aux, int aux_bf16_mask, int aux_bcast_mask, int vec_ok,
    int device, void* stream) {
  if (n_aux < 0 || n_aux > kMaxAux || p <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const void* ptrs[kMaxAux] = {aux0, aux1, aux2};
  Operand a[kMaxAux];
  for (int j = 0; j < kMaxAux; ++j) {
    a[j].ptr = ptrs[j];
    a[j].bf16 = (aux_bf16_mask >> j) & 1;
    a[j].bcast = (aux_bcast_mask >> j) & 1;
  }
  const Operand gop = {g, g_bf16, 0};
  const long long work = vec_ok ? (n + kVec - 1) / kVec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    dispatch_aux<__nv_bfloat16>(n_aux, out, x, gop, a[0], a[1], a[2], coefs, n, p, vec_ok,
                                static_cast<int>(blocks), s);
  } else {
    dispatch_aux<float>(n_aux, out, x, gop, a[0], a[1], a[2], coefs, n, p, vec_ok,
                        static_cast<int>(blocks), s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fed_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
