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
// so it is bound by operations.  This first version does its products on
// the f32 CUDA cores (67 TFLOP/s peak), not the tensor cores (wgmma and TMA
// are the next step), so it stays well above that bound.  Design against the
// bytes: the grid is (q tile, head, batch); each block keeps its 64 q rows
// in shared memory and walks the KV tiles its masks leave live (tiles wholly
// above the causal diagonal or outside the window are never loaded — the
// TPU kernel loaded them and skipped only their compute), so K and V are
// read once per q tile and the (Sq, Skv) scores never reach device memory.
// Nothing carries across blocks: the TPU kernel's sequential KV grid axis is
// the loop inside the block.  Each of the 256 threads owns 4 q rows × 4 keys
// of a score tile and 4 q rows × hd/16 output dims; a row's 16 threads sit
// in one warp, so the row max and row sum are warp shuffles.  Q and K are
// stored transposed in shared memory (d-major) and P transposed (key-major),
// so every inner-loop read is one float4.  The tiles need 65 KB (hd ≤ 64)
// or 113 KB (hd ≤ 128) of dynamic shared memory, above the 48 KB default,
// so each instantiation opts in once with cudaFuncSetAttribute.
//
// expf, not __expf: the plain version's exp is accurate to an ulp, and so is
// this one.  Sums run in another order than the plain version's softmax and
// matrix products, so the two agree to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per block
constexpr int kBKV = 64;         // keys per KV tile
constexpr int kThreads = 256;    // 16 × 16: ty → 4 q rows, tx → 4 keys / output dims
constexpr int kPRow = kBKV + 4;  // padded row of the P^T tile (fewer bank conflicts)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
};

constexpr size_t smem_bytes(int hd_pad) {
  return sizeof(float) * (static_cast<size_t>(hd_pad) * kBQ + static_cast<size_t>(hd_pad) * kBKV +
                          static_cast<size_t>(kBKV) * hd_pad + static_cast<size_t>(kBKV) * kPRow);
}

// HD: hd padded to 64 or 128 (zero-filled in shared memory).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_kernel(AttnArgs a) {
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
  const T* qb = static_cast<const T*>(a.q) + static_cast<long long>(b) * a.Sq * q_row +
                static_cast<long long>(h) * hd;
  const T* kb = static_cast<const T*>(a.k) + static_cast<long long>(b) * a.Skv * kv_row +
                static_cast<long long>(hk) * hd;
  const T* vb = static_cast<const T*>(a.v) + static_cast<long long>(b) * a.Skv * kv_row +
                static_cast<long long>(hk) * hd;

  for (int idx = tid; idx < HD * kBQ; idx += kThreads) {
    const int r = idx % kBQ;
    const int d = idx / kBQ;
    const int row = q0 + r;
    qt[d * kBQ + r] = (row < a.Sq && d < hd) ? to_f32(qb[row * q_row + d]) : 0.f;
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
      kt[d * kBKV + c] = (key < a.Skv && d < hd) ? to_f32(kb[key * kv_row + d]) : 0.f;
      const int vc = idx / HD;
      const int vd = idx % HD;
      const int vkey = kv0 + vc;
      vs[vc * HD + vd] = (vkey < a.Skv && vd < hd) ? to_f32(vb[vkey * kv_row + vd]) : 0.f;
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

  T* ob = static_cast<T*>(a.out) + static_cast<long long>(b) * a.Sq * q_row +
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
        if (d < hd) store_out(&ob[row * q_row + d], acc[i][g * 4 + e] / denom);
      }
  }
}

template <typename T, int HD>
int launch(const AttnArgs& a, cudaStream_t stream) {
  static bool opted_in = false;  // per instantiation; set before its first launch
  constexpr size_t bytes = smem_bytes(HD);
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  attn_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(a);
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
  const AttnArgs a{out, q, k, v, B, Sq, Skv, H, Hkv, hd, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return hd <= 64 ? launch<__nv_bfloat16, 64>(a, s) : launch<__nv_bfloat16, 128>(a, s);
  }
  return hd <= 64 ? launch<float, 64>(a, s) : launch<float, 128>(a, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
