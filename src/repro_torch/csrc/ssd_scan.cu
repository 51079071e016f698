// ssd_scan: the Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py ::
// ssd_chunked_pallas (Pallas; body _ssd_kernel).  For x (B, S, H, P),
// dt (B, S, H) f32, A (H,) f32 and the head-shared B, C (B, S, N), with
// chunks of L steps and, per chunk, dAcs = inclusive cumsum of dt·A:
//
//     y_diag[i]  = Σ_{j ≤ i} (C_i · B_j) exp(dAcs_i − dAcs_j) · dt_j x_j
//     y_off[i]   = (C_i · state) exp(dAcs_i)
//     state     ← exp(dAcs_{L−1}) state + Σ_l exp(dAcs_{L−1} − dAcs_l) dt_l x_l ⊗ B_l
//
// y = y_diag + y_off in x's dtype, and the final state (B, H, P, N) in f32.
// All arithmetic is f32.  The ragged tail is a run of dt = 0 steps (an
// identity step: no decay, no input), masked in the kernel; nothing is
// padded in device memory.
//
// Bound on an H100 SXM: at the serving shape (B=4, S=1024, H=64, P=64,
// N=128, L=64, bf16 x) the function reads 37 MB and writes 42 MB (24 µs at
// 3.35 TB/s); the chunked algorithm's products — C·Bᵀ on the causal
// triangle once per (b, chunk), which every head shares, then per
// (b, h, chunk) y_diag on the triangle, y_off and the state update — are
// ≈ 10 GFLOP (10 µs at the bf16 tensor-core peak), so it is bound by bytes.
// This first version does its products on the f32 CUDA cores and
// recomputes C·Bᵀ in every head (64× the shared work, as the TPU kernel
// did), so it stays well above that bound.  Design against the bytes: one
// block per (b, h) walks the chunks in order — the TPU kernel's sequential
// chunk grid axis is the loop inside the block, and nothing carries across
// blocks — keeping the (P, N) state (32 KB f32) in shared memory from the
// first chunk to the last, so the state never goes to device memory until
// the end, and x, dt, B and C are each read once.  B and C are read from
// the head-shared (B, S, N) arrays by index (the TPU wrapper broadcast them
// to every head), with the row strides of the strided slices the model
// hands over.  Per chunk the 256 threads compute, each on a 4×4, 4×4 and
// 8×4 register tile: the masked decay-weighted C·Bᵀ scores (stored
// transposed), y from the scores and the entering state, then the state
// update.  Shared memory holds x·dt, B (twice: n-major and l-major), C, the
// scores and the state: 165 KB, so the kernel opts in to dynamic shared
// memory above 48 KB once.  The inclusive cumsum runs in one thread in
// order l = 0, 1, ... (64 adds); the plain version's torch.cumsum may sum
// in another order, so the two agree to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;          // largest chunk
constexpr int kP = 64;          // largest head dim (zero-padded in shared memory)
constexpr int kN = 128;         // largest state size (zero-padded)
constexpr int kLRow = kL + 4;   // padded row of the n-major and score tiles
constexpr int kThreads = 256;   // 16 × 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct SsdArgs {
  void* y;             // (B, S, H, P) contiguous, x's dtype
  float* state;        // (B, H, P, N) contiguous
  const void* x;       // x[b, s, h, p] at b·x_sb + s·x_ss + h·P + p
  const float* dt;     // (B, S, H) contiguous
  const float* A;      // (H,)
  const void* bm;      // B[b, s, n] at b·b_sb + s·b_ss + n
  const void* cm;      // C[b, s, n] at b·c_sb + s·c_ss + n
  int Bsz, S, H, P, N, L;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

constexpr size_t kSmemFloats =
    static_cast<size_t>(kL) * kP          // xdt  [l][p]
    + static_cast<size_t>(kN) * kLRow     // bt   [n][l]
    + static_cast<size_t>(kL) * kN        // bl   [l][n]
    + static_cast<size_t>(kN) * kLRow     // ct   [n][l]
    + static_cast<size_t>(kL) * kLRow     // sc   [j][i]  scores^T
    + static_cast<size_t>(kN) * kP        // st   [n][p]  state^T
    + 4 * static_cast<size_t>(kL);        // dts, dacs, dec_in, dte
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* xdt = reinterpret_cast<float*>(smem4);
  float* bt = xdt + kL * kP;
  float* bl = bt + kN * kLRow;
  float* ct = bl + kL * kN;
  float* sc = ct + kN * kLRow;
  float* st = sc + kL * kLRow;
  float* dts = st + kN * kP;
  float* dacs = dts + kL;
  float* dec_in = dacs + kL;
  float* dte = dec_in + kL;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int S = a.S, P = a.P, N = a.N, L = a.L, H = a.H;
  const float A = a.A[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.x_sb + static_cast<long long>(h) * P;
  const T* bb = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cb = static_cast<const T*>(a.cm) + b * a.c_sb;
  const float* dtb = a.dt + static_cast<long long>(b) * S * H + h;
  T* yb = static_cast<T*>(a.y) + (static_cast<long long>(b) * S * H + h) * P;

  for (int idx = tid; idx < kN * kP; idx += kThreads) st[idx] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * L;
    __syncthreads();  // the previous chunk's reads of every tile are done
    if (tid < kL) {
      const int s = s0 + tid;
      dts[tid] = (tid < L && s < S) ? dtb[static_cast<long long>(s) * H] : 0.f;
    }
    for (int idx = tid; idx < kL * kP; idx += kThreads) {
      const int l = idx / kP;
      const int p = idx % kP;
      const int s = s0 + l;
      float v = 0.f;
      if (l < L && s < S && p < P)
        v = to_f32(xb[s * a.x_ss + p]) * dtb[static_cast<long long>(s) * H];
      xdt[idx] = v;
    }
    for (int idx = tid; idx < kL * kN; idx += kThreads) {
      const int l = idx % kL;   // consecutive threads: consecutive l → the n-major stores
      const int n = idx / kL;   // are conflict-free; the reads hit L1 across n
      const int s = s0 + l;
      const bool ok = l < L && s < S && n < N;
      const float bv = ok ? to_f32(bb[s * a.b_ss + n]) : 0.f;
      const float cv = ok ? to_f32(cb[s * a.c_ss + n]) : 0.f;
      bt[n * kLRow + l] = bv;
      ct[n * kLRow + l] = cv;
      bl[l * kN + n] = bv;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < kL; ++l) {  // rows past L carry dt = 0: run stays put
        run += dts[l] * A;
        dacs[l] = run;
      }
    }
    __syncthreads();
    if (tid < kL) {
      dec_in[tid] = expf(dacs[tid]);
      dte[tid] = expf(dacs[kL - 1] - dacs[tid]);
    }

    // ---- scores[i][j] = (C_i · B_j) exp(dAcs_i − dAcs_j) for i ≥ j, else 0
    {
      float cbv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cbv[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 ca = *reinterpret_cast<const float4*>(&ct[n * kLRow + ty * 4]);
        const float4 ba = *reinterpret_cast<const float4*>(&bt[n * kLRow + tx * 4]);
        const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
        const float bv[4] = {ba.x, ba.y, ba.z, ba.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cbv[i][j] = fmaf(cv[i], bv[j], cbv[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx * 4 + j;
        float col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ii = ty * 4 + i;
          col[i] = ii >= jj ? cbv[i][j] * expf(dacs[ii] - dacs[jj]) : 0.f;
        }
        *reinterpret_cast<float4*>(&sc[jj * kLRow + ty * 4]) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // ---- y[i][p] = Σ_j scores[i][j] xdt[j][p] + exp(dAcs_i) Σ_n C[i][n] state[p][n]
    {
      float yd[4][4], yo[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          yd[i][e] = 0.f;
          yo[i][e] = 0.f;
        }
#pragma unroll 4
      for (int j = 0; j < kL; ++j) {
        const float4 sa = *reinterpret_cast<const float4*>(&sc[j * kLRow + ty * 4]);
        const float4 xa = *reinterpret_cast<const float4*>(&xdt[j * kP + tx * 4]);
        const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
        const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) yd[i][e] = fmaf(sv[i], xv[e], yd[i][e]);
      }
      for (int n = 0; n < N; ++n) {
        const float4 ca = *reinterpret_cast<const float4*>(&ct[n * kLRow + ty * 4]);
        const float4 sa = *reinterpret_cast<const float4*>(&st[n * kP + tx * 4]);
        const float cv[4] = {ca.x, ca.y, ca.z, ca.w};
        const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) yo[i][e] = fmaf(cv[i], sv[e], yo[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty * 4 + i;
        const int s = s0 + l;
        if (l >= L || s >= S) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = tx * 4 + e;
          if (p < P)
            store_out(&yb[static_cast<long long>(s) * H * P + p], yd[i][e] + yo[i][e] * dec_in[l]);
        }
      }
    }
    __syncthreads();  // every read of the entering state is done

    // ---- state[p][n] ← exp(dAcs_{L−1}) state[p][n] + Σ_l (xdt[l][p] dte[l]) B[l][n]
    {
      const float chunk_decay = expf(dacs[kL - 1]);
      float up[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) up[k][e] = 0.f;
#pragma unroll 2
      for (int l = 0; l < kL; ++l) {
        const float w = dte[l];
        const float4 xa = *reinterpret_cast<const float4*>(&xdt[l * kP + tx * 4]);
        const float wx[4] = {xa.x * w, xa.y * w, xa.z * w, xa.w * w};
        const float4 b0 = *reinterpret_cast<const float4*>(&bl[l * kN + ty * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bl[l * kN + ty * 8 + 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) up[k][e] = fmaf(wx[e], bv[k], up[k][e]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* row = &st[(ty * 8 + k) * kP + tx * 4];
        const float4 old = *reinterpret_cast<const float4*>(row);
        *reinterpret_cast<float4*>(row) =
            make_float4(chunk_decay * old.x + up[k][0], chunk_decay * old.y + up[k][1],
                        chunk_decay * old.z + up[k][2], chunk_decay * old.w + up[k][3]);
      }
    }
  }
  __syncthreads();
  float* sb = a.state + (static_cast<long long>(b) * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N;
    const int n = idx % N;
    sb[idx] = st[n * kP + p];
  }
}

template <typename T>
int launch(const SsdArgs& a, cudaStream_t stream) {
  static bool opted_in = false;  // per instantiation; set before its first launch
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(a.H, a.Bsz);
  ssd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).  x, B and C
// share one dtype (f32: is_bf16 = 0; bf16: is_bf16 = 1) and are read by the
// given batch and sequence strides (innermost dims contiguous); dt, A, y and
// state are contiguous.  1 ≤ P ≤ 64, 1 ≤ N ≤ 128, 1 ≤ L ≤ 64 (the caller
// checked them).
extern "C" int ssd_scan_launch(
    void* y, float* state, const void* x, const float* dt, const float* A, const void* bm,
    const void* cm, int Bsz, int S, int H, int P, int N, int L, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, int is_bf16, int device,
    void* stream) {
  if (Bsz < 0 || S < 0 || H < 0 || P < 1 || P > kP || N < 1 || N > kN || L < 1 || L > kL)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Bsz == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const SsdArgs a{y, state, x, dt, A, bm, cm, Bsz, S, H, P, N, L,
                  x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
