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
// The ragged tail is a run of dt = 0 steps (an identity step: no decay, no
// input), masked in the kernel; nothing is padded in device memory.
//
// Bound on an H100 SXM: at the serving shape (B=4, S=1024, H=64, P=64,
// N=128, L=64, bf16 x) the function reads 37 MB and writes 42 MB (24 µs at
// 3.35 TB/s); the chunked algorithm's products — C·Bᵀ on the causal
// triangle once per (b, chunk), which every head shares, then per
// (b, h, chunk) y_diag on the triangle, y_off and the state update — are
// ≈ 10 GFLOP (10 µs at the bf16 tensor-core peak), so it is bound by bytes.
// Both routes share the design against the bytes: one block per (b, h)
// walks the chunks in order — the TPU kernel's sequential chunk grid axis is
// the loop inside the block, and nothing carries across blocks — keeping
// the (P, N) state on chip from the first chunk to the last, so the state
// never goes to device memory until the end, and x, dt, B and C are each
// read once.  B and C are read from the head-shared (B, S, N) arrays by
// index (the TPU wrapper broadcast them to every head), with the row
// strides of the strided slices the model hands over.  A chunk-parallel
// scan would write (B, H, chunks, P, N) f32 chunk states: 134 MB at the
// serving shape, 3.4× the function's own bytes.
//
// The bf16 route runs every product on the tensor cores (mma.sync m16n8k16,
// f32 accumulators; tensor_core.cuh has the fragment layouts), in two
// launches.  ssd_cb_mma_kernel, grid (chunks, B), computes C·Bᵀ once per
// (b, chunk) into the caller's f32 scratch (B, chunks, 64, 64) — an exact
// bf16 product — which the 64 heads then read from L2.  ssd_mma_kernel,
// 4 warps per (b, h), each owning 16 rows p of the state, which stays in
// registers as an f32 accumulator (16 p × 128 n per warp).  Per chunk it
// computes y transposed, y[i][p] as yᵀ[p][i], so that every operand is
// either bf16 already or held in registers:
//
//     yᵀ   = exp(dAcs_i) · (state_hi + state_lo) · Cᵀ       (A: the state accumulator)
//     yᵀ  += xᵀ · (M_hi + M_lo)ᵀ,  M = CB ⊙ exp(dAcs_i − dAcs_j) ⊙ dt_j on i ≥ j
//     state = exp(dAcs_{L−1}) · state + (W_hi + W_lo)ᵀ · B,  W = exp(dAcs_{L−1} − dAcs_l) dt_l x_l
//
// The f32 operands (state, M, W) enter as two bf16 pieces each: one piece
// would miss the state's 1e-5 tolerance many times over and move y by
// several bf16 ulps, two keep both within it
// (tests/test_torch_kernel_precision.py);
// x, B and C are bf16 and enter as they are.  x, B, C and dt of chunk c+1
// arrive by cp.async in a two-stage ring of padded bf16 tiles while chunk c
// computes; the cumsum is a warp scan; y goes out through shared memory in
// 16-byte stores.  96 KB of shared memory, so two blocks share an SM and
// the serving shape's 256 blocks fit in one wave on 132 SMs.
//
// The f32 route (ssd_f32_kernel) keeps its products on the f32 CUDA cores
// (TF32 would not hold the f32 tolerance): 256 threads on 4×4, 4×4 and 8×4
// register tiles compute the masked decay-weighted C·Bᵀ scores (recomputed
// in every head), y from the scores and the entering state, then the state
// update, with the state in shared memory (165 KB in all); its cumsum runs
// in one thread.
//
// The cumsum and the products sum in other orders than the plain version's
// torch.cumsum and einsums, so the two agree to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kL = 64;          // largest chunk
constexpr int kP = 64;          // largest head dim (zero-padded in shared memory)
constexpr int kN = 128;         // largest state size (zero-padded)
constexpr int kLRow = kL + 4;   // f32 route: padded row of the n-major and score tiles
constexpr int kThreads = 256;   // f32 route: 16 × 16
constexpr int kMmaThreads = 128;  // bf16 route: 4 warps
constexpr int kXRow = kP + 8;   // bf16 route: padded shared rows, in bf16
constexpr int kNRow = kN + 8;

struct SsdArgs {
  void* y;             // (B, S, H, P) contiguous, x's dtype
  float* state;        // (B, H, P, N) contiguous
  float* cb;           // bf16 route: C·Bᵀ scratch (B, chunks, kL, kL)
  const void* x;       // x[b, s, h, p] at b·x_sb + s·x_ss + h·P + p
  const float* dt;     // (B, S, H) contiguous
  const float* A;      // (H,)
  const void* bm;      // B[b, s, n] at b·b_sb + s·b_ss + n
  const void* cm;      // C[b, s, n] at b·c_sb + s·c_ss + n
  int Bsz, S, H, P, N, L;
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int vec;             // bf16 route: P % 8 == 0, strides % 8 == 0, pointers 16-byte aligned
};

constexpr size_t kF32SmemFloats =
    static_cast<size_t>(kL) * kP          // xdt  [l][p]
    + static_cast<size_t>(kN) * kLRow     // bt   [n][l]
    + static_cast<size_t>(kL) * kN        // bl   [l][n]
    + static_cast<size_t>(kN) * kLRow     // ct   [n][l]
    + static_cast<size_t>(kL) * kLRow     // sc   [j][i]  scores^T
    + static_cast<size_t>(kN) * kP        // st   [n][p]  state^T
    + 4 * static_cast<size_t>(kL);        // dts, dacs, dec_in, dte
constexpr size_t kF32SmemBytes = kF32SmemFloats * sizeof(float);

// The f32 route.
__global__ void __launch_bounds__(kThreads) ssd_f32_kernel(SsdArgs a) {
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
  const float* xb = static_cast<const float*>(a.x) + b * a.x_sb + static_cast<long long>(h) * P;
  const float* bb = static_cast<const float*>(a.bm) + b * a.b_sb;
  const float* cb = static_cast<const float*>(a.cm) + b * a.c_sb;
  const float* dtb = a.dt + static_cast<long long>(b) * S * H + h;
  float* yb = static_cast<float*>(a.y) + (static_cast<long long>(b) * S * H + h) * P;

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
        v = xb[s * a.x_ss + p] * dtb[static_cast<long long>(s) * H];
      xdt[idx] = v;
    }
    for (int idx = tid; idx < kL * kN; idx += kThreads) {
      const int l = idx % kL;   // consecutive threads: consecutive l → the n-major stores
      const int n = idx / kL;   // are conflict-free; the reads hit L1 across n
      const int s = s0 + l;
      const bool ok = l < L && s < S && n < N;
      const float bv = ok ? bb[s * a.b_ss + n] : 0.f;
      const float cv = ok ? cb[s * a.c_ss + n] : 0.f;
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
            yb[static_cast<long long>(s) * H * P + p] = yd[i][e] + yo[i][e] * dec_in[l];
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

// ---- bf16 route, launch 1: CB[b, c, i, j] = C_{cL+i} · B_{cL+j}, i, j < kL
// (rows past the chunk or the sequence are 0).  4 warps, 16 rows i each.
constexpr size_t kCbSmemBytes = sizeof(__nv_bfloat16) * 2 * kL * kNRow;

__global__ void __launch_bounds__(kMmaThreads) ssd_cb_mma_kernel(SsdArgs a) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kL][kNRow]
  __nv_bfloat16* bs = cs + kL * kNRow;                           // [kL][kNRow]
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int s0 = c * a.L;
  const int rows = min(a.L, a.S - s0);
  const bool vec = a.vec != 0;
  tc::load_tile<kL, kN, kMmaThreads>(
      cs, static_cast<const __nv_bfloat16*>(a.cm) + b * a.c_sb + s0 * a.c_ss, a.c_ss, rows, a.N,
      vec, tid);
  tc::load_tile<kL, kN, kMmaThreads>(
      bs, static_cast<const __nv_bfloat16*>(a.bm) + b * a.b_sb + s0 * a.b_ss, a.b_ss, rows, a.N,
      vec, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    uint32_t af[4];
    tc::ldmatrix_x4(af, cs + (warp * 16 + (lane & 15)) * kNRow + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // column tiles 2np, 2np + 1
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kNRow + kk * 16 +
                              ((lane >> 3) & 1) * 8);
      tc::mma_16816(acc[2 * np], af, bf[0], bf[1]);
      tc::mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  const int n_chunks = gridDim.x;
  float* out = a.cb + (static_cast<long long>(b) * n_chunks + c) * kL * kL;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * r) * kL + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
}

// ---- bf16 route, launch 2: the scan, one block per (b, h)
struct ScanSmem {
  __nv_bfloat16 xs[2][kL][kXRow];  // x of the chunk, by stage
  __nv_bfloat16 bs[2][kL][kNRow];  // B
  __nv_bfloat16 cs[2][kL][kNRow];  // C
  __nv_bfloat16 ys[kL][kXRow];     // y of the chunk on its way out
  float dts[2][kL];                // dt (0 past the chunk or the sequence)
  float dacs[kL];                  // inclusive cumsum of dt·A
  float dec_in[kL];                // exp(dAcs_i)
  float wl[kL];                    // exp(dAcs_{L−1} − dAcs_l) dt_l
  float chunk_decay[4];            // exp(dAcs_{L−1}) in [0]
};

__global__ void __launch_bounds__(kMmaThreads, 2) ssd_mma_kernel(SsdArgs a) {
  using tc::ldmatrix_x4;
  using tc::ldmatrix_x4_trans;
  using tc::mma_16816;
  using tc::split_bf16x2;
  extern __shared__ float4 smem4[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem4);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;  // owns state rows p in [16 warp, 16 warp + 16)
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S = a.S, P = a.P, N = a.N, L = a.L, H = a.H;
  const bool vec = a.vec != 0;
  const float A = a.A[h];
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x) + b * a.x_sb +
                            static_cast<long long>(h) * P;
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(a.bm) + b * a.b_sb;
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(a.cm) + b * a.c_sb;
  const float* dtb = a.dt + static_cast<long long>(b) * S * H + h;
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(a.y) + (static_cast<long long>(b) * S * H + h) * P;
  const int n_chunks = (S + L - 1) / L;
  const float* cbb = a.cb + static_cast<long long>(b) * n_chunks * kL * kL;

  auto issue = [&](int c, int st) {  // chunk c's x, B, C, dt into stage st
    const int s0 = c * L;
    const int rows = min(L, S - s0);
    tc::load_tile<kL, kP, kMmaThreads>(&sm.xs[st][0][0], xb + s0 * a.x_ss, a.x_ss, rows, P, vec,
                                       tid);
    tc::load_tile<kL, kN, kMmaThreads>(&sm.bs[st][0][0], bb + s0 * a.b_ss, a.b_ss, rows, N, vec,
                                       tid);
    tc::load_tile<kL, kN, kMmaThreads>(&sm.cs[st][0][0], cb + s0 * a.c_ss, a.c_ss, rows, N, vec,
                                       tid);
    if (tid < kL) {
      if (tid < rows)
        tc::cp_async_4(&sm.dts[st][tid], dtb + static_cast<long long>(s0 + tid) * H);
      else
        sm.dts[st][tid] = 0.f;
    }
    tc::cp_async_commit();
  };

  // the state, rows p = 16 warp + g (+ 8), columns n = 8 nt + 2t (+ 1)
  float st[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.f;

  if (n_chunks > 0) issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    const int s0 = c * L;
    const int rows = min(L, S - s0);
    __syncthreads();  // chunk c − 1 is done with stage ^ 1 and with ys
    if (c + 1 < n_chunks) {
      issue(c + 1, stage ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in shared memory

    if (warp == 0) {  // inclusive cumsum of dt·A: lane k holds steps 2k, 2k + 1
      const float d0 = sm.dts[stage][2 * lane] * A;
      const float d1 = sm.dts[stage][2 * lane + 1] * A;
      float run = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += up;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) before = 0.f;
      const float c0 = before + d0;
      const float c1 = c0 + d1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      sm.dacs[2 * lane] = c0;
      sm.dacs[2 * lane + 1] = c1;
      sm.dec_in[2 * lane] = expf(c0);
      sm.dec_in[2 * lane + 1] = expf(c1);
      sm.wl[2 * lane] = expf(last - c0) * sm.dts[stage][2 * lane];
      sm.wl[2 * lane + 1] = expf(last - c1) * sm.dts[stage][2 * lane + 1];
      if (lane == 0) sm.chunk_decay[0] = expf(last);
    }
    __syncthreads();

    // ---- yᵀ = (state_hi + state_lo) · Cᵀ: the state accumulator's column
    // tiles 2kk, 2kk + 1 are the A fragment of k16 step kk (n)
    float y[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16x2(st[2 * kk][0], st[2 * kk][1], ah[0], al[0]);
      split_bf16x2(st[2 * kk][2], st[2 * kk][3], ah[1], al[1]);
      split_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1], ah[2], al[2]);
      split_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int ip = 0; ip < 4; ++ip) {  // row tiles i 2ip, 2ip + 1
        uint32_t cf[4];
        ldmatrix_x4(cf, &sm.cs[stage][ip * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                     [kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_16816(y[2 * ip], ah, cf[0], cf[1]);
        mma_16816(y[2 * ip], al, cf[0], cf[1]);
        mma_16816(y[2 * ip + 1], ah, cf[2], cf[3]);
        mma_16816(y[2 * ip + 1], al, cf[2], cf[3]);
      }
    }
    // y_off carries exp(dAcs_i) on column i; the state decays over the chunk
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float e0 = sm.dec_in[n * 8 + 2 * t];
      const float e1 = sm.dec_in[n * 8 + 2 * t + 1];
      y[n][0] *= e0;
      y[n][1] *= e1;
      y[n][2] *= e0;
      y[n][3] *= e1;
    }
    const float decay = sm.chunk_decay[0];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= decay;

    // ---- per k16 step kk over the chunk's steps j = l: xᵀ as the A fragment
    // (bf16, exact) of yᵀ += xᵀ·(M_hi + M_lo)ᵀ, and W = wl·x, split, as the
    // A fragment of state += (W_hi + W_lo)ᵀ·B
    const float* cbc = cbb + static_cast<long long>(c) * kL * kL;
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t xf[4];  // (p g, j 2t..) (p g+8, j 2t..) (p g, j 2t+8..) (p g+8, j 2t+8..)
      ldmatrix_x4_trans(xf, &sm.xs[stage][kk * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                        [warp * 16 + ((lane >> 3) & 1) * 8]);
      const int j0 = kk * 16 + 2 * t;
      const int j1 = j0 + 8;
#pragma unroll
      for (int n = 2 * kk; n < 8; ++n) {  // row tiles i that reach j ≥ 16 kk (M is lower triangular)
        const int i = n * 8 + g;
        const float2 cb0 = *reinterpret_cast<const float2*>(cbc + i * kL + j0);
        const float2 cb1 = *reinterpret_cast<const float2*>(cbc + i * kL + j1);
        const float di = sm.dacs[i];
        const float m00 = i >= j0 ? cb0.x * expf(di - sm.dacs[j0]) * sm.dts[stage][j0] : 0.f;
        const float m01 = i >= j0 + 1 ? cb0.y * expf(di - sm.dacs[j0 + 1]) * sm.dts[stage][j0 + 1] : 0.f;
        const float m10 = i >= j1 ? cb1.x * expf(di - sm.dacs[j1]) * sm.dts[stage][j1] : 0.f;
        const float m11 = i >= j1 + 1 ? cb1.y * expf(di - sm.dacs[j1 + 1]) * sm.dts[stage][j1 + 1] : 0.f;
        uint32_t bh0, bl0, bh1, bl1;
        split_bf16x2(m00, m01, bh0, bl0);
        split_bf16x2(m10, m11, bh1, bl1);
        mma_16816(y[n], xf, bh0, bh1);
        mma_16816(y[n], xf, bl0, bl1);
      }
      uint32_t wh[4], wlo[4];
      const float w00 = sm.wl[j0], w01 = sm.wl[j0 + 1], w10 = sm.wl[j1], w11 = sm.wl[j1 + 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv = tc::unpack_bf16x2(xf[r]);
        const float wa = r < 2 ? w00 : w10;
        const float wb = r < 2 ? w01 : w11;
        split_bf16x2(xv.x * wa, xv.y * wb, wh[r], wlo[r]);
      }
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {  // state column tiles 2np, 2np + 1
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &sm.bs[stage][kk * 16 + (lane & 15)][np * 16 + (lane >> 4) * 8]);
        mma_16816(st[2 * np], wh, bf[0], bf[1]);
        mma_16816(st[2 * np], wlo, bf[0], bf[1]);
        mma_16816(st[2 * np + 1], wh, bf[2], bf[3]);
        mma_16816(st[2 * np + 1], wlo, bf[2], bf[3]);
      }
    }

    // ---- y out: transposed into ys as bf16, then 16-byte rows
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = n * 8 + 2 * t;
      const int p = warp * 16 + g;
      sm.ys[i][p] = __float2bfloat16_rn(y[n][0]);
      sm.ys[i + 1][p] = __float2bfloat16_rn(y[n][1]);
      sm.ys[i][p + 8] = __float2bfloat16_rn(y[n][2]);
      sm.ys[i + 1][p + 8] = __float2bfloat16_rn(y[n][3]);
    }
    __syncthreads();
    for (int idx = tid; idx < kL * (kP / 8); idx += kMmaThreads) {
      const int r = idx / (kP / 8);
      const int col = (idx % (kP / 8)) * 8;
      if (r >= rows || col >= P) continue;
      __nv_bfloat16* dst = yb + static_cast<long long>(s0 + r) * H * P + col;
      if (vec && col + 8 <= P) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&sm.ys[r][col]);
      } else {
        for (int e = 0; e < 8 && col + e < P; ++e) dst[e] = sm.ys[r][col + e];
      }
    }
  }

  float* sb = a.state + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + g + (e >> 1) * 8;
      const int col = n * 8 + 2 * t + (e & 1);
      if (p < P && col < N) sb[p * N + col] = st[n][e];
    }
}

int launch_f32(const SsdArgs& a, int device, cudaStream_t stream) {
  const int e = tc::opt_in_smem<&ssd_f32_kernel>(device, kF32SmemBytes);
  if (e != 0) return e;
  ssd_f32_kernel<<<dim3(a.H, a.Bsz), kThreads, kF32SmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const SsdArgs& a, int device, cudaStream_t stream) {
  const int n_chunks = (a.S + a.L - 1) / a.L;
  if (n_chunks > 0) {
    ssd_cb_mma_kernel<<<dim3(n_chunks, a.Bsz), kMmaThreads, kCbSmemBytes, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int e = tc::opt_in_smem<&ssd_mma_kernel>(device, sizeof(ScanSmem));
  if (e != 0) return e;
  ssd_mma_kernel<<<dim3(a.H, a.Bsz), kMmaThreads, sizeof(ScanSmem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success).  x, B and C
// share one dtype (f32: is_bf16 = 0; bf16: is_bf16 = 1) and are read by the
// given batch and sequence strides (innermost dims contiguous); dt, A, y and
// state are contiguous.  cb (bf16 only; may be null for f32) is f32 scratch
// of B · ceil(S / L) · 64 · 64 elements.  1 ≤ P ≤ 64, 1 ≤ N ≤ 128,
// 1 ≤ L ≤ 64 (the caller checked them).
extern "C" int ssd_scan_launch(
    void* y, float* state, float* cb, const void* x, const float* dt, const float* A,
    const void* bm, const void* cm, int Bsz, int S, int H, int P, int N, int L, long long x_sb,
    long long x_ss, long long b_sb, long long b_ss, long long c_sb, long long c_ss, int is_bf16,
    int device, void* stream) {
  if (Bsz < 0 || S < 0 || H < 0 || P < 1 || P > kP || N < 1 || N > kN || L < 1 || L > kL ||
      (is_bf16 && cb == nullptr && S > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Bsz == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = P % 8 == 0 && x_sb % 8 == 0 && x_ss % 8 == 0 && b_sb % 8 == 0 &&
                  b_ss % 8 == 0 && c_sb % 8 == 0 && c_ss % 8 == 0 && aligned(y) && aligned(x) &&
                  aligned(bm) && aligned(cm);
  const SsdArgs a{y, state, cb, x, dt, A, bm, cm, Bsz, S, H, P, N, L,
                  x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_mma(a, device, s) : launch_f32(a, device, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
