// tensor_core.cuh: what the kernels of flash_attention.cu and ssd_scan.cu
// share, for Hopper (sm_90a): the warp-level tensor-core building blocks of
// their bf16 routes — mma.sync m16n8k16 (bf16 × bf16 → f32), ldmatrix,
// cp.async, a tile loader, and the split of an f32 operand into two bf16
// pieces — and the per-device opt-in to large dynamic shared memory.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//
//   A (16 × 16, row-major)  a0: (g, 2t..2t+1)   a1: (g+8, 2t..2t+1)
//                           a2: (g, 2t+8..+9)   a3: (g+8, 2t+8..+9)
//   B (16 × 8, k × n)       b0: (k 2t..2t+1, n g)   b1: (k 2t+8..+9, n g)
//   C (16 × 8, f32)         c0, c1: (g, 2t..2t+1)   c2, c3: (g+8, 2t..2t+1)
//
// So the accumulators of two neighbouring n8 tiles are, element for
// element, the A fragment of one k16 step: a product's result feeds the
// next product from registers (FlashAttention-2's P·V, the SSD state).
//
// The split: an f32 value v enters a bf16 product as hi = bf16(v) and
// lo = bf16(v − hi), two products summed in the f32 accumulator.  hi + lo
// keeps about 16 bits of v's 24, so the product is within ~2^-17 of the f32
// one, where one bf16 piece (8 bits) is within ~2^-9: enough to move a bf16
// output by several ulps, and an f32 state far past its 1e-5 tolerance
// (tests/test_torch_kernel_precision.py pins both).  An operand that is
// already bf16 (q, k, v, x, B, C as the model hands them over) enters as it
// is: a bf16 × bf16 product is exact in the f32 accumulator.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared without a trip through registers; both
// addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 × 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives matrix i's (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// The same, transposed: register i receives matrix i's (rows 2t..2t+1,
// column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a · b on one m16n8k16 tile, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one bf16x2 register, the first in the low half (the
// lower column index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// (x, y) → hi = bf16x2(x, y) and lo = bf16x2(x − hi.x, y − hi.y).
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(x, y);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(x - h.x, y - h.y);
}

// Rows 0..ROWS−1 of a row-strided bf16 matrix into a shared tile of rows
// padded to COLS + 8 elements (16 bytes: the 8 rows an ldmatrix reads then
// fall in 8 different bank groups).  Rows ≥ nrows and columns ≥ ncols are
// zero-filled.  vec: every row start is 16-byte aligned, so a full 16-byte
// chunk goes by cp.async (the caller commits and waits); a ragged last chunk
// goes element by element.
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          long long row_stride, int nrows, int ncols, bool vec,
                                          int tid) {
  constexpr int kChunks = COLS / 8;
  for (int idx = tid; idx < ROWS * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    __nv_bfloat16* dst = tile + r * (COLS + 8) + c;
    if (r >= nrows || c >= ncols) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec && c + 8 <= ncols) {
      cp_async_16(dst, base + r * row_stride + c);
    } else {
      const __nv_bfloat16* src = base + r * row_stride;
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = c + e < ncols ? src[c + e] : __float2bfloat16_rn(0.f);
    }
  }
}

// cudaFuncSetAttribute applies to the current device, so a kernel that
// needs more than the 48 KB default of dynamic shared memory opts in per
// device.  The attribute tracks the largest amount asked for so far: a
// kernel whose shared memory grows with its shapes (the server fold's
// stages) is raised when a launch needs more, and a request beyond the
// card's limit comes back as the error.  Returns a cudaError_t (0 =
// success).
constexpr int kMaxDevices = 64;

template <auto Kernel>
int opt_in_smem(int device, size_t bytes) {
  static size_t granted[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > granted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted[device] = bytes;
  }
  return 0;
}

}  // namespace tc
