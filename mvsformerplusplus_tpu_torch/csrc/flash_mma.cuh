// Fragment helpers shared by the bf16 tensor-core flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): 16-byte cp.async with zero
// fill, ldmatrix (plain and transposed), the m16n8k16 bf16 mma with f32
// accumulators, ex2.approx and the f32 -> bf16x2 pack.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// c = (lane % 4) * 2):
//   A 16x16 (row): a0 = A[g][c..c+1], a1 = A[g+8][c..], a2 = A[g][c+8..],
//                  a3 = A[g+8][c+8..];
//   B 16x8  (col): b0 = B[c..c+1][g], b1 = B[c+8..c+9][g];
//   C 16x8  (f32): c0, c1 = C[g][c..c+1], c2, c3 = C[g+8][c..c+1].
// So the accumulators of two adjacent n-tiles are, packed to bf16x2, the A
// fragment of one k16 step: the probabilities never leave registers.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past `src_bytes` (0 or
// 16) are written as zeros, so a masked row never exposes stale shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// d += a * b on the tensor cores (bf16 operands, f32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (ex2(-inf) = +0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to nearest bf16, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Row-address offsets (in elements, within a tile whose rows are `ld`
// elements apart) that lane gives ldmatrix_x4 for the three operand shapes:
//  a_off: the A fragment of rows r0..r0+15, columns c0..c0+15;
//  b_off: two B fragments (n-tiles n0, n0+8) from a tile stored [n][k]
//         (rows n, columns k: plain ldmatrix);
//  bt_off: two B fragments (n-tiles n0, n0+8) from a tile stored [k][n]
//          (rows k, columns n: ldmatrix .trans).
__device__ __forceinline__ int a_off(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int n0, int k0, int ld) {
  return (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int k0, int n0, int ld) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}
// The A fragment of rows m0..m0+15, columns k0..k0+15 from a tile stored
// transposed, [k][m] (ldmatrix .trans).
__device__ __forceinline__ int at_off(int lane, int m0, int k0, int ld) {
  return (k0 + (lane >> 4) * 8 + (lane & 7)) * ld + m0 + ((lane >> 3) & 1) * 8;
}

// Rows [row0, row0 + ROWS) of a [*, h, DH] bf16 tensor's head slice (row
// stride rs elements) into a shared tile with rows `ld` elements apart, 16
// bytes per thread per step over `nthreads` threads; rows >= limit are zeros.
template <int ROWS, int DH>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src, int64_t rs,
                                                int row0, int limit, int tid, int nthreads) {
  constexpr int CH = DH / 8;
  for (int c = tid; c < ROWS * CH; c += nthreads) {
    const int r = c / CH, cc = c % CH;
    const int row = row0 + r;
    const bool in = row < limit;
    cp_async16(dst + r * ld + cc * 8, src + (int64_t)(in ? row : 0) * rs + cc * 8, in ? 16 : 0);
  }
}

}  // namespace flash
