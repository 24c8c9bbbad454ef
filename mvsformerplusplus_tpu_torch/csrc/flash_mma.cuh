// Fragment helpers shared by the tensor-core flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): 16-byte cp.async with zero
// fill, ldmatrix (plain and transposed), the m16n8k16 bf16 mma and the
// m16n8k8 tf32 mma with f32 accumulators, the fp32 -> tf32 big/small split,
// ex2.approx and the f32 -> bf16x2 pack.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// c = (lane % 4) * 2):
//   A 16x16 (row): a0 = A[g][c..c+1], a1 = A[g+8][c..], a2 = A[g][c+8..],
//                  a3 = A[g+8][c+8..];
//   B 16x8  (col): b0 = B[c..c+1][g], b1 = B[c+8..c+9][g];
//   C 16x8  (f32): c0, c1 = C[g][c..c+1], c2, c3 = C[g+8][c..c+1].
// So the accumulators of two adjacent n-tiles are, packed to bf16x2, the A
// fragment of one k16 step: the probabilities never leave registers.
//
// mma.sync.m16n8k8 with tf32 operands (t = lane % 4), one 32-bit value a
// register:
//   A 16x8 (row): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
//   B 8x8  (col): b0 = B[t][g], b1 = B[t+4][g];
//   C 16x8 (f32): as above, c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..].
// ldmatrix moves 16-bit pairs: on fp32 rows an 8x8 b16 matrix is 8 rows of
// 4 floats and lane i receives row i/4, float i%4, which is A's (g, t) and,
// from a tile stored [n][k], B's. Its .trans form transposes 16-bit halves,
// not floats, so a B operand stored [k][n] is read with 32-bit loads.
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

// d += a * b on the tensor cores, tf32 operands (the low 13 bits of each
// register are ignored), f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small: big is x rounded to tf32 (10 mantissa bits) to nearest,
// ties away from zero, cvt.rna.tf32.f32's rounding done by bit mask; small
// is x - big (exact in fp32) rounded the same way, its low 13 bits left in
// place since the tensor cores ignore them (as nvcc's own cvt.rna does for
// an mma operand). Integer ops: cvt.rna adds a NaN guard the split needs not,
// a NaN propagating through small. Registers hold the raw fp32 bits.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big)) + 0x1000u;
}

// d += a * b at fp32 accuracy on the tf32 tensor cores (3xTF32): the two
// cross terms small*big and big*small first, then big*big, CUTLASS's order
// (its OpMultiplyAddFastF32); small*small, about 2^-22 relative, is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
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
// The same offsets for fp32 tiles (in floats, rows `ld` floats apart) and the
// tf32 m16n8k8 fragments, whose k step is 8 floats:
//  a_off_f32: the A fragment of rows r0..r0+15, columns c0..c0+7;
//  b_off_f32: two B fragments (n-tiles n0, n0+8), columns k0..k0+7, from a
//             tile stored [n][k].
__device__ __forceinline__ int a_off_f32(int lane, int r0, int c0, int ld) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 4;
}
__device__ __forceinline__ int b_off_f32(int lane, int n0, int k0, int ld) {
  return (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 4;
}

// Rows [row0, row0 + ROWS) of a [*, h, DH] bf16 or f32 tensor's head slice
// (row stride rs elements) into a shared tile with rows `ld` elements apart,
// 16 bytes per thread per step over `nthreads` threads; rows >= limit are
// zeros.
template <int ROWS, int DH, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src, int64_t rs,
                                                int row0, int limit, int tid, int nthreads) {
  constexpr int PER = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int CH = DH / PER;
  for (int c = tid; c < ROWS * CH; c += nthreads) {
    const int r = c / CH, cc = c % CH;
    const int row = row0 + r;
    const bool in = row < limit;
    cp_async16(dst + r * ld + cc * PER, src + (int64_t)(in ? row : 0) * rs + cc * PER,
               in ? 16 : 0);
  }
}

}  // namespace flash
