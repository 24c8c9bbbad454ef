// Non-causal flash attention forward with fp32 logits and online softmax.
// q [B, N, H, DH], k/v [B, M, H, DH] (bf16 or f32) -> out [B, N, H, DH] in
// the input type, and optionally lse [B, H, N] f32.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/flash_attention.py _flash_fwd
// (_fwd_kernel / _fwd_kernel_nolse). On the H100 the ViT calls (DH=64) are
// bound by the two products and the CTA calls (DH=16) by the N*M exps. This
// first version uses fp32 FMAs: one thread per query row keeps q and the
// accumulator in registers; a block of 128 rows stages 64-key K/V tiles in
// shared memory (read as broadcasts); keys are folded into the running
// max/normalizer 16 at a time so the rescale exp is paid once per chunk.
// Tails in N and M are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int BN = 128;  // query rows per block, one per thread
constexpr int BM = 64;   // keys per shared-memory tile
constexpr int CH = 16;   // keys per online-softmax update
constexpr float NEG = -1e30f;

template <typename T, int DH>
__global__ void __launch_bounds__(BN)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int n, int m, int h,
                 float scale) {
  __shared__ __align__(16) float ks[BM][DH];
  __shared__ __align__(16) float vs[BM][DH];
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int row = blockIdx.x * BN + threadIdx.x;
  const bool active = row < n;
  const int64_t rs = (int64_t)h * DH;  // stride between tokens
  const T* qb = q + (int64_t)b * n * rs + hh * DH;
  const T* kb = k + (int64_t)b * m * rs + hh * DH;
  const T* vb = v + (int64_t)b * m * rs + hh * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? to_f32(qb[row * rs + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float mx = NEG, l = 0.f;

  for (int t0 = 0; t0 < m; t0 += BM) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * DH; idx += BN) {
      const int j = idx / DH, d = idx % DH;
      const int key = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < m) {
        kv = to_f32(kb[key * rs + d]);
        vv = to_f32(vb[key * rs + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    const int tn = min(BM, m - t0);
    for (int c0 = 0; c0 < tn; c0 += CH) {
      float s[CH];
      float cmax = NEG;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks[c0 + j]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kk = kr[d4];
          dot += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y + qr[4 * d4 + 2] * kk.z +
                 qr[4 * d4 + 3] * kk.w;
        }
        s[j] = (c0 + j < tn) ? dot : NEG;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(mx, cmax);
      const float alpha = __expf(mx - mnew);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float p = __expf(s[j] - mnew);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[c0 + j]);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += p * vv.x;
          acc[4 * d4 + 1] += p * vv.y;
          acc[4 * d4 + 2] += p * vv.z;
          acc[4 * d4 + 3] += p * vv.w;
        }
      }
      mx = mnew;
    }
  }
  if (!active) return;
  const float inv = 1.f / l;
  T* ob = out + (int64_t)b * n * rs + hh * DH + row * rs;
#pragma unroll
  for (int d = 0; d < DH; ++d) store(ob + d, acc[d] * inv);
  if (lse != nullptr) lse[(int64_t)bh * n + row] = mx + logf(l);
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int n, int m, int h, int dh, float scale, cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, b * h);
  if (dh == 16) {
    flash_fwd_kernel<T, 16><<<grid, BN, 0, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                 (T*)out, lse, n, m, h, scale);
  } else {
    flash_fwd_kernel<T, 64><<<grid, BN, 0, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                 (T*)out, lse, n, m, h, scale);
  }
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int b, int n, int m, int h, int dh, float scale,
                                   int dtype, void* stream) {
  if (dh != 16 && dh != 64) return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, out, (float*)lse, b, n, m, h, dh, scale, st);
  } else {
    launch<float>(q, k, v, out, (float*)lse, b, n, m, h, dh, scale, st);
  }
  return (int)cudaGetLastError();
}
