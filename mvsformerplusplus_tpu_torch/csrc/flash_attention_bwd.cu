// Non-causal flash attention backward (FA2 from the saved logsumexp):
// q [B, N, H, DH], k/v [B, M, H, DH], dout [B, N, H, DH] (bf16 or f32),
// lse and delta = rowsum(dout * out) [B, H, N] f32 -> dq [B, N, H, DH] and
// dk/dv [B, M, H, DH] in the input type. Probabilities are rebuilt as
// p = exp(scale q.k - lse); ds = p (dout.v - delta); dv = sum_i p dout_i,
// dk = sum_i ds (scale q_i), dq = scale sum_j ds k_j (with respect to the
// unscaled q). Nothing [N, M]-shaped touches device memory.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/flash_attention.py _flash_bwd
// (_bwd_dkv_kernel, _bwd_dq_kernel). On the H100 the CTA backward (DH=16,
// ~5k tokens at the train crop) is bound by the N*M exponentials, which the
// two-kernel split computes twice. This first version uses fp32 FMAs, as the
// forward does: flash_bwd_dkv_kernel gives each thread one key row (k, v and
// the dk/dv accumulators in registers) and streams 32-query tiles of scaled
// q, dout, lse and delta through shared memory (read as broadcasts);
// flash_bwd_dq_kernel gives each thread one query row (q, dout and the dq
// accumulator in registers) and streams 64-key K/V tiles. Tails in N and M
// are masked. At DH=64 (the ViT, frozen on the train path) the dk/dv
// kernel's four register rows exceed the register file and spill.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int BK = 128;  // dk/dv: key rows per block, one per thread
constexpr int BQ = 32;   // dk/dv: query rows per shared-memory tile
constexpr int BN = 128;  // dq: query rows per block, one per thread
constexpr int BM = 64;   // dq: key rows per shared-memory tile

template <typename T, int DH>
__global__ void __launch_bounds__(BK)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int n, int m, int h, float scale) {
  __shared__ __align__(16) float qs[BQ][DH];
  __shared__ __align__(16) float dos[BQ][DH];
  __shared__ float lse_s[BQ], delta_s[BQ];
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int key = blockIdx.x * BK + threadIdx.x;
  const bool active = key < m;
  const int64_t rs = (int64_t)h * DH;  // stride between tokens
  const T* qb = q + (int64_t)b * n * rs + hh * DH;
  const T* dob = dout + (int64_t)b * n * rs + hh * DH;
  const int64_t koff = (int64_t)b * m * rs + hh * DH + key * rs;
  const float* lseb = lse + (int64_t)bh * n;
  const float* deltab = delta + (int64_t)bh * n;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kr[d] = active ? to_f32(k[koff + d]) : 0.f;
    vr[d] = active ? to_f32(v[koff + d]) : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }

  for (int t0 = 0; t0 < n; t0 += BQ) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * DH; idx += BK) {
      const int i = idx / DH, d = idx % DH;
      const int row = t0 + i;
      const bool in = row < n;
      qs[i][d] = in ? to_f32(qb[row * rs + d]) * scale : 0.f;
      dos[i][d] = in ? to_f32(dob[row * rs + d]) : 0.f;
    }
    for (int i = threadIdx.x; i < BQ; i += BK) {
      const int row = t0 + i;
      lse_s[i] = row < n ? lseb[row] : 0.f;
      delta_s[i] = row < n ? deltab[row] : 0.f;
    }
    __syncthreads();
    const int tq = min(BQ, n - t0);
    for (int i = 0; i < tq; ++i) {
      const float4* qr4 = reinterpret_cast<const float4*>(qs[i]);
      const float4* do4 = reinterpret_cast<const float4*>(dos[i]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 qq = qr4[d4], oo = do4[d4];
        s += qq.x * kr[4 * d4] + qq.y * kr[4 * d4 + 1] + qq.z * kr[4 * d4 + 2] +
             qq.w * kr[4 * d4 + 3];
        dp += oo.x * vr[4 * d4] + oo.y * vr[4 * d4 + 1] + oo.z * vr[4 * d4 + 2] +
              oo.w * vr[4 * d4 + 3];
      }
      const float p = __expf(s - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 qq = qr4[d4], oo = do4[d4];
        dvr[4 * d4] += p * oo.x;
        dvr[4 * d4 + 1] += p * oo.y;
        dvr[4 * d4 + 2] += p * oo.z;
        dvr[4 * d4 + 3] += p * oo.w;
        dkr[4 * d4] += ds * qq.x;
        dkr[4 * d4 + 1] += ds * qq.y;
        dkr[4 * d4 + 2] += ds * qq.z;
        dkr[4 * d4 + 3] += ds * qq.w;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    store(dk + koff + d, dkr[d]);
    store(dv + koff + d, dvr[d]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(BN)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int n, int m, int h,
                    float scale) {
  __shared__ __align__(16) float ks[BM][DH];
  __shared__ __align__(16) float vs[BM][DH];
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int row = blockIdx.x * BN + threadIdx.x;
  const bool active = row < n;
  const int64_t rs = (int64_t)h * DH;
  const int64_t qoff = (int64_t)b * n * rs + hh * DH + row * rs;
  const T* kb = k + (int64_t)b * m * rs + hh * DH;
  const T* vb = v + (int64_t)b * m * rs + hh * DH;

  float qr[DH], dor[DH], dqr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? to_f32(q[qoff + d]) * scale : 0.f;
    dor[d] = active ? to_f32(dout[qoff + d]) : 0.f;
    dqr[d] = 0.f;
  }
  const float l = active ? lse[(int64_t)bh * n + row] : 0.f;
  const float dl = active ? delta[(int64_t)bh * n + row] : 0.f;

  for (int t0 = 0; t0 < m; t0 += BM) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * DH; idx += BN) {
      const int j = idx / DH, d = idx % DH;
      const int key = t0 + j;
      ks[j][d] = key < m ? to_f32(kb[key * rs + d]) : 0.f;
      vs[j][d] = key < m ? to_f32(vb[key * rs + d]) : 0.f;
    }
    __syncthreads();
    const int tn = min(BM, m - t0);
    for (int j = 0; j < tn; ++j) {
      const float4* kr4 = reinterpret_cast<const float4*>(ks[j]);
      const float4* vr4 = reinterpret_cast<const float4*>(vs[j]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr4[d4], vv = vr4[d4];
        s += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y + qr[4 * d4 + 2] * kk.z +
             qr[4 * d4 + 3] * kk.w;
        dp += dor[4 * d4] * vv.x + dor[4 * d4 + 1] * vv.y + dor[4 * d4 + 2] * vv.z +
              dor[4 * d4 + 3] * vv.w;
      }
      const float ds = __expf(s - l) * (dp - dl);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr4[d4];
        dqr[4 * d4] += ds * kk.x;
        dqr[4 * d4 + 1] += ds * kk.y;
        dqr[4 * d4 + 2] += ds * kk.z;
        dqr[4 * d4 + 3] += ds * kk.w;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) store(dq + qoff + d, dqr[d] * scale);
}

template <typename T, int DH>
static void launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int b, int n,
                       int m, int h, float scale, cudaStream_t st) {
  dim3 grid((m + BK - 1) / BK, b * h);
  flash_bwd_dkv_kernel<T, DH><<<grid, BK, 0, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                   (const T*)dout, lse, delta, (T*)dk, (T*)dv,
                                                   n, m, h, scale);
}

template <typename T, int DH>
static void launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int b, int n, int m,
                      int h, float scale, cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, b * h);
  flash_bwd_dq_kernel<T, DH><<<grid, BN, 0, st>>>((const T*)q, (const T*)k, (const T*)v,
                                                  (const T*)dout, lse, delta, (T*)dq, n, m, h,
                                                  scale);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int n, int m, int h, int dh,
                                       float scale, int dtype, void* stream) {
  if (dh != 16 && dh != 64) return (int)cudaErrorInvalidValue;
  if (b * m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 1) {
    if (dh == 16) launch_dkv<__nv_bfloat16, 16>(q, k, v, dout, l, dl, dk, dv, b, n, m, h, scale, st);
    else launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk, dv, b, n, m, h, scale, st);
  } else {
    if (dh == 16) launch_dkv<float, 16>(q, k, v, dout, l, dl, dk, dv, b, n, m, h, scale, st);
    else launch_dkv<float, 64>(q, k, v, dout, l, dl, dk, dv, b, n, m, h, scale, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, int b, int n, int m, int h, int dh, float scale,
                                      int dtype, void* stream) {
  if (dh != 16 && dh != 64) return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (dtype == 1) {
    if (dh == 16) launch_dq<__nv_bfloat16, 16>(q, k, v, dout, l, dl, dq, b, n, m, h, scale, st);
    else launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, b, n, m, h, scale, st);
  } else {
    if (dh == 16) launch_dq<float, 16>(q, k, v, dout, l, dl, dq, b, n, m, h, scale, st);
    else launch_dq<float, 64>(q, k, v, dout, l, dl, dq, b, n, m, h, scale, st);
  }
  return (int)cudaGetLastError();
}
