// Stride-1 "same" zero-padded odd-k 2D conv, NHWC, fp32 accumulation:
// x [B, H, W, Ci], w [K, K, Ci, Co] -> out [B, H, W, Co] (input type), no bias.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/conv2d.py _conv2d_fwd_impl
// (_kernel). On the H100 the narrow-channel full-resolution convs are bound
// by memory. A block computes a TH x TW tile of output pixels for COT output
// channels; per chunk of CIC input channels it stages the zero-padded input
// halo tile ([ci][y][x]: neighbouring threads read neighbouring words) and
// the chunk's weights (broadcast reads) in shared memory, and each thread
// accumulates its pixel's COT outputs in registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int TH = 8, TW = 32, NT = TH * TW, CIC = 8;

template <int K, int COT>
constexpr int smem_bytes() {
  return (CIC * (TH + K - 1) * (TW + K - 1) + K * K * CIC * COT) * 4;
}

template <typename T, int K, int COT>
__global__ void __launch_bounds__(NT)
conv2d_same_kernel(const T* __restrict__ x, const T* __restrict__ wgt, T* __restrict__ out,
                   int h, int w, int ci, int co, int ncot) {
  constexpr int P = (K - 1) / 2;
  constexpr int IH = TH + 2 * P, IW = TW + 2 * P;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;                   // [CIC][IH][IW]
  float* w_s = smem + CIC * IH * IW;    // [K*K][CIC][COT]
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / ncot;
  const int co0 = (blockIdx.z % ncot) * COT;
  const T* xb = x + (int64_t)b * h * w * ci;

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += CIC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < IH * IW * CIC; idx += NT) {
      const int cc = idx % CIC, p = idx / CIC;
      const int yy = p / IW, xx = p % IW;
      const int gy = y0 + yy - P, gx = x0 + xx - P, gc = c0 + cc;
      float val = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && gc < ci)
        val = to_f32(xb[((int64_t)gy * w + gx) * ci + gc]);
      in_s[(cc * IH + yy) * IW + xx] = val;
    }
    for (int idx = threadIdx.x; idx < K * K * CIC * COT; idx += NT) {
      const int oc = idx % COT, r = idx / COT;
      const int cc = r % CIC, tap = r / CIC;
      const int gc = c0 + cc, gco = co0 + oc;
      w_s[idx] = (gc < ci && gco < co) ? to_f32(wgt[((int64_t)tap * ci + gc) * co + gco]) : 0.f;
    }
    __syncthreads();
    const int nci = min(CIC, ci - c0);
    for (int cc = 0; cc < nci; ++cc) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float xv = in_s[(cc * IH + ty + dy) * IW + tx + dx];
          const float4* wr = reinterpret_cast<const float4*>(w_s + ((dy * K + dx) * CIC + cc) * COT);
#pragma unroll
          for (int c4 = 0; c4 < COT / 4; ++c4) {
            const float4 ww = wr[c4];
            acc[4 * c4] += xv * ww.x;
            acc[4 * c4 + 1] += xv * ww.y;
            acc[4 * c4 + 2] += xv * ww.z;
            acc[4 * c4 + 3] += xv * ww.w;
          }
        }
      }
    }
  }
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy >= h || ox >= w) return;
  T* op = out + (((int64_t)b * h + oy) * w + ox) * co + co0;
#pragma unroll
  for (int c = 0; c < COT; ++c)
    if (co0 + c < co) store(op + c, acc[c]);
}

template <typename T, int K, int COT>
static int launch(const void* x, const void* wgt, void* out, int b, int h, int w, int ci, int co,
                  cudaStream_t st) {
  constexpr int bytes = smem_bytes<K, COT>();
  auto kern = conv2d_same_kernel<T, K, COT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int ncot = (co + COT - 1) / COT;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b * ncot);
  kern<<<grid, NT, bytes, st>>>((const T*)x, (const T*)wgt, (T*)out, h, w, ci, co, ncot);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static int launch_k(const void* x, const void* wgt, void* out, int b, int h, int w, int ci,
                    int co, cudaStream_t st) {
  if (co % 32 == 0) return launch<T, K, 32>(x, wgt, out, b, h, w, ci, co, st);
  if (co % 16 == 0) return launch<T, K, 16>(x, wgt, out, b, h, w, ci, co, st);
  return launch<T, K, 8>(x, wgt, out, b, h, w, ci, co, st);
}

template <typename T>
static int launch_t(const void* x, const void* wgt, void* out, int b, int h, int w, int ci,
                    int co, int k, cudaStream_t st) {
  switch (k) {
    case 3: return launch_k<T, 3>(x, wgt, out, b, h, w, ci, co, st);
    case 5: return launch_k<T, 5>(x, wgt, out, b, h, w, ci, co, st);
    case 7: return launch_k<T, 7>(x, wgt, out, b, h, w, ci, co, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int conv2d_same(const void* x, const void* wgt, void* out, int b, int h, int w, int ci,
                           int co, int k, int dtype, void* stream) {
  if ((int64_t)b * h * w * co == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_t<__nv_bfloat16>(x, wgt, out, b, h, w, ci, co, k, st);
  return launch_t<float>(x, wgt, out, b, h, w, ci, co, k, st);
}
