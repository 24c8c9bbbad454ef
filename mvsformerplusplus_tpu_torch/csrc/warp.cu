// Plane-sweep warp: bilinear sample of src [B, H, W, C] at pixel-unit (x, y)
// coords [B, N, 2] -> out [B, N, C] f32, exact grid_sample(bilinear, zeros,
// align_corners=True) semantics: each of the four corners contributes its
// bilinear weight only when it lies inside the image.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/warp_band.py
// banded_warp_blocked_fused. Memory-bound on the H100 (the f32 output write
// dominates); one thread per (sample, channel) with the channel fastest keeps
// the output write coalesced, and the C threads of one sample share its
// coordinate load and corner rows through L1.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void warp_bilinear_kernel(const T* __restrict__ src, const float* __restrict__ coords,
                                     float* __restrict__ out, int h, int w, int c,
                                     int64_t nsamp, int64_t total) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int ch = (int)(i % c);
  int64_t s = i / c;                 // flat (b, n) sample index
  int64_t b = s / nsamp;
  float x = coords[2 * s];
  float y = coords[2 * s + 1];
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  const T* img = src + b * (int64_t)h * w * c + ch;
  float acc = 0.f;
  // corner order and weights as the plain version: (y0,x0) (y0,x1) (y1,x0) (y1,x1)
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    float cy = y0 + dy;
    float wy = dy ? fy : 1.f - fy;
    bool yin = cy >= 0.f && cy <= (float)(h - 1);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      float cx = x0 + dx;
      float wx = dx ? fx : 1.f - fx;
      if (yin && cx >= 0.f && cx <= (float)(w - 1)) {
        int64_t off = ((int64_t)cy * w + (int64_t)cx) * c;
        acc += to_f32(img[off]) * (wy * wx);
      }
    }
  }
  out[i] = acc;
}

extern "C" int warp_bilinear(const void* src, const void* coords, void* out, int b, int h,
                             int w, int c, int nsamp, int dtype, void* stream) {
  int64_t total = (int64_t)b * nsamp * c;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    warp_bilinear_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)src, (const float*)coords, (float*)out, h, w, c, nsamp, total);
  } else {
    warp_bilinear_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)src, (const float*)coords, (float*)out, h, w, c, nsamp, total);
  }
  return (int)cudaGetLastError();
}
