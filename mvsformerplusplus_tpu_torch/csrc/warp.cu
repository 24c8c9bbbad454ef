// Plane-sweep warp: bilinear sample of src [B, H, W, C] at pixel-unit (x, y)
// coords [B, N, 2] -> out [B, N, C] f32, exact grid_sample(bilinear, zeros,
// align_corners=True) semantics: each of the four corners contributes its
// bilinear weight only when it lies inside the image.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/warp_band.py
// banded_warp_blocked_fused (and the other warp rows, ops/cuda/warp.py).
//
// Bound on the H100: the bytes (the f32 output, 4 bytes per element, and the
// f32 coordinates), provided each element costs few instructions; a thread
// per (sample, channel) that repeats the sample's coordinate work for each
// channel and divides 64-bit indices is instruction-bound instead, its time
// set by the element count whatever C is. So the vector variant is
// sample-major: a thread owns one sample and one 16-byte vector of channels
// (8 bf16 or 4 f32), C is a template parameter (channel arithmetic is shifts
// and masks), the batch comes from blockIdx.y, and indices are 32-bit up to
// the final pointer offset. The per-sample preamble (one float2 coordinate load,
// floorf, four weights, four bound tests) runs once per vector; each inside
// corner is one 16-byte read-only load (at C = 8 bf16 the two x neighbours
// of a corner row are one 32-byte sector), and the output goes out as
// 16-byte evict-first stores, so it does not push the source rows out of L2.
// The scalar variant (one thread per sample, a loop over channels, 32-bit
// indexing) takes any C that is not a multiple of the vector or a source not
// on a 16-byte boundary; no full-width path reaches it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "warp_corners.cuh"

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// acc[0..VEC) += weight x the 16 bytes `raw` holds (8 bf16 or 4 f32)
__device__ __forceinline__ void add_weighted(float (&acc)[8], uint4 raw, float wt) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[2 * j] += __uint_as_float(u[j] << 16) * wt;
    acc[2 * j + 1] += __uint_as_float(u[j] & 0xffff0000u) * wt;
  }
}

__device__ __forceinline__ void add_weighted(float (&acc)[4], uint4 raw, float wt) {
  acc[0] += __uint_as_float(raw.x) * wt;
  acc[1] += __uint_as_float(raw.y) * wt;
  acc[2] += __uint_as_float(raw.z) * wt;
  acc[3] += __uint_as_float(raw.w) * wt;
}

template <typename T, int C>
__global__ void __launch_bounds__(256) warp_bilinear_vec_kernel(
    const T* __restrict__ src, const float2* __restrict__ coords, float* __restrict__ out, int h,
    int w, int nsamp) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr unsigned G = C / VEC;  // threads per sample, a power of two
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (unsigned)nsamp * G) return;
  const unsigned s = i / G, v = i % G;
  const int64_t sample = (int64_t)blockIdx.y * nsamp + s;
  const float2 xy = __ldg(coords + sample);
  const Corners k = bilinear_corners(xy.x, xy.y, h, w);
  const T* img = src + (int64_t)blockIdx.y * h * w * C + v * VEC;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (k.pix[q] >= 0) {
      add_weighted(acc, __ldg(reinterpret_cast<const uint4*>(img + k.pix[q] * C)), k.wt[q]);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + sample * C + v * VEC);
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j) {
    __stcs(o + j, make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(256) warp_bilinear_scalar_kernel(
    const T* __restrict__ src, const float* __restrict__ coords, float* __restrict__ out, int h,
    int w, int c, int nsamp) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nsamp) return;
  const int64_t sample = (int64_t)blockIdx.y * nsamp + s;
  const Corners k = bilinear_corners(coords[2 * sample], coords[2 * sample + 1], h, w);
  const T* img = src + (int64_t)blockIdx.y * h * w * c;
  float* o = out + sample * c;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k.pix[q] >= 0) acc += to_f32(img[k.pix[q] * c + ch]) * k.wt[q];
    }
    o[ch] = acc;
  }
}

static unsigned int blocks_for(int64_t threads_needed, int threads) {
  return (unsigned int)((threads_needed + threads - 1) / threads);
}

template <typename T, int C>
static int launch_vec(const void* src, const void* coords, void* out, int b, int h, int w,
                      int nsamp, cudaStream_t st) {
  const int threads = 256;
  const dim3 grid(blocks_for((int64_t)nsamp * (C * sizeof(T) / 16), threads), b);
  warp_bilinear_vec_kernel<T, C><<<grid, threads, 0, st>>>(
      (const T*)src, (const float2*)coords, (float*)out, h, w, nsamp);
  return (int)cudaGetLastError();
}

// The channel counts the vector variant is built for; ops/cuda/warp.py
// VEC_CHANNELS lists the same (a CPU test reads these lines).
#define WARP_VEC_CASE(T, C) \
  case C:                   \
    return launch_vec<T, C>(src, coords, out, b, h, w, nsamp, st);

extern "C" int warp_bilinear_vec(const void* src, const void* coords, void* out, int b, int h,
                                 int w, int c, int nsamp, int dtype, void* stream) {
  if (b == 0 || nsamp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (c) {
      WARP_VEC_CASE(__nv_bfloat16, 8)
      WARP_VEC_CASE(__nv_bfloat16, 16)
      WARP_VEC_CASE(__nv_bfloat16, 32)
      WARP_VEC_CASE(__nv_bfloat16, 64)
    }
  } else {
    switch (c) {
      WARP_VEC_CASE(float, 4)
      WARP_VEC_CASE(float, 8)
      WARP_VEC_CASE(float, 16)
      WARP_VEC_CASE(float, 32)
      WARP_VEC_CASE(float, 64)
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int warp_bilinear_scalar(const void* src, const void* coords, void* out, int b, int h,
                                    int w, int c, int nsamp, int dtype, void* stream) {
  if (b == 0 || nsamp == 0) return 0;
  const int threads = 256;
  const dim3 grid(blocks_for(nsamp, threads), b);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    warp_bilinear_scalar_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)src, (const float*)coords, (float*)out, h, w, c, nsamp);
  } else {
    warp_bilinear_scalar_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)src, (const float*)coords, (float*)out, h, w, c, nsamp);
  }
  return (int)cudaGetLastError();
}
