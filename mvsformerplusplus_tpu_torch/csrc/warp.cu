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
// The scalar variant takes any C that is not a multiple of the vector, or a
// source not on a 16-byte boundary; no full-width path reaches it. A block
// owns a tile of SCALAR_TILE consecutive samples, whose outputs are one
// contiguous, 16-byte aligned range of the freshly allocated output. Below
// NARROW_C channels (warp_bilinear_narrow_kernel, C a template parameter) a
// thread owns a sample: its 4C corner loads are all in flight at once, and
// lanes read neighbouring pixels' few channels, as close together as a
// channel-fastest sweep would; the outputs are staged in shared memory and
// leave as 16-byte stores. From NARROW_C channels on
// (warp_bilinear_scalar_kernel) a sample's channels span too many sectors
// for one thread: one thread per sample first works out the sample's four
// corners (element offsets, -1 outside) and weights into shared memory,
// once; then the block sweeps the tile's [samples x C] elements with the
// channel index fastest, four consecutive elements a thread (loading a
// sample's corners once per run of its channels), so that the lanes of a
// warp read neighbouring channels of one corner pixel (coalesced whatever C
// or the source's alignment), and each thread writes its four outputs as
// one 16-byte store.
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

// sum of the four corners' weight x element `q` of each inside corner
template <typename T>
__device__ __forceinline__ float gather(const T* q, int4 p, float4 k) {
  float acc = 0.f;
  if (p.x >= 0) acc += to_f32(__ldg(q + p.x)) * k.x;
  if (p.y >= 0) acc += to_f32(__ldg(q + p.y)) * k.y;
  if (p.z >= 0) acc += to_f32(__ldg(q + p.z)) * k.z;
  if (p.w >= 0) acc += to_f32(__ldg(q + p.w)) * k.w;
  return acc;
}

constexpr int NARROW_C = 16;  // the narrow kernel's channels are fewer

template <typename T, int C>
__global__ void __launch_bounds__(SCALAR_TILE, 8) warp_bilinear_narrow_kernel(
    const T* __restrict__ src, const float2* __restrict__ coords, float* __restrict__ out, int h,
    int w, int nsamp, int64_t total) {
  __shared__ __align__(16) float stage[SCALAR_TILE * C];
  const int64_t first = (int64_t)blockIdx.x * SCALAR_TILE;
  const int n = (int)min((int64_t)SCALAR_TILE, total - first);
  const int t = threadIdx.x;
  if (t < n) {
    const int64_t sample = first + t;
    const float2 xy = __ldg(coords + sample);
    const Corners k = bilinear_corners(xy.x, xy.y, h, w);
    const T* img = src + (sample / nsamp) * h * w * C;
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k.pix[q] >= 0) {
        const T* px = img + k.pix[q] * C;
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] += to_f32(__ldg(px + ch)) * k.wt[q];
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) stage[t * C + ch] = acc[ch];
  }
  __syncthreads();
  const unsigned elems = (unsigned)n * C;
  float* o = out + first * C;  // 16-byte aligned: SCALAR_TILE x C x 4 bytes a tile
  for (unsigned e = t * 4; e < elems; e += SCALAR_TILE * 4) {
    if (e + 4 <= elems) {
      __stcs(reinterpret_cast<float4*>(o + e), *reinterpret_cast<const float4*>(stage + e));
    } else {
      for (unsigned j = 0; e + j < elems; ++j) o[e + j] = stage[e + j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SCALAR_TILE) warp_bilinear_scalar_kernel(
    const T* __restrict__ src, const float2* __restrict__ coords, float* __restrict__ out, int h,
    int w, int c, int nsamp, int64_t total) {
  __shared__ int4 pix[SCALAR_TILE];
  __shared__ float4 wt[SCALAR_TILE];
  __shared__ const T* img[SCALAR_TILE];
  const int64_t first = (int64_t)blockIdx.x * SCALAR_TILE;
  const int n = load_tile_corners(coords, src, first, total, h, w, c, nsamp, pix, wt, img);
  const unsigned elems = (unsigned)n * c;
  float* o = out + first * c;  // 16-byte aligned: SCALAR_TILE x c x 4 bytes a tile
  for (unsigned e = threadIdx.x * 4; e < elems; e += SCALAR_TILE * 4) {
    unsigned s = e / c, ch = e - s * c;
    int4 p = pix[s];
    float4 k = wt[s];
    const T* im = img[s];
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = e + j < elems ? gather(im + ch, p, k) : 0.f;
      if (j < 3 && ++ch == (unsigned)c && e + j + 1 < elems) {  // the next sample's corners
        ch = 0, ++s;
        p = pix[s], k = wt[s], im = img[s];
      }
    }
    if (e + 4 <= elems) {
      __stcs(reinterpret_cast<float4*>(o + e), make_float4(v[0], v[1], v[2], v[3]));
    } else {
      for (unsigned j = 0; e + j < elems; ++j) o[e + j] = v[j];
    }
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

template <int C>
static int launch_narrow(const void* src, const void* coords, void* out, int h, int w, int nsamp,
                         int64_t total, int dtype, cudaStream_t st) {
  const unsigned grid = blocks_for(total, SCALAR_TILE);
  if (dtype == 1) {
    warp_bilinear_narrow_kernel<__nv_bfloat16, C><<<grid, SCALAR_TILE, 0, st>>>(
        (const __nv_bfloat16*)src, (const float2*)coords, (float*)out, h, w, nsamp, total);
  } else {
    warp_bilinear_narrow_kernel<float, C><<<grid, SCALAR_TILE, 0, st>>>(
        (const float*)src, (const float2*)coords, (float*)out, h, w, nsamp, total);
  }
  return (int)cudaGetLastError();
}

#define WARP_NARROW_CASE(C) \
  case C:                   \
    return launch_narrow<C>(src, coords, out, h, w, nsamp, total, dtype, st);

extern "C" int warp_bilinear_scalar(const void* src, const void* coords, void* out, int b, int h,
                                    int w, int c, int nsamp, int dtype, void* stream) {
  if (b == 0 || nsamp == 0) return 0;
  const int64_t total = (int64_t)b * nsamp;
  cudaStream_t st = (cudaStream_t)stream;
  static_assert(NARROW_C == 16, "one WARP_NARROW_CASE per channel count below NARROW_C");
  switch (c) {
    WARP_NARROW_CASE(1)
    WARP_NARROW_CASE(2)
    WARP_NARROW_CASE(3)
    WARP_NARROW_CASE(4)
    WARP_NARROW_CASE(5)
    WARP_NARROW_CASE(6)
    WARP_NARROW_CASE(7)
    WARP_NARROW_CASE(8)
    WARP_NARROW_CASE(9)
    WARP_NARROW_CASE(10)
    WARP_NARROW_CASE(11)
    WARP_NARROW_CASE(12)
    WARP_NARROW_CASE(13)
    WARP_NARROW_CASE(14)
    WARP_NARROW_CASE(15)
  }
  const unsigned grid = blocks_for(total, SCALAR_TILE);
  if (dtype == 1) {
    warp_bilinear_scalar_kernel<__nv_bfloat16><<<grid, SCALAR_TILE, 0, st>>>(
        (const __nv_bfloat16*)src, (const float2*)coords, (float*)out, h, w, c, nsamp, total);
  } else {
    warp_bilinear_scalar_kernel<float><<<grid, SCALAR_TILE, 0, st>>>(
        (const float*)src, (const float2*)coords, (float*)out, h, w, c, nsamp, total);
  }
  return (int)cudaGetLastError();
}
