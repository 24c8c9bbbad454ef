// The bilinear corners of one plane-sweep sample, shared by the warp
// (warp.cu) and its image gradient (warp_bwd.cu): grid_sample(bilinear,
// zeros, align_corners=True) in pixel units, corner order and weights as
// ops/cuda/warp.py bilinear_corners: (y0,x0) (y0,x1) (y1,x0) (y1,x1); and
// the per-tile corner table of both scalar kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

struct Corners {
  float wt[4];  // bilinear weight of each corner
  int pix[4];   // cy * W + cx of a corner inside the image, -1 outside
};

__device__ __forceinline__ Corners bilinear_corners(float x, float y, int h, int w) {
  Corners k;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float cy = y0 + dy;
    const float wy = dy ? fy : 1.f - fy;
    const bool yin = cy >= 0.f && cy <= (float)(h - 1);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float cx = x0 + dx;
      const float wx = dx ? fx : 1.f - fx;
      const int q = 2 * dy + dx;
      k.wt[q] = wy * wx;
      // the float tests come first, so a sample far outside converts nothing
      k.pix[q] = yin && cx >= 0.f && cx <= (float)(w - 1) ? (int)cy * w + (int)cx : -1;
    }
  }
  return k;
}

__device__ __forceinline__ bool any_inside(const Corners& k) {
  return (k.pix[0] & k.pix[1] & k.pix[2] & k.pix[3]) >= 0;
}

constexpr int SCALAR_TILE = 256;  // samples per block, one thread each

// The corners of the tile's samples, from one thread per sample: element
// offsets (pixel x C) into the sample's batch image, -1 outside, and the
// four bilinear weights. Returns the tile's sample count.
template <typename T>
__device__ __forceinline__ int load_tile_corners(const float2* __restrict__ coords, T* base,
                                                 int64_t first, int64_t total, int h, int w,
                                                 int c, int nsamp, int4* pix, float4* wt,
                                                 T** img) {
  const int n = (int)min((int64_t)SCALAR_TILE, total - first);
  const int t = threadIdx.x;
  if (t < n) {
    const int64_t sample = first + t;
    const float2 xy = __ldg(coords + sample);
    const Corners k = bilinear_corners(xy.x, xy.y, h, w);
    int o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = k.pix[q] >= 0 ? k.pix[q] * c : -1;
    pix[t] = make_int4(o[0], o[1], o[2], o[3]);
    wt[t] = make_float4(k.wt[0], k.wt[1], k.wt[2], k.wt[3]);
    img[t] = base + (sample / nsamp) * h * w * c;
  }
  __syncthreads();
  return n;
}
