// The bilinear corners of one plane-sweep sample, shared by the warp
// (warp.cu) and its image gradient (warp_bwd.cu): grid_sample(bilinear,
// zeros, align_corners=True) in pixel units, corner order and weights as
// ops/cuda/warp.py bilinear_corners: (y0,x0) (y0,x1) (y1,x0) (y1,x1).
#pragma once
#include <cuda_runtime.h>

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
