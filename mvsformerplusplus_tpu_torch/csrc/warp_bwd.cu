// Image gradient of the plane-sweep warp (warp.cu): the transpose of the
// bilinear sample. g [B, N, C] f32 cotangent of the warped samples, coords
// [B, N, 2] f32 pixel-unit (x, y) -> dsrc [B, H, W, C] f32, which the caller
// zero-initialises. Each sample scatters g x (bilinear weight) into the
// corners that lie inside the image; zero-padded corners get nothing. The
// coordinates get no gradient (the JAX warps stop it).
//
// Replaces mvsformerplusplus_tpu/ops/pallas/warp_band.py
// banded_warp_rows_bwd (narrow-row train stages) and banded_warp_blocked_bwd
// (wide rows): the TPU kernels build the transpose as one-hot band matmuls;
// here it is exact for every sample. Bound on the H100: the f32 cotangent
// read (4 bytes per output element of the forward) and the four reductions
// per element into dsrc. One thread per (sample, channel), channel fastest
// like the forward: the cotangent read is coalesced and the C threads of a
// sample reduce into contiguous channel runs of each corner pixel with
// fire-and-forget f32 atomics (RED), whose order varies from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void warp_bilinear_bwd_kernel(const float* __restrict__ g,
                                         const float* __restrict__ coords,
                                         float* __restrict__ dsrc, int h, int w, int c,
                                         int64_t nsamp, int64_t total) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float gv = g[i];
  if (gv == 0.f) return;
  int ch = (int)(i % c);
  int64_t s = i / c;  // flat (b, n) sample index
  int64_t b = s / nsamp;
  float x = coords[2 * s];
  float y = coords[2 * s + 1];
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  float* img = dsrc + b * (int64_t)h * w * c + ch;
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
        atomicAdd(img + off, gv * (wy * wx));
      }
    }
  }
}

extern "C" int warp_bilinear_bwd(const void* g, const void* coords, void* dsrc, int b, int h,
                                 int w, int c, int nsamp, void* stream) {
  int64_t total = (int64_t)b * nsamp * c;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  warp_bilinear_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)coords, (float*)dsrc, h, w, c, nsamp, total);
  return (int)cudaGetLastError();
}
